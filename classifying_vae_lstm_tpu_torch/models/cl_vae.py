"""Classifying VAE: a per-frame VAE with a Logistic-Normal key latent.

Architecture (as ``classifying_vae_lstm_tpu/models/cl_vae.py``, all dense):

  key encoder   x -> h_w(relu, class_dim_0) -> w_mean/w_log_var (K-1 each)
  w ~ LogisticNormal(w_mean, w_log_var)                   [K-simplex]
  latent encoder concat(x, w) -> [h(relu, latent_dim_0)] -> z_mean/z_log_var
  z ~ N(z_mean, exp(z_log_var))
  decoder  concat(w, [x_prev,] z) -> [decoder_h(relu)] -> sigmoid(x_mean)

The input-row orders are the JAX package's, so its checkpoints load as they
are: the latent encoder's kernel takes rows ``[0:D]`` for x and ``[D:]`` for
w; the decoder's rows ``[:K]`` for w, ``[K:K+D]`` for x_prev (with
``use_x_prev``), then z. ``intermediate_dim == 0`` skips the hidden layers.
A vanilla VAE is this model with ``n_classes == 1``: w is the constant [1.0]
and the w losses vanish.

:func:`apply` routes as the JAX package does: ``train_backend="pallas"``
runs the whole graph through the dense-stack kernels
(``ops/vae_dense.py``: hand-written CUDA on the card, its plain versions on
the CPU) wherever they accept the config; otherwise the model functions run
as plain PyTorch. Noise comes from a ``torch.Generator`` or, for parity with
the JAX package, from the batch (``eps_w``/``eps_z``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn import losses as L
from ..nn.core import dense, init_dense
from ..nn.distributions import logistic_normal_from_eps
from ..ops.vae_dense import should_use, vae_apply_core


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's ``cl_vae.Config``, field for field, so a
    checkpoint's args load into an equal config. ``train_backend`` picks the
    training path (``pallas``: the dense-stack CUDA kernels; ``xla`` and
    ``auto``: plain PyTorch); ``gen_backend`` is recorded only: generation on
    the card always runs its CUDA kernel."""

    original_dim: int = 88
    intermediate_dim: int = 88  # latent_dim_0; 0 = no hidden layers
    latent_dim: int = 2
    intermediate_class_dim: int = 88  # class_dim_0
    n_classes: int = 2  # K
    use_x_prev: bool = False
    w_log_var_prior: float = 0.0
    bf16_compute: bool = False  # bf16 matmul operands, f32 accumulation
    gen_backend: str = "xla"
    train_backend: str = "xla"

    @property
    def has_hidden(self) -> bool:
        return self.intermediate_dim > 0


def init(generator: torch.Generator, cfg: Config) -> dict:
    """Keras-default parameters (glorot kernels, zero biases) on the
    generator's device, with the JAX package's layer names."""
    g, K1 = generator, cfg.n_classes - 1
    params = {
        "h_w": init_dense(g, cfg.original_dim, cfg.intermediate_class_dim),
        "w_mean": init_dense(g, cfg.intermediate_class_dim, K1),
        "w_log_var": init_dense(g, cfg.intermediate_class_dim, K1),
    }
    enc_in = cfg.original_dim + cfg.n_classes
    head_in = cfg.intermediate_dim if cfg.has_hidden else enc_in
    if cfg.has_hidden:
        params["h"] = init_dense(g, enc_in, cfg.intermediate_dim)
    params["z_mean"] = init_dense(g, head_in, cfg.latent_dim)
    params["z_log_var"] = init_dense(g, head_in, cfg.latent_dim)
    dec_in = cfg.n_classes + cfg.latent_dim + (cfg.original_dim if cfg.use_x_prev else 0)
    if cfg.has_hidden:
        params["decoder_h"] = init_dense(g, dec_in, cfg.intermediate_dim)
    params["x_decoded_mean"] = init_dense(
        g, cfg.intermediate_dim if cfg.has_hidden else dec_in, cfg.original_dim)
    return params


def encode_w(params, x, dtype=None):
    """x [..., D] -> (w_mean, w_log_var) [..., K-1]; ``dtype`` applies to the
    hidden layer (the heads stay f32)."""
    h_w = dense(params["h_w"], x, torch.relu, dtype=dtype)
    return dense(params["w_mean"], h_w), dense(params["w_log_var"], h_w)


def encode_z(params, cfg: Config, x, w, dtype=None):
    """(x, w) -> (z_mean, z_log_var) [..., L]."""
    xw = torch.cat([x, w], dim=-1)
    h = dense(params["h"], xw, torch.relu, dtype=dtype) if cfg.has_hidden else xw
    return dense(params["z_mean"], h), dense(params["z_log_var"], h)


def decode(params, cfg: Config, w, z, x_prev=None, dtype=None):
    """(w, z[, x_prev]) -> sigmoid x_mean [..., D]."""
    xpz = torch.cat([x_prev, z], dim=-1) if cfg.use_x_prev else z
    wz = torch.cat([w, xpz], dim=-1)
    h = dense(params["decoder_h"], wz, torch.relu, dtype=dtype) if cfg.has_hidden else wz
    return dense(params["x_decoded_mean"], h, torch.sigmoid, dtype=dtype)


def draw_apply_noise(generator: torch.Generator, cfg: Config, batch_size: int) -> dict:
    """Pre-draw :func:`apply`'s Gaussian noise, in the order and shapes
    ``apply`` draws it itself (eps_w ``[B, K-1]``, then eps_z ``[B, L]``), on
    either route."""
    dev = generator.device
    return {
        "eps_w": torch.randn((batch_size, cfg.n_classes - 1), generator=generator, device=dev),
        "eps_z": torch.randn((batch_size, cfg.latent_dim), generator=generator, device=dev),
    }


def apply(params, cfg: Config, x, generator=None, x_prev=None, noise=None):
    """Full stochastic forward pass over a batch [B, D]; returns every named
    tensor of the graph.

    The dense-stack kernels when :func:`..ops.vae_dense.should_use` holds;
    otherwise the model functions, whose hidden layers and frame head take
    bf16 operands with f32 accumulation under ``cfg.bf16_compute`` (the heads
    stay f32). ``noise``: the pre-drawn dict of :func:`draw_apply_noise`;
    without it both routes draw the same noise from ``generator``.
    """
    if noise is None:
        noise = draw_apply_noise(generator, cfg, x.shape[0])
    eps_w, eps_z = noise["eps_w"].to(x.dtype), noise["eps_z"].to(x.dtype)
    if should_use(cfg):
        return vae_apply_core(params, cfg, x, x_prev, eps_w, eps_z)
    cd = torch.bfloat16 if cfg.bf16_compute else None
    w_mean, w_log_var = encode_w(params, x, dtype=cd)
    w = logistic_normal_from_eps(w_mean, w_log_var, eps_w)
    z_mean, z_log_var = encode_z(params, cfg, x, w, dtype=cd)
    z = z_mean + torch.exp(z_log_var / 2) * eps_z
    return {
        "x_decoded_mean": decode(params, cfg, w, z, x_prev, dtype=cd),
        "w": w,
        "w_mean": w_mean,
        "w_log_var": w_log_var,
        "z": z,
        "z_mean": z_mean,
        "z_log_var": z_log_var,
    }


def loss_and_metrics(params, cfg: Config, batch, generator=None, kl_weight=1.0,
                     class_weight=1.0, w_kl_weight=1.0):
    """Weighted ELBO with Keras reductions and the JAX package's metric
    names.

    ``batch`` holds ``x`` (encoder input), ``y`` (reconstruction target),
    ``w`` (one-hot key) and optionally ``x_prev``; each term is averaged over
    the batch before weighting. With ``n_classes == 1`` the w terms are 0 and
    ``w_acc`` is 1. A batch holding ``eps_w``/``eps_z`` fixes the noise.
    """
    noise = {"eps_w": batch["eps_w"], "eps_z": batch["eps_z"]} if "eps_w" in batch else None
    out = apply(params, cfg, batch["x"], generator, batch.get("x_prev"), noise=noise)
    vae = torch.mean(L.vae_loss(batch["y"], out["x_decoded_mean"], cfg.original_dim))
    kl = torch.mean(L.kl_loss(out["z_mean"], out["z_log_var"]))
    if cfg.n_classes > 1:
        w_kl = torch.mean(L.w_kl_loss(out["w_mean"], out["w_log_var"], cfg.w_log_var_prior))
        w_rec = torch.mean(L.w_rec_loss(batch["w"], out["w"], cfg.n_classes))
        w_acc = torch.mean((torch.argmax(out["w"], -1) == torch.argmax(batch["w"], -1))
                           .to(torch.float32))
    else:
        zero = vae.new_zeros(())
        w_kl, w_rec, w_acc = zero, zero, zero + 1.0
    total = vae + w_kl_weight * w_kl + class_weight * w_rec + kl_weight * kl
    return total, {
        "loss": total,
        "x_decoded_mean_loss": vae,
        "w_loss": w_kl,
        "w2_loss": w_rec,
        "z_args_loss": kl,
        "w_acc": w_acc,
    }
