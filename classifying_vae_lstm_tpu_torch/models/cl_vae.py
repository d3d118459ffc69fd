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
A vanilla VAE is this model with ``n_classes == 1``: w is the constant [1.0].

This module holds what generation needs. The training forward (``apply``),
its noise and its losses come with the cl_vae training slice (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.core import dense, init_dense


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's ``cl_vae.Config``, field for field, so a
    checkpoint's args load into an equal config. ``gen_backend`` and
    ``train_backend`` are recorded only: generation on the card always runs
    its CUDA kernel."""

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


def encode_w(params, x):
    """x [..., D] -> (w_mean, w_log_var) [..., K-1]."""
    h_w = dense(params["h_w"], x, torch.relu)
    return dense(params["w_mean"], h_w), dense(params["w_log_var"], h_w)


def encode_z(params, cfg: Config, x, w):
    """(x, w) -> (z_mean, z_log_var) [..., L]."""
    xw = torch.cat([x, w], dim=-1)
    h = dense(params["h"], xw, torch.relu) if cfg.has_hidden else xw
    return dense(params["z_mean"], h), dense(params["z_log_var"], h)


def decode(params, cfg: Config, w, z, x_prev=None):
    """(w, z[, x_prev]) -> sigmoid x_mean [..., D]."""
    xpz = torch.cat([x_prev, z], dim=-1) if cfg.use_x_prev else z
    wz = torch.cat([w, xpz], dim=-1)
    h = dense(params["decoder_h"], wz, torch.relu) if cfg.has_hidden else wz
    return dense(params["x_decoded_mean"], h, torch.sigmoid)
