"""Classifying VAE+LSTM (STORN-style sequence model).

Architecture (as ``classifying_vae_lstm_tpu/models/cl_vrnn.py``):

  key head   flatten(X) -> hW(relu, original_dim) -> Wargs(2*(K-1)) -> split
  W ~ LogisticNormal(W_mean, W_log_var)                       [K-simplex]
  encoder    LSTM over concat(X, W) -> Z_mean / Z_log_var per step
  Z_t ~ N(Z_mean_t, exp(Z_log_var_t))
  decoder    LSTM over concat([Xp,] Z, W) -> sigmoid X_decoded_mean per step

:func:`apply` routes as the JAX package does: the ``xla`` backend runs the
fused single loop (:func:`_apply_fused`, plain PyTorch), the ``pallas``
backend the two-cell kernel (:func:`_apply_two_cell`, ``ops/two_cell.py``:
hand-written CUDA on the card, its plain version on the CPU), and dropout,
remat or ``two_cell=False`` the two-loop path, whose two LSTMs on
``pallas`` run the whole-sequence kernels (``ops/lstm_seq.py``). Noise comes
from a ``torch.Generator`` or, for parity with the JAX package, from the
batch (``eps_w``/``eps_z``).

Column-sharded parameters (``parallel.columns``, tensor parallelism) run
every plain product column-parallel; the kernels take the weights they read
gathered on the data's device, once a step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn import losses as L
from ..nn.core import dense, hard_sigmoid, init_dense, init_lstm, random_normal_init
from ..nn.distributions import logistic_normal_from_eps
from ..ops.lstm import _gates, bf16_operand, lstm_sequence, lstm_step
from ..parallel.columns import gather_tree, matmul


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's ``cl_vrnn.Config``, field for field, so a
    checkpoint's args load into an equal config. ``lstm_backend`` picks the
    training path (``xla``: plain PyTorch; ``pallas``: the two-cell CUDA
    kernels, or with ``two_cell=False`` the whole-sequence LSTM kernels);
    generation on the card always runs its own CUDA kernel."""

    original_dim: int = 88
    intermediate_dim: int = 88
    latent_dim: int = 2
    seq_length: int = 16
    n_classes: int = 2
    use_x_prev: bool = False
    w_log_var_prior: float = 0.0
    dropout: float = 0.0
    lstm_backend: str = "xla"
    remat: bool = False
    bf16_compute: bool = False  # bf16 matmul operands, f32 accumulation
    fusion: tuple | None = None
    two_cell: bool | None = None


def init(generator: torch.Generator, cfg: Config) -> dict:
    """Keras-default parameters on the generator's device: glorot kernels,
    orthogonal recurrent kernels, unit forget bias, RandomNormal(0, 0.1)
    heads."""
    K1 = cfg.n_classes - 1
    head_init = random_normal_init(0.1)
    enc_in = cfg.original_dim + cfg.n_classes
    dec_in = cfg.latent_dim + cfg.n_classes + (cfg.original_dim if cfg.use_x_prev else 0)
    g = generator
    return {
        "hW": init_dense(g, cfg.seq_length * cfg.original_dim, cfg.original_dim),
        "Wargs": init_dense(g, cfg.original_dim, 2 * K1),
        "encoder_h": init_lstm(g, enc_in, cfg.intermediate_dim),
        "Z_mean": init_dense(g, cfg.intermediate_dim, cfg.latent_dim, head_init),
        "Z_log_var": init_dense(g, cfg.intermediate_dim, cfg.latent_dim, head_init),
        "decoder_h": init_lstm(g, dec_in, cfg.intermediate_dim),
        "X_decoded_mean": init_dense(g, cfg.intermediate_dim, cfg.original_dim, head_init),
    }


def encode_w(params, cfg: Config, x_window):
    """Window(s) [..., seq_length, D] -> (W_mean, W_log_var) [..., K-1]."""
    K1 = cfg.n_classes - 1
    flat = x_window.reshape(x_window.shape[:-2] + (cfg.seq_length * cfg.original_dim,))
    hW = dense(params["hW"], flat, torch.relu)
    Wargs = dense(params["Wargs"], hW)
    return Wargs[..., :K1], Wargs[..., K1:]


def _repeat_w(w, seq_length):
    """[B, K] -> [B, T, K] (the reference's RepeatVector)."""
    return w[:, None, :].expand(w.shape[0], seq_length, w.shape[-1])


def _compute_dtype(cfg):
    return torch.bfloat16 if cfg.bf16_compute else None


def encode_z_sequence(params, cfg: Config, x, w, h0=None, c0=None, dropout_generator=None):
    """(X, W) -> per-step (Z_mean, Z_log_var) + final LSTM state."""
    xw = torch.cat([x, _repeat_w(w, x.shape[1])], dim=-1)
    h_seq, state = lstm_sequence(
        params["encoder_h"], xw, h0, c0, backend=cfg.lstm_backend, remat=cfg.remat,
        compute_dtype=_compute_dtype(cfg), dropout=cfg.dropout,
        dropout_generator=dropout_generator,
        fusion=cfg.fusion if cfg.lstm_backend == "pallas" else None)
    return dense(params["Z_mean"], h_seq), dense(params["Z_log_var"], h_seq), state


def decode_sequence(params, cfg: Config, z, w, x_prev=None, h0=None, c0=None,
                    dropout_generator=None):
    """(Z, W[, Xp]) -> per-step sigmoid X_mean + final LSTM state."""
    xpz = torch.cat([x_prev, z], dim=-1) if cfg.use_x_prev else z
    xpz = torch.cat([xpz, _repeat_w(w, z.shape[1])], dim=-1)
    h_seq, state = lstm_sequence(
        params["decoder_h"], xpz, h0, c0, backend=cfg.lstm_backend, remat=cfg.remat,
        compute_dtype=_compute_dtype(cfg), dropout=cfg.dropout,
        dropout_generator=dropout_generator,
        fusion=cfg.fusion if cfg.lstm_backend == "pallas" else None)
    return dense(params["X_decoded_mean"], h_seq, torch.sigmoid), state


def encode_z_step(params, x_t, w, h, c):
    """Single-step z encoder: returns (Z_mean, Z_log_var, h, c)."""
    h, c = lstm_step(params["encoder_h"], torch.cat([x_t, w], dim=-1), h, c)
    return dense(params["Z_mean"], h), dense(params["Z_log_var"], h), h, c


def decode_step(params, cfg: Config, z_t, w, h, c, x_prev=None):
    """Single-step decoder: returns (sigmoid X_mean, h, c)."""
    xpz = torch.cat([x_prev, z_t], dim=-1) if cfg.use_x_prev else z_t
    h, c = lstm_step(params["decoder_h"], torch.cat([xpz, w], dim=-1), h, c)
    return dense(params["X_decoded_mean"], h, torch.sigmoid), h, c


def draw_apply_noise(generator: torch.Generator, cfg: Config, batch_size: int) -> dict:
    """Pre-draw :func:`apply`'s Gaussian noise, in the order and shapes
    ``apply`` draws it itself (eps_w ``[B, K-1]``, then eps_z ``[B, T, L]``),
    so ``apply(p, cfg, x, g)`` equals ``apply(..., noise=draw_apply_noise(g',
    cfg, B))`` for a generator ``g'`` in the same state as ``g``."""
    dev = generator.device
    return {
        "eps_w": torch.randn((batch_size, cfg.n_classes - 1), generator=generator, device=dev),
        "eps_z": torch.randn((batch_size, cfg.seq_length, cfg.latent_dim), generator=generator,
                             device=dev),
    }


def _w_and_eps(params, cfg, x, generator, noise):
    """(W_mean, W_log_var, W, eps_z): the key latent and the z noise, drawn
    from ``generator`` or taken from ``noise``."""
    W_mean, W_log_var = encode_w(params, cfg, x)
    if noise is None:
        noise = draw_apply_noise(generator, cfg, x.shape[0])
    W = logistic_normal_from_eps(W_mean, W_log_var, noise["eps_w"].to(W_mean.dtype))
    return W_mean, W_log_var, W, noise["eps_z"].to(W_mean.dtype)


def _apply_fused(params, cfg: Config, x, generator, x_prev=None, noise=None):
    """Encoder cell, z head, z sample and decoder cell in ONE loop over time.

    The decoder at step t needs only the encoder output at step t, so one
    loop carries both states. The input projections (encoder XW, decoder Xp
    and W parts) are whole-sequence products; only z's share of the decoder
    projection is per step. Plain PyTorch, as the JAX package computes this
    path outside any Pallas kernel.
    """
    B, T, D = x.shape
    H, Ld = cfg.intermediate_dim, cfg.latent_dim
    op = bf16_operand if cfg.bf16_compute else (lambda a: a)
    mm = lambda a, b: matmul(op(a), op(b))
    W_mean, W_log_var, W, eps = _w_and_eps(params, cfg, x, generator, noise)
    xw = torch.cat([x, _repeat_w(W, T)], dim=-1)
    enc, dec = params["encoder_h"], params["decoder_h"]
    xz_enc = mm(xw, enc["kernel"]) + enc["bias"]
    n_xp = D if cfg.use_x_prev else 0
    k_xp = dec["kernel"][:n_xp]
    k_z = dec["kernel"][n_xp : n_xp + Ld]
    k_w = dec["kernel"][n_xp + Ld :]
    xz_dec = mm(_repeat_w(W, T), k_w) + dec["bias"]
    if cfg.use_x_prev:
        xz_dec = xz_dec + mm(x_prev, k_xp)
    h_e = c_e = h_d = c_d = x.new_zeros((B, H))
    hd_seq, zm_seq, zv_seq, z_seq = [], [], [], []
    for t in range(T):
        z_e = xz_enc[:, t] + mm(h_e, enc["recurrent_kernel"])
        h_e, c_e = _gates(z_e, c_e, H, hard_sigmoid, torch.tanh)
        zm = dense(params["Z_mean"], h_e)
        zv = dense(params["Z_log_var"], h_e)
        z = zm + torch.exp(zv / 2) * eps[:, t]
        z_d = xz_dec[:, t] + mm(z, k_z) + mm(h_d, dec["recurrent_kernel"])
        h_d, c_d = _gates(z_d, c_d, H, hard_sigmoid, torch.tanh)
        hd_seq.append(h_d)
        zm_seq.append(zm)
        zv_seq.append(zv)
        z_seq.append(z)
    stack = lambda s: torch.stack(s, dim=1)
    return {
        "X_decoded_mean": dense(params["X_decoded_mean"], stack(hd_seq), torch.sigmoid),
        "W": W, "W_mean": W_mean, "W_log_var": W_log_var,
        "Z": stack(z_seq), "Z_mean": stack(zm_seq), "Z_log_var": stack(zv_seq),
    }


def _apply_two_cell(params, cfg: Config, x, generator, x_prev=None, noise=None):
    """The whole recurrent core (encoder LSTM, z heads, z sample, decoder
    LSTM) through :func:`..ops.two_cell.two_cell_sequence`; noise semantics
    as the other paths."""
    from ..ops.two_cell import two_cell_sequence

    W_mean, W_log_var, W, eps = _w_and_eps(params, cfg, x, generator, noise)
    core = gather_tree({k: params[k] for k in ("encoder_h", "decoder_h", "Z_mean",
                                               "Z_log_var")}, x.device)
    hd, zm, zlv, z = two_cell_sequence(core, cfg, x, x_prev, W, eps,
                                       compute_dtype=_compute_dtype(cfg))
    return {
        "X_decoded_mean": dense(params["X_decoded_mean"], hd, torch.sigmoid),
        "W": W, "W_mean": W_mean, "W_log_var": W_log_var,
        "Z": z, "Z_mean": zm, "Z_log_var": zlv,
    }


def apply(params, cfg: Config, x, generator=None, x_prev=None, noise=None):
    """Full stochastic forward pass over a window batch [B, T, D].

    The fused single loop when there is no dropout and the backend is
    ``xla``; the two-cell kernel when the backend is ``pallas`` and
    :func:`..ops.two_cell.should_use` holds; otherwise the two-loop path
    (encoder sequence, z sample, decoder sequence), whose ``pallas`` backend
    runs each LSTM through :func:`..ops.lstm_seq.lstm_sequence_kernel`.
    ``noise``: the pre-drawn dict of :func:`draw_apply_noise`; without it the
    noise is drawn from ``generator``.
    """
    if cfg.dropout == 0.0 and cfg.lstm_backend == "xla" and not cfg.remat:
        return _apply_fused(params, cfg, x, generator, x_prev, noise)
    if cfg.dropout == 0.0 and cfg.lstm_backend == "pallas" and not cfg.remat:
        from ..ops.two_cell import should_use

        if should_use(cfg):
            return _apply_two_cell(params, cfg, x, generator, x_prev, noise)
    if noise is not None and cfg.dropout != 0.0:
        raise ValueError("noise-explicit apply does not cover dropout masks")
    W_mean, W_log_var, W, eps = _w_and_eps(params, cfg, x, generator, noise)
    Z_mean, Z_log_var, _ = encode_z_sequence(params, cfg, x, W, dropout_generator=generator)
    Z = Z_mean + torch.exp(Z_log_var / 2) * eps
    X_decoded_mean, _ = decode_sequence(params, cfg, Z, W, x_prev, dropout_generator=generator)
    return {
        "X_decoded_mean": X_decoded_mean,
        "W": W, "W_mean": W_mean, "W_log_var": W_log_var,
        "Z": Z, "Z_mean": Z_mean, "Z_log_var": Z_log_var,
    }


def loss_and_metrics(params, cfg: Config, batch, generator=None, kl_weight=1.0,
                     class_weight=1.0, w_kl_weight=1.0):
    """Weighted sequence ELBO with Keras reductions.

    ``vae`` and ``kl`` are per (batch, timestep) and averaged over both axes;
    the w terms are per window. Targets: ``y`` [B, T, D], the per-step next
    frames. A batch holding ``eps_w``/``eps_z`` fixes the noise.
    """
    noise = {"eps_w": batch["eps_w"], "eps_z": batch["eps_z"]} if "eps_w" in batch else None
    out = apply(params, cfg, batch["x"], generator, batch.get("x_prev"), noise=noise)
    vae = torch.mean(L.vae_loss(batch["y"], out["X_decoded_mean"], cfg.original_dim))
    kl = torch.mean(L.kl_loss(out["Z_mean"], out["Z_log_var"]))
    if cfg.n_classes > 1:
        w_kl = torch.mean(L.w_kl_loss(out["W_mean"], out["W_log_var"], cfg.w_log_var_prior))
        w_rec = torch.mean(L.w_rec_loss(batch["w"], out["W"], cfg.n_classes))
        w_acc = torch.mean((torch.argmax(out["W"], -1) == torch.argmax(batch["w"], -1))
                           .to(torch.float32))
    else:
        zero = vae.new_zeros(())
        w_kl, w_rec, w_acc = zero, zero, zero + 1.0
    total = vae + w_kl_weight * w_kl + class_weight * w_rec + kl_weight * kl
    return total, {
        "loss": total,
        "X_decoded_mean_loss": vae,
        "W_loss": w_kl,
        "W2_loss": w_rec,
        "Z_args_loss": kl,
        "w_acc": w_acc,
    }
