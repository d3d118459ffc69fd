"""Classifying VAE+LSTM: the functions generation needs.

Architecture (as ``classifying_vae_lstm_tpu/models/cl_vrnn.py``):

  key head   flatten(X) -> hW(relu, original_dim) -> Wargs(2*(K-1)) -> split
  encoder    LSTM over concat(X, W) -> Z_mean / Z_log_var per step
  decoder    LSTM over concat([Xp,] Z, W) -> sigmoid X_decoded_mean per step

``init``, the sequence forms, ``apply`` and the losses wait for the training
slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.core import dense
from ..ops.lstm import lstm_step


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX package's ``cl_vrnn.Config``, field for field, so a
    checkpoint's args load into an equal config. ``lstm_backend``, ``remat``,
    ``dropout``, ``fusion`` and ``two_cell`` are recorded training choices;
    generation on the card always runs the CUDA kernel."""

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


def encode_w(params, cfg: Config, x_window):
    """Window(s) [..., seq_length, D] -> (W_mean, W_log_var) [..., K-1]."""
    K1 = cfg.n_classes - 1
    flat = x_window.reshape(x_window.shape[:-2] + (cfg.seq_length * cfg.original_dim,))
    hW = dense(params["hW"], flat, torch.relu)
    Wargs = dense(params["Wargs"], hW)
    return Wargs[..., :K1], Wargs[..., K1:]


def encode_z_step(params, x_t, w, h, c):
    """Single-step z encoder: returns (Z_mean, Z_log_var, h, c)."""
    h, c = lstm_step(params["encoder_h"], torch.cat([x_t, w], dim=-1), h, c)
    return dense(params["Z_mean"], h), dense(params["Z_log_var"], h), h, c


def decode_step(params, cfg: Config, z_t, w, h, c, x_prev=None):
    """Single-step decoder: returns (sigmoid X_mean, h, c)."""
    xpz = torch.cat([x_prev, z_t], dim=-1) if cfg.use_x_prev else z_t
    h, c = lstm_step(params["decoder_h"], torch.cat([xpz, w], dim=-1), h, c)
    return dense(params["X_decoded_mean"], h, torch.sigmoid), h, c
