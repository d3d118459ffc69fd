"""The Keras-2.0 LSTM as plain tensor code.

Gate order (i, f, c, o), ``tanh`` activation, hard-sigmoid recurrent
activation. :func:`lstm_step` is the plain twin of the cells inside the CUDA
kernels; :func:`lstm_sequence` runs a whole sequence: its ``xla`` backend in
plain PyTorch with the input projection hoisted into one product, its
``pallas`` backend through the whole-sequence CUDA kernels of
``ops/lstm_seq.py`` (their plain versions for CPU tensors).
"""

from __future__ import annotations

import torch

from ..nn.core import hard_sigmoid
from ..parallel.columns import ColumnShards, gather_tree, matmul, matmul_sum

def _gates(z, c_prev, hidden_dim, recurrent_activation=hard_sigmoid, activation=torch.tanh):
    H = hidden_dim
    i = recurrent_activation(z[..., :H])
    f = recurrent_activation(z[..., H : 2 * H])
    g = activation(z[..., 2 * H : 3 * H])
    o = recurrent_activation(z[..., 3 * H :])
    c = f * c_prev + i * g
    return o * activation(c), c


def _gate_grads(z, c, c_prev, dh, dc_in):
    """BPTT through the Keras-2.0 gates (``pallas_lstm._bwd_gate_grads``):
    returns the pre-activation cotangent dz and the next carry dc * f. The
    hard-sigmoid derivative is 0.2 strictly inside (0, 1), 0 at the clip
    points (torch's autograd of ``clamp`` passes them)."""
    H = c.shape[-1]
    hs = lambda v: torch.clamp(0.2 * v + 0.5, 0.0, 1.0)
    i, f, o = hs(z[:, :H]), hs(z[:, H:2 * H]), hs(z[:, 3 * H:])
    g = torch.tanh(z[:, 2 * H:3 * H])
    tanh_c = torch.tanh(c)
    hsd = lambda gate: torch.where((gate > 0.0) & (gate < 1.0), 0.2, 0.0)
    dc = dc_in + dh * o * (1 - tanh_c ** 2)
    dz = torch.cat([dc * g * hsd(i), dc * c_prev * hsd(f), dc * i * (1 - g ** 2),
                    dh * tanh_c * hsd(o)], dim=-1)
    return dz, dc * f


def lstm_step(params, x, h_prev, c_prev, recurrent_activation=hard_sigmoid,
              activation=torch.tanh):
    """One LSTM cell step: x [B, in], h/c [B, H] -> (h, c). Column-sharded
    kernels (``parallel.columns``) give each slice's gates on its device,
    gathered into z before the bias."""
    z = matmul_sum([(x, params["kernel"]), (h_prev, params["recurrent_kernel"])]) \
        + params["bias"]
    return _gates(z, c_prev, h_prev.shape[-1], recurrent_activation, activation)


def bf16_operand(a):
    """A matmul operand rounded to bf16 and held in f32, so that the product
    accumulates in f32 (the JAX ``preferred_element_type=f32`` bf16 mode; a
    CPU bf16 matmul would round its output to bf16)."""
    return a.to(torch.bfloat16).to(torch.float32)


def resolve_fusion(fusion, hidden_dim: int | None = None) -> tuple[bool, bool, bool]:
    """The (proj, drk, full) kernel-fusion triple of the JAX package's
    ``pallas_lstm.resolve_fusion`` with its policy defaults (all on), dropped
    to proj-only above the drk accumulator's ceiling (16·H² bytes > 38 MiB).
    The port records it in args.json so that a checkpoint names the same
    triple in both packages, and :func:`.lstm_seq.lstm_sequence_kernel` runs
    the rung it names."""
    proj, drk, full = (True, True, True) if fusion is None else (bool(f) for f in fusion)
    if hidden_dim is not None and hidden_dim * 4 * hidden_dim * 4 > 38 * 2**20:
        drk = full = False
    full = full and proj
    return proj, drk or full, full


def keras_lstm_dropout_masks(generator: torch.Generator, rate: float, batch: int, in_dim: int,
                             dtype=torch.float32):
    """Keras 2.0 LSTM ``dropout`` masks: four independent input masks (one
    per gate i/f/c/o), each [B, in], constant over time, inverted-scaled by
    1/(1-rate). Returns [4, B, in]."""
    keep = torch.rand((4, batch, in_dim), generator=generator,
                      device=generator.device) < (1.0 - rate)
    return keep.to(dtype) / (1.0 - rate)


def lstm_sequence(params, x, h0=None, c0=None, recurrent_activation=hard_sigmoid,
                  activation=torch.tanh, backend: str = "xla", remat: bool = False,
                  compute_dtype=None, dropout: float = 0.0, dropout_generator=None,
                  fusion=None):
    """Run an LSTM over a full sequence. x: [B, T, in] -> h_seq [B, T, H].

    Returns ``(h_seq, (h_T, c_T))``. The input projection of all timesteps is
    one product; a Python loop carries (h, c). ``compute_dtype=torch.bfloat16``
    rounds the matmul operands to bf16 and accumulates in f32.
    ``dropout``/``dropout_generator`` apply the Keras-2.0 per-gate input masks
    (:func:`keras_lstm_dropout_masks`). ``remat`` changes memory, not values,
    in the JAX package; eager PyTorch keeps every step's activations either
    way, so the flag is accepted and has no effect on ``xla``.
    ``backend="pallas"`` runs :func:`.lstm_seq.lstm_sequence_kernel`; as in
    the JAX package it refuses dropout masks and ``remat`` (``ValueError``).
    Column-sharded kernels (``parallel.columns``) reach the kernels gathered
    on x's device, once a call; on ``xla`` every product is column-parallel.
    """
    B, T, _ = x.shape
    H = params["recurrent_kernel"].shape[0]
    if h0 is None:
        h0 = x.new_zeros((B, H))
    if c0 is None:
        c0 = x.new_zeros((B, H))
    if backend == "pallas":
        if dropout > 0 and dropout_generator is not None:
            raise ValueError("dropout is not supported on the pallas backend")
        if remat:
            # the kernels' residuals (z/h/c streams) are their memory plan
            raise ValueError("remat is not supported on the pallas backend")
        from .lstm_seq import lstm_sequence_kernel

        return lstm_sequence_kernel(gather_tree(params, x.device), x, h0, c0,
                                    compute_dtype=compute_dtype, fusion=fusion)
    if backend != "xla":
        raise ValueError(f"unknown LSTM backend {backend!r} (xla or pallas)")
    if fusion is not None:
        raise ValueError(f"fusion is a pallas-backend knob; backend is {backend!r}")
    op = bf16_operand if compute_dtype == torch.bfloat16 else (lambda a: a)
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} (None, float32 or bfloat16)")
    kernel = op(params["kernel"])
    xo = op(x)
    if dropout > 0 and dropout_generator is not None:
        masks = keras_lstm_dropout_masks(dropout_generator, dropout, B, x.shape[-1], x.dtype)
        cols = kernel.columns if isinstance(kernel, ColumnShards) else (
            lambda lo, hi: kernel[:, lo:hi])
        xz = torch.cat([matmul(op(x * masks[g][:, None, :]), cols(g * H, (g + 1) * H))
                        for g in range(4)], dim=-1) + params["bias"]
    else:
        xz = matmul(xo, kernel) + params["bias"]
    rk = op(params["recurrent_kernel"])
    h, c = h0, c0
    hs = []
    for t in range(T):
        z = xz[:, t] + matmul(op(h), rk)
        h, c = _gates(z, c, H, recurrent_activation, activation)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)
