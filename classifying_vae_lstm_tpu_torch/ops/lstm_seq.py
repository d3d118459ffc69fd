"""Whole-sequence LSTM: CUDA wrappers, plain versions and the autograd
function.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_lstm.py`` at its default
fusion rung (proj, drk, full) = (T, T, T), the one ``lstm_sequence_pallas``
takes at every width up to the drk ceiling. Three kernels of
``csrc/lstm_seq.cu``:

* the inference forward (``_forward_kernel_call_fp``): x ``[T, B, IN]``, W,
  b, Rk, h0, c0 -> h, c ``[T, B, H]``, the projection ``x @ W + b`` computed
  in the kernel;
* the training forward (``_forward_train_call_fp``): the same, plus the
  backward's residuals z ``[T, B, 4H]``, h_prev and c_prev;
* the backward (``_backward_call_full``): a serial reverse walk, then a
  deterministic weight-gradient pass (two launches), -> dx, dh0, dc0, dRk,
  dW, db.

Each has a plain PyTorch version with the same signature and results,
written step by step as the Pallas bodies compute: :func:`lstm_seq_fwd_plain`,
:func:`lstm_seq_train_fwd_plain` and :func:`lstm_seq_bwd_plain` (which
mirrors the TPU backward kernel; it is not autograd of the plain forward).
The wrappers :func:`lstm_seq_fwd`, :func:`lstm_seq_train_fwd` and
:func:`lstm_seq_bwd` launch the kernels for CUDA tensors (or raise: there is
no fallback) and take the plain versions only for CPU tensors.

:func:`lstm_sequence_kernel` is the entry, with ``lstm_sequence_pallas``'s
signature and results. Layouts are time-major inside, kernels ``[in, out]``,
and no lane or batch padding: the TPU's VMEM gates and block picks are not
read here; the card's shared memory is the only limit, checked per call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .lstm import _gate_grads, _gates, resolve_fusion

# launches since the counts were last set to 0: one per inference or training
# forward call, two per backward call (the reverse walk, then the
# weight-gradient pass)
FWD_LAUNCHES = 0
TRAIN_FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

_BWD_ROWS = 4             # kBwdRows in csrc/lstm_seq.cu
_BWD_UNITS = 256          # kUnits in csrc/lstm_seq.cu
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
DEFAULT_FUSION = (True, True, True)
FUSION_TODO = ("only the default fusion triple (proj, drk, full) = (True, True, True) of the "
               "whole-sequence LSTM kernels is ported; the other rungs are ROADMAP Queue 2 "
               "item 6")
BF16_TODO = ("the bf16 stream mode of the whole-sequence LSTM kernels is not ported yet "
             "(ROADMAP Queue 2 item 6)")


def fwd_smem_bytes(IN: int, H: int, rows: int) -> int:
    """Shared memory of one forward block: the step's x, h (two buffers) and
    c for each row of the tile."""
    return (IN + 3 * H) * rows * 4


def bwd_smem_bytes(H: int) -> int:
    """Shared memory of one reverse-walk block: dz (4H) and the two carries
    (H each) per row, plus the K-split partial sums."""
    return (6 * H * _BWD_ROWS + _BWD_ROWS * _BWD_UNITS) * 4


def fwd_rows(B: int, IN: int, H: int, n_sm: int) -> int:
    """The forward's row tile: 16 rows when the batch gives every SM a
    16-row block and the tile fits shared memory (each weight load then
    serves 16 rows), else 4."""
    return 16 if B >= 16 * n_sm and fwd_smem_bytes(IN, H, 16) <= _SMEM_LIMIT else 4


# ------------------------------------------------------------ plain versions


def _fwd_steps(x, w, b, rk, h0, c0):
    # the body of both plain forwards, kept apart so that each public name
    # is called only by its own wrapper (tests and chip_smoke.py spy on them)
    T, B, IN = x.shape
    H = rk.shape[0]
    xz = (x.reshape(T * B, IN) @ w + b).reshape(T, B, 4 * H)
    h, c = h0, c0
    outs = [[] for _ in range(5)]
    for t in range(T):
        z = xz[t] + h @ rk
        hp, cp = h, c
        h, c = _gates(z, c, H)
        for acc, v in zip(outs, (h, c, z, hp, cp)):
            acc.append(v)
    return tuple(torch.stack(o) for o in outs)


def lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0):
    """The training forward's function in torch ops.

    x ``[T, B, IN]``, w ``[IN, 4H]``, b ``[4H]``, rk ``[H, 4H]``, h0/c0
    ``[B, H]``. Returns ``(h, c, z, h_prev, c_prev)``, all ``[T, B, ...]``.
    As the Pallas body: ``xz = x @ W + b`` for the whole block first, then
    per step ``z = xz + h @ Rk`` and the gates."""
    return _fwd_steps(x, w, b, rk, h0, c0)


def lstm_seq_fwd_plain(x, w, b, rk, h0, c0):
    """The inference forward's function in torch ops: the ``(h, c)`` of
    :func:`lstm_seq_train_fwd_plain`."""
    return _fwd_steps(x, w, b, rk, h0, c0)[:2]


def lstm_seq_bwd_plain(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t):
    """The backward kernel's function in torch ops, step by step
    (``_lstm_bwd_kernel_full``).

    Walks time in reverse with the dh/dc carries; per step the gate
    gradients, ``dh = dz @ Rkᵀ`` (the serial chain), ``dx[t] = dz @ Wᵀ`` and
    the weight-gradient sums. rk_t ``[4H, H]`` and w_t ``[4H, IN]`` are the
    transposed weights, as in ``_backward_call_full``. Returns ``(dx, dh0,
    dc0, drk [H, 4H], dw [IN, 4H], db [4H])``."""
    T, B, H4 = z.shape
    zeros = lambda *s: z.new_zeros(s)
    dh, dc = zeros(B, H4 // 4), zeros(B, H4 // 4)
    drk, dw, db = zeros(*rk_t.T.shape), zeros(*w_t.T.shape), zeros(H4)
    dx = [None] * T
    for t in reversed(range(T)):
        dz, dc = _gate_grads(z[t], c[t], c_prev[t], dh + dh_seq[t], dc + dc_seq[t])
        dh = dz @ rk_t
        dx[t] = dz @ w_t
        drk += h_prev[t].T @ dz
        dw += x[t].T @ dz
        db += dz.sum(0)
    return torch.stack(dx), dh, dc, drk, dw, db


# ------------------------------------------------------------ CUDA wrappers

_lib_lock = threading.Lock()
_lib = None


def _kernels():
    """The built library with its ctypes signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("lstm_seq")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cvl_lstm_seq_fwd_smem_bytes.argtypes = [I] * 3
            lib.cvl_lstm_seq_fwd_smem_bytes.restype = LL
            lib.cvl_lstm_seq_bwd_smem_bytes.argtypes = [I]
            lib.cvl_lstm_seq_bwd_smem_bytes.restype = LL
            if (any(lib.cvl_lstm_seq_fwd_smem_bytes(109, 256, r) != fwd_smem_bytes(109, 256, r)
                    for r in (4, 16))
                    or lib.cvl_lstm_seq_bwd_smem_bytes(256) != bwd_smem_bytes(256)):
                raise RuntimeError("shared-memory layout of csrc/lstm_seq.cu differs from "
                                   "fwd_smem_bytes / bwd_smem_bytes")
            lib.cvl_lstm_seq_fwd.argtypes = [P] * 11 + [I] * 6 + [P]
            lib.cvl_lstm_seq_bwd.argtypes = [P] * 10 + [I] * 4 + [P]
            lib.cvl_lstm_seq_wgrad.argtypes = [P] * 6 + [I] * 3 + [P]
            for fn in (lib.cvl_lstm_seq_fwd, lib.cvl_lstm_seq_bwd, lib.cvl_lstm_seq_wgrad):
                fn.restype = I
            _lib = lib
        return _lib


def _check(dev, named_shapes: dict):
    """Raise on anything the kernels do not take."""
    for name, (t, shape) in named_shapes.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _count(which: str, n: int):
    global FWD_LAUNCHES, TRAIN_FWD_LAUNCHES, BWD_LAUNCHES
    with _launch_lock:
        if which == "fwd":
            FWD_LAUNCHES += n
        elif which == "train_fwd":
            TRAIN_FWD_LAUNCHES += n
        else:
            BWD_LAUNCHES += n


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _launch_fwd(x, w, b, rk, h0, c0, train: bool):
    dev = x.device
    if x.dim() != 3 or rk.dim() != 2:
        raise ValueError("x must be [T, B, IN] and rk [H, 4H]")
    T, B, IN = x.shape
    H = rk.shape[0]
    if T < 1 or B < 1:
        raise ValueError(f"need T, B >= 1 (got {T}, {B})")
    H4 = 4 * H
    _check(dev, {"x": (x, (T, B, IN)), "w": (w, (IN, H4)), "b": (b, (H4,)), "rk": (rk, (H, H4)),
                 "h0": (h0, (B, H)), "c0": (c0, (B, H))})
    rows = fwd_rows(B, IN, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    if fwd_smem_bytes(IN, H, rows) > _SMEM_LIMIT:
        raise ValueError(f"input width {IN} + hidden {H} is too wide for the LSTM forward "
                         f"kernel's shared memory ({fwd_smem_bytes(IN, H, rows)} > "
                         f"{_SMEM_LIMIT} bytes)")
    lib = _kernels()
    with torch.cuda.device(dev):
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        outs = (new(T, B, H), new(T, B, H))
        if train:
            outs += (new(T, B, H4), new(T, B, H), new(T, B, H))
        # the inference forward passes null for z, h_prev and c_prev
        ptrs = [t.data_ptr() for t in (x, w, b, rk, h0, c0, *outs)] + [None] * (5 - len(outs))
        err = lib.cvl_lstm_seq_fwd(*ptrs, T, B, IN, H, rows, int(train),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        kind = "training forward" if train else "forward"
        raise RuntimeError(f"lstm_seq {kind} kernel launch failed: CUDA error {err}")
    _count("train_fwd" if train else "fwd", 1)
    return outs


def lstm_seq_fwd(x, w, b, rk, h0, c0):
    """The inference forward (signature and results of
    :func:`lstm_seq_fwd_plain`). CUDA tensors launch ``lstm_seq_fwd_kernel``
    on the current stream (or raise); CPU tensors take the plain version."""
    if _device_of(x).type == "cpu":
        return lstm_seq_fwd_plain(x, w, b, rk, h0, c0)
    return _launch_fwd(x, w, b, rk, h0, c0, train=False)


def lstm_seq_train_fwd(x, w, b, rk, h0, c0):
    """The training forward (signature and results of
    :func:`lstm_seq_train_fwd_plain`). CUDA tensors launch
    ``lstm_seq_fwd_kernel`` with its training outputs (or raise); CPU
    tensors take the plain version."""
    if _device_of(x).type == "cpu":
        return lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    return _launch_fwd(x, w, b, rk, h0, c0, train=True)


def lstm_seq_bwd(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t):
    """The backward (signature and results of :func:`lstm_seq_bwd_plain`).

    CUDA tensors launch ``lstm_seq_bwd_kernel`` (the serial reverse walk,
    which writes dz per step to scratch) and then
    ``wgrad_kernel<lstm_seq_wgrad>`` (dRk, dW and db over all T*B rows, in a
    fixed order), or raise; CPU tensors take the plain version."""
    args = (z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t)
    dev = _device_of(z)
    if dev.type == "cpu":
        return lstm_seq_bwd_plain(*args)
    if z.dim() != 3 or x.dim() != 3:
        raise ValueError("z must be [T, B, 4H] and x [T, B, IN]")
    T, B, H4 = z.shape
    H, IN = H4 // 4, x.shape[-1]
    if bwd_smem_bytes(H) > _SMEM_LIMIT:
        raise ValueError(f"hidden {H} is too wide for the LSTM backward kernel's shared memory "
                         f"({bwd_smem_bytes(H)} > {_SMEM_LIMIT} bytes)")
    s3 = lambda width: (T, B, width)
    _check(dev, {"z": (z, s3(H4)), "c_prev": (c_prev, s3(H)), "c": (c, s3(H)),
                 "h_prev": (h_prev, s3(H)), "x": (x, s3(IN)), "dh_seq": (dh_seq, s3(H)),
                 "dc_seq": (dc_seq, s3(H)), "rk_t": (rk_t, (H4, H)), "w_t": (w_t, (H4, IN))})
    lib = _kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        # the reverse walk reads (Rk | W)ᵀ row-wise: dz @ [Rkᵀ | Wᵀ]
        wt = torch.cat([rk_t, w_t], 1).contiguous()
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        dx, dh0, dc0, dz = new(T, B, IN), new(B, H), new(B, H), new(T, B, H4)
        err = lib.cvl_lstm_seq_bwd(*(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, wt,
                                                            dx, dh0, dc0, dz)),
                                   T, B, IN, H, stream)
        if err != 0:
            raise RuntimeError(f"lstm_seq backward kernel launch failed: CUDA error {err}")
        _count("bwd", 1)
        drk, dw, db = new(H, H4), new(IN, H4), new(H4)
        err = lib.cvl_lstm_seq_wgrad(*(t.data_ptr() for t in (h_prev, x, dz, drk, dw, db)),
                                     T * B, IN, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq weight-gradient kernel launch failed: CUDA error {err}")
    _count("bwd", 1)
    return dx, dh0, dc0, drk, dw, db


# ------------------------------------------------------------ autograd


class LstmSeqCore(torch.autograd.Function):
    """``_lstm_pallas_core_fp``'s vjp: the training forward and the backward
    kernels (or their plain versions on the CPU) behind one autograd node.

    Inputs: x ``[T, B, IN]``, w, b, rk, h0, c0; outputs: h and c ``[T, B,
    H]``."""

    @staticmethod
    def forward(ctx, x, w, b, rk, h0, c0):
        h, c, z, hp, cp = lstm_seq_train_fwd(x, w, b, rk, h0, c0)
        ctx.save_for_backward(z, cp, c, hp, x, w, rk)
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        z, cp, c, hp, x, w, rk = ctx.saved_tensors
        dx, dh0, dc0, drk, dw, db = lstm_seq_bwd(z, cp, c, hp, x, dh.contiguous(),
                                                 dc.contiguous(), rk.T.contiguous(),
                                                 w.T.contiguous())
        return dx, dw, db, drk, dh0, dc0


def lstm_sequence_kernel(params, x, h0, c0, compute_dtype=None, fusion=None):
    """``lstm_sequence_pallas`` on the whole-sequence kernels: x ``[B, T,
    IN]``, h0/c0 ``[B, H]`` -> ``(h_seq [B, T, H], (h_T, c_T))``.

    With autograd recording and any input requiring a gradient, the training
    forward runs inside :class:`LstmSeqCore`; otherwise (``torch.no_grad()``,
    evaluation) the inference forward runs alone — the JAX primal-versus-vjp
    split. ``fusion`` must normalise (:func:`.lstm.resolve_fusion`) to the
    default triple, and ``compute_dtype`` must be f32: the other rungs and
    the bf16 streams raise ``NotImplementedError``."""
    H = params["recurrent_kernel"].shape[0]
    if resolve_fusion(fusion, hidden_dim=H) != DEFAULT_FUSION:
        raise NotImplementedError(FUSION_TODO)
    if compute_dtype is not None and compute_dtype != torch.float32:
        raise NotImplementedError(BF16_TODO)
    ins = (x.transpose(0, 1).contiguous(), params["kernel"].contiguous(),
           params["bias"].contiguous(), params["recurrent_kernel"].contiguous(),
           h0.contiguous(), c0.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        h, c = LstmSeqCore.apply(*ins)
    else:
        h, c = lstm_seq_fwd(*ins)
    return h.transpose(0, 1), (h[-1], c[-1])
