"""Whole-sequence LSTM: CUDA wrappers, plain versions and the autograd
functions.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_lstm.py`` at every
fusion rung (proj, drk, full) that ``resolve_fusion`` returns. The default
rung (T, T, T), the one ``lstm_sequence_pallas`` takes at every width up to
the drk ceiling, runs three kernels of ``csrc/lstm_seq.cu``:

* the inference forward (``_forward_kernel_call_fp``): x ``[T, B, IN]``, W,
  b, Rk, h0, c0 -> h, c ``[T, B, H]``, the projection ``x @ W + b`` computed
  in the kernel;
* the training forward (``_forward_train_call_fp``): the same, plus the
  backward's residuals z ``[T, B, 4H]``, h_prev and c_prev;
* the backward (``_backward_call_full``): a serial reverse walk, then a
  deterministic weight-gradient pass (two launches), -> dx, dh0, dc0, dRk,
  dW, db.

The other rungs run four more:

* the unfused inference forward (``_forward_kernel_call``): xz ``[T, B,
  4H]`` (``x @ W + b``, computed outside), Rk, h0, c0 -> h, c;
* the unfused training forward (``_forward_train_call``): the same, plus z;
* the dz-only walk (``_backward_call``): the reverse walk alone, -> dz
  ``[T, B, 4H]`` at z's type, dh0, dc0 (one launch);
* the drk walk (``_backward_call_drk``): the same walk, then a
  deterministic pass for dRk = sum h_prevᵀdz (two launches).

At the proj rungs without ``full`` the training forward and the inference
forward are the default rung's, and the backward is a walk followed by the
products ``_core_fp_bwd`` leaves to XLA (dW, db, dx and, without drk, dRk);
at the unfused rungs (proj off) xz is one product before the core and its
autograd gives dW, db and dx. Those products outside the kernels are
``torch.matmul`` on f32 copies of the stream values (TF32 is off), as the
JAX package leaves them to XLA.

Each kernel has a plain PyTorch version with the same signature and
results, written step by step as the Pallas bodies compute:
:func:`lstm_seq_fwd_plain`, :func:`lstm_seq_train_fwd_plain`,
:func:`lstm_seq_bwd_plain` (which mirrors the TPU backward kernel; it is not
autograd of the plain forward), :func:`lstm_seq_xz_fwd_plain`,
:func:`lstm_seq_xz_train_fwd_plain`, :func:`lstm_seq_walk_plain` and
:func:`lstm_seq_walk_drk_plain`. The wrappers of the same names without
``_plain`` launch the kernels for CUDA tensors (or raise: there is no
fallback) and take the plain versions only for CPU tensors.

All three have a bf16 stream mode, the Pallas kernels' ``compute_dtype=bf16``,
chosen by the type of x (of z in the backward): x, Rk, z, h_prev and dx are
bf16; W stays f32 at the boundary and is rounded inside (the wrapper hands
the kernel a bf16 copy), so its gradient comes back f32 and unrounded, as
JAX's does; b, h0, c0, h, c, c_prev and the carries are f32. Products take
bf16-rounded operands and sum in f32 (the plain versions: ``a.bfloat16()
.float()`` operands of f32 matmuls). Rounding happens where the Pallas
bodies round: xz = x @ W + b before h @ Rk is added, h as the operand of
h @ Rk, z and h_prev as they are stored (the backward's gates read the
stored bf16 z), dz as the left operand of dz @ Rkᵀ, dz @ Wᵀ, dRk and dW, dx
as it is stored; db sums the unrounded dz, dRk comes back as bf16 and dW as
f32. The other rungs' kernels take xz and z at the stream type and store dz
at it (rounded, as the TPU kernels store it), so their db sums the rounded
dz; at the unfused rungs xz is ``(x @ W, f32 sum) + b`` rounded once, and
autograd of that product rounds dW and dx to bf16, as JAX's does.

:func:`lstm_sequence_kernel` is the entry, with ``lstm_sequence_pallas``'s
signature and results. Layouts are time-major inside, kernels ``[in, out]``,
and no lane or batch padding (so no padded rows for the drk sum to mask):
the TPU's VMEM gates and block picks are not read here; the card's shared
memory is the only limit, checked per call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .lstm import _gate_grads, _gates, bf16_operand, resolve_fusion
from .two_cell import _check, _mode

# launches since the counts were last set to 0: one per inference or training
# forward call (FWD, TRAIN_FWD; XZ_ the unfused rungs'), two per backward
# call of the full rung (BWD: the reverse walk, then the weight-gradient
# pass), one per dz-only walk (WALK), two per drk walk (DRK: the walk, then
# the dRk pass); the plain names count the f32 mode, the BF16_ names the bf16
# stream mode
FWD_LAUNCHES = 0
TRAIN_FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
XZ_FWD_LAUNCHES = 0
XZ_TRAIN_FWD_LAUNCHES = 0
WALK_LAUNCHES = 0
DRK_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_TRAIN_FWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
BF16_XZ_FWD_LAUNCHES = 0
BF16_XZ_TRAIN_FWD_LAUNCHES = 0
BF16_WALK_LAUNCHES = 0
BF16_DRK_LAUNCHES = 0
_launch_lock = threading.Lock()

_BWD_ROWS = 4             # kBwdRows in csrc/lstm_seq.cu
_BWD_UNITS = 256          # kUnits in csrc/lstm_seq.cu
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use


def fwd_smem_bytes(IN: int, H: int, rows: int) -> int:
    """Shared memory of one forward block: the step's x, h (two buffers) and
    c for each row of the tile."""
    return (IN + 3 * H) * rows * 4


def bwd_smem_bytes(H: int, rows: int = _BWD_ROWS) -> int:
    """Shared memory of one reverse-walk block: dz (4H) and the two carries
    (H each) per row, plus the K-split partial sums."""
    return (6 * H * rows + rows * _BWD_UNITS) * 4


def walk_rows(H: int) -> int:
    """The dz-only walk's row tile: the full rung's 4 rows where they fit
    shared memory, else 2 (H above ~2,300)."""
    return _BWD_ROWS if bwd_smem_bytes(H) <= _SMEM_LIMIT else 2


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
    _, op = _mode(x)
    xz = op(x.float().reshape(T * B, IN) @ op(w) + b).reshape(T, B, 4 * H)
    return _steps(xz, rk, h0, c0, x)


def _steps(xz, rk, h0, c0, stream):
    # per step z = xz + h @ Rk and the gates; xz f32 (the stream's values),
    # the mode that of ``stream``: in bf16 h is rounded as the operand, z and
    # h_prev are returned rounded
    H = rk.shape[0]
    bf16, op = _mode(stream)
    rk = rk.float()
    h, c = h0, c0
    outs = [[] for _ in range(5)]
    for t in range(xz.shape[0]):
        hp, cp = op(h), c
        z = xz[t] + hp @ rk
        h, c = _gates(z, c, H)
        for acc, v in zip(outs, (h, c, z, hp, cp)):
            acc.append(v)
    h, c, z, hp, cp = (torch.stack(o) for o in outs)
    if bf16:
        z, hp = z.bfloat16(), hp.bfloat16()
    return h, c, z, hp, cp


def lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0):
    """The unfused training forward's function in torch ops
    (``_forward_train_call``): xz ``[T, B, 4H]`` (x @ W + b, at the stream
    type), rk ``[H, 4H]``, h0/c0 ``[B, H]`` -> ``(h, c, z)``, z at xz's
    type. Per step ``z = xz + h @ Rk`` and the gates; in the bf16 mode (bf16
    xz and rk) h is rounded as the operand and z as it is stored."""
    h, c, z, _, _ = _steps(xz.float(), rk, h0, c0, xz)
    return h, c, z


def lstm_seq_xz_fwd_plain(xz, rk, h0, c0):
    """The unfused inference forward's function in torch ops
    (``_forward_kernel_call``): the ``(h, c)`` of
    :func:`lstm_seq_xz_train_fwd_plain`."""
    return _steps(xz.float(), rk, h0, c0, xz)[:2]


def lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0):
    """The training forward's function in torch ops.

    x ``[T, B, IN]``, w ``[IN, 4H]``, b ``[4H]``, rk ``[H, 4H]``, h0/c0
    ``[B, H]``. Returns ``(h, c, z, h_prev, c_prev)``, all ``[T, B, ...]``.
    As the Pallas body: ``xz = x @ W + b`` for the whole block first, then
    per step ``z = xz + h @ Rk`` and the gates. In the bf16 mode (bf16 x and
    rk, f32 w) xz and h are rounded as operands, and z and h_prev come back
    as bf16."""
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
    dc0, drk [H, 4H], dw [IN, 4H], db [4H])``. In the bf16 mode (bf16 z,
    h_prev, x and rk_t, f32 w_t) dz and w_t are rounded as operands, db sums
    the unrounded dz, and dx and drk come back as bf16, dw as f32."""
    T, B, H4 = z.shape
    bf16, op = _mode(z)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=z.device)
    dh, dc = zeros(B, H4 // 4), zeros(B, H4 // 4)
    drk, dw, db = zeros(*rk_t.T.shape), zeros(*w_t.T.shape), zeros(H4)
    rk_t, w_t = rk_t.float(), op(w_t)
    dx = [None] * T
    for t in reversed(range(T)):
        dz, dc = _gate_grads(z[t].float(), c[t], c_prev[t], dh + dh_seq[t], dc + dc_seq[t])
        dzo = op(dz)
        dh = dzo @ rk_t
        dx[t] = dzo @ w_t
        drk += h_prev[t].float().T @ dzo
        dw += x[t].float().T @ dzo
        db += dz.sum(0)
    dx = torch.stack(dx)
    if bf16:
        dx, drk = dx.bfloat16(), drk.bfloat16()
    return dx, dh, dc, drk, dw, db


def _walk_steps(z, c_prev, c, dh_seq, dc_seq, rk_t, h_prev=None):
    # the body of both plain walks: the dz-only walk, and with h_prev the drk
    # walk's dRk sum
    T, B, H4 = z.shape
    bf16, op = _mode(z)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=z.device)
    dh, dc = zeros(B, H4 // 4), zeros(B, H4 // 4)
    drk = None if h_prev is None else zeros(H4 // 4, H4)
    rk_t = rk_t.float()
    dzs = [None] * T
    for t in reversed(range(T)):
        dz, dc = _gate_grads(z[t].float(), c[t], c_prev[t], dh + dh_seq[t], dc + dc_seq[t])
        dzs[t] = dzo = op(dz)  # stored at z's type: the operand's value
        dh = dzo @ rk_t
        if drk is not None:
            drk += h_prev[t].float().T @ dzo
    return torch.stack(dzs).to(z.dtype), dh, dc, drk


def lstm_seq_walk_plain(z, c_prev, c, dh_seq, dc_seq, rk_t):
    """The dz-only walk's function in torch ops, step by step
    (``_lstm_bwd_kernel``): z ``[T, B, 4H]``, c_prev/c/dh_seq/dc_seq ``[T, B,
    H]``, rk_t ``[4H, H]`` -> ``(dz [T, B, 4H] at z's type, dh0, dc0)``. Per
    step in reverse the gate gradients and ``dh = dz @ Rkᵀ``; in the bf16
    mode (bf16 z and rk_t) dz is rounded as the operand and as it is
    stored."""
    return _walk_steps(z, c_prev, c, dh_seq, dc_seq, rk_t)[:3]


def lstm_seq_walk_drk_plain(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """The drk walk's function in torch ops (``_lstm_bwd_kernel_drk``): the
    dz-only walk plus ``dRk = sum_t h_prev[t]ᵀ dz[t]`` in f32 over the
    rounded operands (h_prev ``[T, B, H]`` at z's type) -> ``(dz, dh0, dc0,
    drk [H, 4H] f32)``."""
    return _walk_steps(z, c_prev, c, dh_seq, dc_seq, rk_t, h_prev)


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
            lib.cvl_lstm_seq_bwd_smem_bytes.argtypes = [I] * 2
            lib.cvl_lstm_seq_bwd_smem_bytes.restype = LL
            if (any(lib.cvl_lstm_seq_fwd_smem_bytes(i, 256, r) != fwd_smem_bytes(i, 256, r)
                    for r in (4, 16) for i in (0, 109))
                    or any(lib.cvl_lstm_seq_bwd_smem_bytes(256, r) != bwd_smem_bytes(256, r)
                           for r in (2, 4))):
                raise RuntimeError("shared-memory layout of csrc/lstm_seq.cu differs from "
                                   "fwd_smem_bytes / bwd_smem_bytes")
            argtypes = {"fwd": [P] * 11 + [I] * 6, "bwd": [P] * 10 + [I] * 4,
                        "wgrad": [P] * 6 + [I] * 3, "xz_fwd": [P] * 7 + [I] * 5,
                        "walk": [P] * 9 + [I] * 4, "drk": [P] * 3 + [I] * 2}
            for name, types in argtypes.items():
                for sfx in ("", "_bf16"):
                    fn = getattr(lib, f"cvl_lstm_seq_{name}{sfx}")
                    fn.argtypes = types + [P]  # the stream last
                    fn.restype = I
            _lib = lib
        return _lib


def _count(which: str, n: int, bf16: bool):
    """Add n to the count ``[BF16_]<WHICH>_LAUNCHES``."""
    name = f"{'BF16_' if bf16 else ''}{which.upper()}_LAUNCHES"
    with _launch_lock:
        globals()[name] += n


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
    bf16 = x.dtype == torch.bfloat16
    _check(dev, {"x": (x, (T, B, IN)), "w": (w, (IN, H4)), "b": (b, (H4,)), "rk": (rk, (H, H4)),
                 "h0": (h0, (B, H)), "c0": (c0, (B, H))},
           bf16=frozenset({"x", "rk"}) if bf16 else frozenset())
    rows = fwd_rows(B, IN, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    if fwd_smem_bytes(IN, H, rows) > _SMEM_LIMIT:
        raise ValueError(f"input width {IN} + hidden {H} is too wide for the LSTM forward "
                         f"kernel's shared memory ({fwd_smem_bytes(IN, H, rows)} > "
                         f"{_SMEM_LIMIT} bytes)")
    lib = _kernels()
    sd = torch.bfloat16 if bf16 else torch.float32
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        outs = (new(T, B, H), new(T, B, H))
        if train:
            outs += (new(T, B, H4, dtype=sd), new(T, B, H, dtype=sd), new(T, B, H))
        if bf16:
            w = w.to(torch.bfloat16)  # rounded for the kernel only: the core keeps W f32
        # the inference forward passes null for z, h_prev and c_prev
        ptrs = [t.data_ptr() for t in (x, w, b, rk, h0, c0, *outs)] + [None] * (5 - len(outs))
        launch = lib.cvl_lstm_seq_fwd_bf16 if bf16 else lib.cvl_lstm_seq_fwd
        err = launch(*ptrs, T, B, IN, H, rows, int(train),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        kind = "training forward" if train else "forward"
        raise RuntimeError(f"lstm_seq {kind} kernel launch failed: CUDA error {err}")
    _count("train_fwd" if train else "fwd", 1, bf16)
    return outs


def lstm_seq_fwd(x, w, b, rk, h0, c0):
    """The inference forward (signature and results of
    :func:`lstm_seq_fwd_plain`). CUDA tensors launch ``lstm_seq_fwd_kernel``
    on the current stream (or raise), in the bf16 stream mode where x is
    bf16; CPU tensors take the plain version."""
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
    fixed order), or raise, in the bf16 stream mode where z is bf16; CPU
    tensors take the plain version."""
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
    bf16 = z.dtype == torch.bfloat16
    _check(dev, {"z": (z, s3(H4)), "c_prev": (c_prev, s3(H)), "c": (c, s3(H)),
                 "h_prev": (h_prev, s3(H)), "x": (x, s3(IN)), "dh_seq": (dh_seq, s3(H)),
                 "dc_seq": (dc_seq, s3(H)), "rk_t": (rk_t, (H4, H)), "w_t": (w_t, (H4, IN))},
           bf16=frozenset({"z", "h_prev", "x", "rk_t"}) if bf16 else frozenset())
    lib = _kernels()
    sfx = "_bf16" if bf16 else ""
    sd = torch.bfloat16 if bf16 else torch.float32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        # the reverse walk reads (Rk | W)ᵀ row-wise: dz @ [Rkᵀ | Wᵀ] (W rounded
        # for the kernel only in the bf16 mode)
        wt = torch.cat([rk_t, w_t.to(sd)], 1).contiguous()
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        dx, dh0, dc0, dz = new(T, B, IN, dtype=sd), new(B, H), new(B, H), new(T, B, H4)
        err = getattr(lib, f"cvl_lstm_seq_bwd{sfx}")(
            *(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, wt, dx, dh0, dc0, dz)),
            T, B, IN, H, stream)
        if err != 0:
            raise RuntimeError(f"lstm_seq backward kernel launch failed: CUDA error {err}")
        _count("bwd", 1, bf16)
        drk, dw, db = new(H, H4, dtype=sd), new(IN, H4), new(H4)
        err = getattr(lib, f"cvl_lstm_seq_wgrad{sfx}")(
            *(t.data_ptr() for t in (h_prev, x, dz, drk, dw, db)), T * B, IN, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq weight-gradient kernel launch failed: CUDA error {err}")
    _count("bwd", 1, bf16)
    return dx, dh0, dc0, drk, dw, db


def _launch_xz_fwd(xz, rk, h0, c0, train: bool):
    dev = xz.device
    if xz.dim() != 3 or rk.dim() != 2:
        raise ValueError("xz must be [T, B, 4H] and rk [H, 4H]")
    T, B, H4 = xz.shape
    H = rk.shape[0]
    if T < 1 or B < 1:
        raise ValueError(f"need T, B >= 1 (got {T}, {B})")
    bf16 = xz.dtype == torch.bfloat16
    _check(dev, {"xz": (xz, (T, B, 4 * H)), "rk": (rk, (H, 4 * H)), "h0": (h0, (B, H)),
                 "c0": (c0, (B, H))},
           bf16=frozenset({"xz", "rk"}) if bf16 else frozenset())
    rows = fwd_rows(B, 0, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    if fwd_smem_bytes(0, H, rows) > _SMEM_LIMIT:
        raise ValueError(f"hidden {H} is too wide for the LSTM forward kernel's shared memory "
                         f"({fwd_smem_bytes(0, H, rows)} > {_SMEM_LIMIT} bytes)")
    lib = _kernels()
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        outs = (new(T, B, H), new(T, B, H))
        if train:
            outs += (new(T, B, 4 * H, dtype=xz.dtype),)
        # the inference forward passes null for z
        ptrs = [t.data_ptr() for t in (xz, rk, h0, c0, *outs)] + [None] * (3 - len(outs))
        launch = lib.cvl_lstm_seq_xz_fwd_bf16 if bf16 else lib.cvl_lstm_seq_xz_fwd
        err = launch(*ptrs, T, B, H, rows, int(train), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        kind = "training forward" if train else "forward"
        raise RuntimeError(f"lstm_seq unfused {kind} kernel launch failed: CUDA error {err}")
    _count("xz_train_fwd" if train else "xz_fwd", 1, bf16)
    return outs


def lstm_seq_xz_fwd(xz, rk, h0, c0):
    """The unfused inference forward (signature and results of
    :func:`lstm_seq_xz_fwd_plain`). CUDA tensors launch
    ``lstm_seq_fwd_kernel`` in its xz mode (or raise), in the bf16 stream
    mode where xz is bf16; CPU tensors take the plain version."""
    if _device_of(xz).type == "cpu":
        return lstm_seq_xz_fwd_plain(xz, rk, h0, c0)
    return _launch_xz_fwd(xz, rk, h0, c0, train=False)


def lstm_seq_xz_train_fwd(xz, rk, h0, c0):
    """The unfused training forward (signature and results of
    :func:`lstm_seq_xz_train_fwd_plain`). CUDA tensors launch
    ``lstm_seq_fwd_kernel`` in its xz mode with z as output (or raise); CPU
    tensors take the plain version."""
    if _device_of(xz).type == "cpu":
        return lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    return _launch_xz_fwd(xz, rk, h0, c0, train=True)


def _launch_walk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """Check the walk's inputs (h_prev may be None) and launch it; returns
    (dz, dh0, dc0). Counts nothing: the caller's wrapper does."""
    dev = z.device
    if z.dim() != 3:
        raise ValueError("z must be [T, B, 4H]")
    T, B, H4 = z.shape
    H = H4 // 4
    rows = walk_rows(H)
    if bwd_smem_bytes(H, rows) > _SMEM_LIMIT:
        raise ValueError(f"hidden {H} is too wide for the LSTM walk kernel's shared memory "
                         f"({bwd_smem_bytes(H, rows)} > {_SMEM_LIMIT} bytes)")
    s3 = lambda width: (T, B, width)
    bf16 = z.dtype == torch.bfloat16
    _check(dev, {"z": (z, s3(H4)), "c_prev": (c_prev, s3(H)), "c": (c, s3(H)),
                 "h_prev": (h_prev, s3(H)), "dh_seq": (dh_seq, s3(H)), "dc_seq": (dc_seq, s3(H)),
                 "rk_t": (rk_t, (H4, H))},
           bf16=frozenset({"z", "h_prev", "rk_t"}) if bf16 else frozenset())
    lib = _kernels()
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        dz, dh0, dc0 = new(T, B, H4, dtype=z.dtype), new(B, H), new(B, H)
        launch = lib.cvl_lstm_seq_walk_bf16 if bf16 else lib.cvl_lstm_seq_walk
        err = launch(*(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, rk_t, dh0, dc0, dz)),
                     T, B, H, rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq walk kernel launch failed: CUDA error {err}")
    return dz, dh0, dc0


def lstm_seq_walk(z, c_prev, c, dh_seq, dc_seq, rk_t):
    """The dz-only walk (signature and results of
    :func:`lstm_seq_walk_plain`). CUDA tensors launch
    ``lstm_seq_bwd_kernel<S, S, R>`` (or raise), in the bf16 stream mode
    where z is bf16; CPU tensors take the plain version."""
    if _device_of(z).type == "cpu":
        return lstm_seq_walk_plain(z, c_prev, c, dh_seq, dc_seq, rk_t)
    out = _launch_walk(z, c_prev, c, None, dh_seq, dc_seq, rk_t)
    _count("walk", 1, z.dtype == torch.bfloat16)
    return out


def lstm_seq_walk_drk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """The drk walk (signature and results of
    :func:`lstm_seq_walk_drk_plain`). CUDA tensors launch the walk
    ``lstm_seq_bwd_kernel<S, S, R>`` and then ``wgrad_kernel<lstm_seq_wgrad>``
    with one job, dRk over all T*B rows in a fixed order (or raise); CPU
    tensors take the plain version."""
    if _device_of(z).type == "cpu":
        return lstm_seq_walk_drk_plain(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t)
    dz, dh0, dc0 = _launch_walk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t)
    bf16 = z.dtype == torch.bfloat16
    _count("drk", 1, bf16)
    dev = z.device
    T, B, H4 = z.shape
    lib = _kernels()
    with torch.cuda.device(dev):
        drk = torch.empty((H4 // 4, H4), dtype=torch.float32, device=dev)
        launch = lib.cvl_lstm_seq_drk_bf16 if bf16 else lib.cvl_lstm_seq_drk
        err = launch(h_prev.data_ptr(), dz.data_ptr(), drk.data_ptr(), T * B, H4 // 4,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq dRk kernel launch failed: CUDA error {err}")
    _count("drk", 1, bf16)
    return dz, dh0, dc0, drk


# ------------------------------------------------------------ autograd


def _walk_and_drk(drk, z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """``_bptt_and_drk``: the drk walk, or the dz-only walk and then dRk as
    one product outside the kernel. Returns (dz, dh0, dc0, dRk f32)."""
    if drk:
        return lstm_seq_walk_drk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t)
    dz, dh0, dc0 = lstm_seq_walk(z, c_prev, c, dh_seq, dc_seq, rk_t)
    T, B, H4 = z.shape
    drk_g = h_prev.reshape(T * B, H4 // 4).float().T @ dz.reshape(T * B, H4).float()
    return dz, dh0, dc0, drk_g


class LstmSeqCore(torch.autograd.Function):
    """``_lstm_pallas_core_fp``'s vjp: the training forward and, per the
    static ``drk`` / ``full`` switches, the full rung's backward kernels or a
    walk and the projection backward of ``_core_fp_bwd`` (or their plain
    versions on the CPU) behind one autograd node.

    Inputs: x ``[T, B, IN]``, w, b, rk, h0, c0, drk, full; outputs: h and c
    ``[T, B, H]``. With bf16 x and rk (w f32) it runs the bf16 stream mode
    and returns bf16 gradients for x and rk, f32 ones for w, b, h0 and c0."""

    @staticmethod
    def forward(ctx, x, w, b, rk, h0, c0, drk, full):
        h, c, z, hp, cp = lstm_seq_train_fwd(x, w, b, rk, h0, c0)
        ctx.save_for_backward(z, cp, c, hp, x, w, rk)
        ctx.fusion = (drk, full)
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        z, cp, c, hp, x, w, rk = ctx.saved_tensors
        drk, full = ctx.fusion
        dh, dc, rk_t = dh.contiguous(), dc.contiguous(), rk.T.contiguous()
        if full:
            dx, dh0, dc0, drk_g, dw, db = lstm_seq_bwd(z, cp, c, hp, x, dh, dc, rk_t,
                                                       w.T.contiguous())
            return dx, dw, db, drk_g, dh0, dc0, None, None
        dz, dh0, dc0, drk_g = _walk_and_drk(drk, z, cp, c, hp, dh, dc, rk_t)
        # the projection backward (``_core_fp_bwd``): f32 sums of the stream
        # values; dW and db stay f32, dx is rounded to x's type
        T, B, IN = x.shape
        dzf = dz.reshape(T * B, -1).float()
        dw = x.reshape(T * B, IN).float().T @ dzf
        db = dzf.sum(0)
        w_op = bf16_operand(w) if x.dtype == torch.bfloat16 else w
        dx = (dzf @ w_op.T).reshape(T, B, IN).to(x.dtype)
        return dx, dw, db, drk_g.to(rk.dtype), dh0, dc0, None, None


class LstmSeqXzCore(torch.autograd.Function):
    """``_lstm_pallas_core``'s vjp, the unfused rungs: the unfused training
    forward and the walk (dz-only, or with ``drk`` the drk walk), or their
    plain versions on the CPU, behind one autograd node.

    Inputs: xz ``[T, B, 4H]`` (x @ W + b at the stream type), rk, h0, c0,
    drk; outputs: h and c ``[T, B, H]``. The gradient of xz is dz at its
    type; that of rk is dRk at its type (summed in f32, rounded once)."""

    @staticmethod
    def forward(ctx, xz, rk, h0, c0, drk):
        h, c, z = lstm_seq_xz_train_fwd(xz, rk, h0, c0)
        ctx.save_for_backward(rk, h0, c0, h, c, z)
        ctx.drk = drk
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        rk, h0, c0, h, c, z = ctx.saved_tensors
        cp = torch.cat([c0[None], c[:-1]])
        hp = torch.cat([h0[None], h[:-1]]).to(z.dtype)
        dz, dh0, dc0, drk_g = _walk_and_drk(ctx.drk, z, cp, c, hp, dh.contiguous(),
                                            dc.contiguous(), rk.T.contiguous())
        return dz, drk_g.to(rk.dtype), dh0, dc0, None


def _hoisted_projection(x, params, bf16: bool):
    """The unfused rungs' xz = x @ W + b, time-major ``[T, B, 4H]``, as
    ``lstm_sequence_pallas`` computes it before the core: in bf16 the
    product of the rounded operands summed in f32, plus b, rounded once to
    bf16 (autograd then rounds dW and dx to bf16, as JAX's does); in f32 the
    f32 product plus b."""
    x_t = x.transpose(0, 1)
    if bf16:
        xz = bf16_operand(x_t) @ bf16_operand(params["kernel"]) + params["bias"]
        return xz.to(torch.bfloat16).contiguous()
    return (x_t @ params["kernel"] + params["bias"]).contiguous()


def lstm_sequence_kernel(params, x, h0, c0, compute_dtype=None, fusion=None):
    """``lstm_sequence_pallas`` on the whole-sequence kernels: x ``[B, T,
    IN]``, h0/c0 ``[B, H]`` -> ``(h_seq [B, T, H], (h_T, c_T))``.

    ``fusion`` is normalised by :func:`.lstm.resolve_fusion` (``None``: the
    default triple, dropped to proj-only above the drk ceiling). At the proj
    rungs, with autograd recording and any input requiring a gradient, the
    training forward runs inside :class:`LstmSeqCore`; otherwise
    (``torch.no_grad()``, evaluation) the inference forward runs alone — the
    JAX primal-versus-vjp split; the primal of every proj rung is the same.
    At the unfused rungs xz = x @ W + b is computed first
    (:func:`_hoisted_projection`) and :class:`LstmSeqXzCore` or the unfused
    inference forward runs on it. ``compute_dtype=torch.bfloat16`` is the
    bf16 stream mode: as ``lstm_sequence_pallas`` does, x (or xz) and the
    recurrent kernel are cast to bf16 outside the autograd function (their
    gradients come back bf16-valued, as f32), and at the proj rungs the
    kernel W enters it in f32 (rounded inside, so its gradient is not
    rounded)."""
    H = params["recurrent_kernel"].shape[0]
    proj, drk, full = resolve_fusion(fusion, hidden_dim=H)
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} (None, float32 or bfloat16)")
    sd = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    rk = params["recurrent_kernel"].to(sd).contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    if proj:
        ins = (x.transpose(0, 1).to(sd).contiguous(), params["kernel"].contiguous(),
               params["bias"].contiguous(), rk, h0, c0)
        core, fwd, flags = LstmSeqCore, lstm_seq_fwd, (drk, full)
    else:
        ins = (_hoisted_projection(x, params, sd == torch.bfloat16), rk, h0, c0)
        core, fwd, flags = LstmSeqXzCore, lstm_seq_xz_fwd, (drk,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        h, c = core.apply(*ins, *flags)
    else:
        h, c = fwd(*ins)
    return h.transpose(0, 1), (h[-1], c[-1])
