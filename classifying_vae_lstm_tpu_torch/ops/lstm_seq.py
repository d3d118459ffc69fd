"""Whole-sequence LSTM: CUDA wrappers, plain versions and the autograd
functions.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_lstm.py`` at every
fusion rung (proj, drk, full) that ``resolve_fusion`` returns. The default
rung (T, T, T), the one ``lstm_sequence_pallas`` takes at every width up to
the drk ceiling, runs three kernels:

* the inference forward (``_forward_kernel_call_fp``, ``csrc/lstm_seq.cu``):
  x ``[T, B, IN]``, W, b, Rk, h0, c0 -> h, c ``[T, B, H]``, the projection
  ``x @ W + b`` computed in the kernel, one launch for all T steps whose
  blocks each own a slice of the hidden units for a group of rows
  (:func:`fwd_plan`), that slice of ``[W ; Rk]`` resident in shared memory
  where it fits;
* the training forward (``_forward_train_call_fp``, ``csrc/lstm_seq.cu``):
  the same, plus the backward's residuals z ``[T, B, 4H]``, h_prev and
  c_prev;
* the backward (``_backward_call_full``, ``csrc/lstm_bwd_f32.cu``): a reverse
  walk over the whole batch per step (T + 1 launches), then dx, the weight
  gradients and db, every sum in a fixed order, -> dx, dh0, dc0, dRk, dW,
  db.

The other rungs run four more:

* the unfused inference forward (``_forward_kernel_call``): xz ``[T, B,
  4H]`` (``x @ W + b``, computed outside), Rk, h0, c0 -> h, c;
* the unfused training forward (``_forward_train_call``): the same, plus z;
* the dz-only walk (``_backward_call``): the reverse walk alone, -> dz
  ``[T, B, 4H]`` at z's type, dh0, dc0;
* the drk walk (``_backward_call_drk``): the same walk, then a
  deterministic pass for dRk = sum h_prevᵀdz.

In f32 both walks are the full backward's walk (``csrc/lstm_bwd_f32.cu``,
T + 1 launches over the whole batch; the drk walk's dRk is its row-split
sum, two launches more).

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

The bf16 stream mode runs on the tensor cores, through
``csrc/lstm_seq_tc.cu``: a forward is one projection launch (proj rungs)
and one launch per time step (a tiled ``[B, H] x [H, 4H]`` product with the
gates in its epilogue), a walk two launches per step (the gate gradients,
then ``dz @ [Rkᵀ | Wᵀ]``), dRk one more product; the f32 mode stays on FFMA
(``csrc/lstm_seq.cu`` for the forwards, ``csrc/lstm_bwd_f32.cu`` for the
backward and the walks), exact to JAX's precision="highest".
The wrappers build the tensor-core operands in plain PyTorch (Rk and W with
each unit's four gates side by side, K padded to a multiple of 8; see
:func:`interleave_gates`, :func:`tc_fwd_operands`, :func:`tc_h_operand`,
:func:`tc_walk_weights`), and a launch count still counts one per wrapper
call (two for the full backward and the drk walk), whatever the device
launches inside.

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
the TPU's VMEM gates and block picks are not read here; the f32 forwards
stream what does not fit shared memory, the backward and the walks keep
their state in global memory, and the bf16 route has no limit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._checks import _aligned, _check, _device_of
from .lstm import _gate_grads, _gates, bf16_operand, resolve_fusion
from .two_cell import _mode

# launches since the counts were last set to 0: one per inference or training
# forward call (FWD, TRAIN_FWD; XZ_ the unfused rungs'), two per backward
# call of the full rung (BWD: the reverse walk, then the gradient products),
# one per dz-only walk (WALK), two per drk walk (DRK: the walk, then the dRk
# pass); the plain names count the f32 mode, the BF16_ names the bf16 stream
# mode (calls make more device launches each: T+1 for a bf16 forward, 2T for
# a bf16 walk, 2T+2 for the bf16 full backward, T+5 for the f32 one, T+1 for
# an f32 walk and 2 for its dRk pass, counted as above)
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

_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
# the f32 forward (csrc/lstm_seq.cu): 8 warps a block, 32-k chunks through a
# ring of _FWD_STAGES[rt] stages (operand rows padded by 4 floats), and a
# block owns at most 64 units
_FWD_WARPS, _FWD_KC, _FWD_MAX_NU = 8, 32, 64
_FWD_STAGES = {1: 8, 2: 5, 4: 3}


def _round_kc(n: int) -> int:
    return -(-n // _FWD_KC) * _FWD_KC


def fwd_tile_rows(nu: int, rt: int) -> int:
    """Rows of the f32 forward's tile: a warp owns 4 unit pairs x 8 rt rows,
    the block's warps cover its nu / 2 pairs first, then rows."""
    return 8 * rt * (_FWD_WARPS // -(-(nu // 2) // 4))


def fwd_smem_bytes(nu: int, rt: int, kx: int, kh: int, resident: bool) -> int:
    """Shared memory of one f32 forward block (``fwd_smem_bytes``): the
    resident slice ``[kx + kh][4 nu]`` and the ring, each stage a tile's
    operand chunk ``[rows][36]`` and, streamed, the slice's chunk
    ``[32][4 nu]``."""
    stage = fwd_tile_rows(nu, rt) * (_FWD_KC + 4) + (0 if resident else _FWD_KC * 4 * nu)
    return 4 * ((kx + kh) * 4 * nu * int(resident) + _FWD_STAGES[rt] * stage)


def fwd_plan(B: int, IN: int, H: int, n_sm: int) -> dict:
    """The f32 forward's layout on a card of ``n_sm`` SMs (IN = 0: the xz
    mode). Each block owns nu units (even; 2 cdiv(H, 16), so that 8 blocks
    cover H, at most 64) for every row of its group; a group is NB =
    cdiv(H, nu) blocks, and the groups split the rows: n_sm // NB of them,
    one block an SM, all in one cooperative launch, each walking its rows in
    tiles of :func:`fwd_tile_rows` rows, rt = 1, 2 or 4 rows a thread as the
    group's rows need. The slice of ``[W ; Rk]`` (kx = IN, kh = H, each
    padded to 32 rows) is resident in shared memory where it fits, with the
    largest of those rt that lets it, else streamed with the smallest rt
    from the rows' whose ring fits (a larger tile has fewer stages). Raises
    where H needs more blocks than the card holds."""
    nu = min(2 * -(-H // 16), _FWD_MAX_NU)
    NB = -(-H // nu)
    if NB > n_sm:
        raise ValueError(f"hidden {H} needs {NB} blocks a group, more than the card's {n_sm} SMs")
    rpg = -(-B // (n_sm // NB))  # rows a group
    base = fwd_tile_rows(nu, 1)
    want = next((rt for rt in (1, 2) if rpg <= rt * base), 4)
    kx, kh = _round_kc(IN) if IN else 0, _round_kc(H)
    fit = [rt for rt in (4, 2, 1)
           if rt <= want and fwd_smem_bytes(nu, rt, kx, kh, True) <= _SMEM_LIMIT]
    streamed = [rt for rt in (1, 2, 4)
                if rt >= want and fwd_smem_bytes(nu, rt, kx, kh, False) <= _SMEM_LIMIT]
    rt, resident = (fit[0], True) if fit else (streamed[0] if streamed else 4, False)
    return {"nu": nu, "NB": NB, "rpg": rpg, "groups": -(-B // rpg), "kx": kx, "kh": kh,
            "resident": resident, "rt": rt}


def card_plan(B: int, IN: int, H: int, dev) -> dict:
    """:func:`fwd_plan` on the SMs of the card ``dev``."""
    return fwd_plan(B, IN, H, torch.cuda.get_device_properties(dev).multi_processor_count)


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


# ------------------------------------------------------------ the bf16 route's layouts


def round8(n: int) -> int:
    """n rounded up to a multiple of 8: a 16-byte row of bf16."""
    return -(-n // 8) * 8


def interleave_gates(w):
    """The columns of a gate-ordered ``[K, 4H]`` weight ([i | f | c | o],
    unit u of gate g at ``g*H + u``) permuted so that the four gates of unit
    u are columns ``4u .. 4u+3``, the layout ``csrc/lstm_seq_tc.cu``'s step
    epilogue reads (a 1-D bias likewise); the kernels write z and xz back at
    the gate-ordered layout."""
    H = w.shape[-1] // 4
    return w.reshape(*w.shape[:-1], 4, H).transpose(-1, -2).reshape(w.shape)


def tc_fwd_operands(x, w):
    """The bf16 projection's operands as ``csrc/lstm_seq_tc.cu`` takes them:
    x ``[T*B, INp]`` and W ``[INp, 4H]`` bf16, K padded by zeros to a
    multiple of 8 (INp), W's columns gate-interleaved (W is rounded here,
    for the kernel only)."""
    T, B, IN = x.shape
    pad = round8(IN) - IN
    xp = torch.nn.functional.pad(x.reshape(T * B, IN), (0, pad)).contiguous()
    wp = torch.nn.functional.pad(interleave_gates(w.to(torch.bfloat16)), (0, 0, 0, pad))
    return xp, wp.contiguous()


def tc_h_operand(h0, Hp: int):
    """The double-buffered h operand ``[2, B, Hp]`` bf16 of the steps:
    buffer 0 holds h0 rounded, the pad columns and buffer 1 zeros."""
    hb = torch.zeros((2, h0.shape[0], Hp), dtype=torch.bfloat16, device=h0.device)
    hb[0, :, :h0.shape[1]] = h0
    return hb


def tc_walk_weights(rk_t, w_t=None):
    """The right operand of the bf16 walk's step product, ``[4H, Hp + INp]``
    bf16: Rkᵀ in columns < H and (the full rung) Wᵀ, rounded, from column Hp
    = round8(H), zeros elsewhere, so each row is a whole number of 16-byte
    chunks. Returns it and the first dx column (Hp). The walk's Rkᵀ alone is
    returned as it is when H is a multiple of 8."""
    H4, H = rk_t.shape
    Hp = round8(H)
    if w_t is None:
        return (rk_t if Hp == H else torch.nn.functional.pad(rk_t, (0, Hp - H))), Hp
    IN = w_t.shape[1]
    wt = torch.zeros((H4, Hp + round8(IN)), dtype=torch.bfloat16, device=rk_t.device)
    wt[:, :H] = rk_t
    wt[:, Hp:Hp + IN] = w_t
    return wt, Hp


# ------------------------------------------------------------ CUDA wrappers

_lib_lock = threading.Lock()
_lib = None
_tc_lib = None
_bwd_lib = None


def _kernels():
    """The built f32 library (``csrc/lstm_seq.cu``) with its ctypes
    signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("lstm_seq")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cvl_lstm_seq_fwd_smem_bytes.argtypes = [I] * 5
            lib.cvl_lstm_seq_fwd_smem_bytes.restype = LL
            if any(lib.cvl_lstm_seq_fwd_smem_bytes(nu, rt, kx, 256, r)
                   != fwd_smem_bytes(nu, rt, kx, 256, bool(r))
                   for nu in (12, 32, 64) for rt in (1, 2, 4) for kx in (0, 128)
                   for r in (0, 1)):
                raise RuntimeError("shared-memory layout of csrc/lstm_seq.cu differs from "
                                   "fwd_smem_bytes")
            lib.cvl_lstm_seq_fwd.argtypes = [P] * 13 + [I] * 13 + [P]  # the stream last
            lib.cvl_lstm_seq_fwd.restype = I
            _lib = lib
        return _lib


def _bwd_kernels():
    """The built f32 backward library (``csrc/lstm_bwd_f32.cu``: the full
    backward and the other rungs' walks) with its ctypes signatures."""
    global _bwd_lib
    with _lib_lock:
        if _bwd_lib is None:
            lib = _build.load("lstm_bwd_f32")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.cvl_lstm_bwd_f32_part_rows.argtypes = [I] * 2
            lib.cvl_lstm_bwd_f32_part_rows.restype = I
            lib.cvl_lstm_bwd_f32_scratch.argtypes = [I] * 4
            lib.cvl_lstm_bwd_f32_drk_scratch.argtypes = [I] * 2
            lib.cvl_lstm_bwd_f32_scratch.restype = ctypes.c_longlong
            lib.cvl_lstm_bwd_f32_drk_scratch.restype = ctypes.c_longlong
            lib.cvl_lstm_bwd_f32.argtypes = [P] * 18 + [I] * 4 + [P]
            lib.cvl_lstm_bwd_f32_walk.argtypes = [P] * 9 + [I] * 3 + [P]
            lib.cvl_lstm_bwd_f32_drk.argtypes = [P] * 4 + [I] * 2 + [P]
            for fn in (lib.cvl_lstm_bwd_f32, lib.cvl_lstm_bwd_f32_walk, lib.cvl_lstm_bwd_f32_drk):
                fn.restype = I
            _bwd_lib = lib
        return _bwd_lib


def _tc_kernels():
    """The built bf16 tensor-core library (``csrc/lstm_seq_tc.cu``) with its
    ctypes signatures."""
    global _tc_lib
    with _lib_lock:
        if _tc_lib is None:
            lib = _build.load("lstm_seq_tc")
            P, I = ctypes.c_void_p, ctypes.c_int
            argtypes = {"proj": [P] * 4 + [I] * 3, "steps": [P] * 9 + [I] * 4,
                        "walk": [P] * 6 + [I] * 2 + [P] * 5 + [I] * 4,
                        "drk": [P] * 3 + [I] * 3, "dw_db": [P] * 4 + [I] * 3}
            for name, types in argtypes.items():
                fn = getattr(lib, f"cvl_lstm_tc_{name}")
                fn.argtypes = types + [P]  # the stream last
                fn.restype = I
            _tc_lib = lib
        return _tc_lib


def _count(which: str, n: int, bf16: bool):
    """Add n to the count ``[BF16_]<WHICH>_LAUNCHES``."""
    name = f"{'BF16_' if bf16 else ''}{which.upper()}_LAUNCHES"
    with _launch_lock:
        globals()[name] += n


def _raise_if(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"lstm_seq {what} kernel launch failed: CUDA error {err}")


def _f32_fwd(x, xz, w, b, rk, h0, c0, train: bool, what: str):
    """One launch of the f32 forward (``lstm_fwd_kernel``) on x ``[T, B,
    IN]`` with W and b, or (x None) on xz ``[T, B, 4H]``; every weight read
    as stored: the plan, the outputs (h, c and, training, z and outside the
    xz mode h_prev and c_prev), which it returns; raises if the launch
    fails."""
    src = x if x is not None else xz
    T, B, _ = src.shape
    H, dev = rk.shape[0], src.device
    IN = 0 if x is None else x.shape[-1]
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    outs = (new(T, B, H), new(T, B, H))
    if train:
        outs += (new(T, B, 4 * H),) + ((new(T, B, H), new(T, B, H)) if x is not None else ())
    z, hp, cp = (list(outs[2:]) + [None] * 3)[:3]
    plan = card_plan(B, IN, H, dev)
    if fwd_smem_bytes(plan["nu"], plan["rt"], plan["kx"], plan["kh"], False) > _SMEM_LIMIT:
        raise ValueError(f"the LSTM forward kernel does not take IN={IN}, H={H}")
    # the groups' barrier counters, held by name until the launch is queued
    bar = torch.zeros(plan["groups"], dtype=torch.int32, device=dev)
    err = _kernels().cvl_lstm_seq_fwd(
        _ptr(x), _ptr(xz), _ptr(w), _ptr(b), rk.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), _ptr(z), _ptr(hp), _ptr(cp), _ptr(bar), T, B,
        IN, H, plan["nu"], plan["NB"], plan["rpg"], plan["groups"], plan["kx"], plan["kh"],
        int(plan["resident"]), plan["rt"], int(train),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, what)
    return outs


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tc_steps(lib, xz, rk, h0, c0, train: bool, proj: bool):
    """The bf16 forward's T step launches on xz ``[T, B, 4H]`` bf16: (h, c)
    and, training, z (and at the proj rungs h_prev and c_prev)."""
    T, B, H4 = xz.shape
    H, dev = H4 // 4, xz.device
    new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
    outs = (new(T, B, H), new(T, B, H))
    if train:
        outs += (new(T, B, H4, dtype=torch.bfloat16),)
        if proj:
            outs += (new(T, B, H, dtype=torch.bfloat16), new(T, B, H))
    z, hp, cp = (list(outs[2:]) + [None] * 3)[:3]
    Hp = round8(H)
    # held by names until the launches are queued: a temporary would go back
    # to the allocator before the call, and its memory to the next tensor
    rk_il, hb = interleave_gates(rk).contiguous(), tc_h_operand(h0, Hp)
    err = lib.cvl_lstm_tc_steps(xz.data_ptr(), rk_il.data_ptr(), hb.data_ptr(), c0.data_ptr(),
                                outs[0].data_ptr(), outs[1].data_ptr(), _ptr(z), _ptr(hp),
                                _ptr(cp), T, B, H, Hp, torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(err, "bf16 forward step")
    return outs


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
    if bf16:
        lib = _tc_kernels()
        with torch.cuda.device(dev):
            xp, wp = tc_fwd_operands(x, w)
            xz = torch.empty((T, B, H4), dtype=torch.bfloat16, device=dev)
            _raise_if(lib.cvl_lstm_tc_proj(xp.data_ptr(), wp.data_ptr(), b.data_ptr(),
                                           xz.data_ptr(), T * B, xp.shape[1], H,
                                           torch.cuda.current_stream(dev).cuda_stream),
                      "bf16 projection")
            outs = _tc_steps(lib, xz, rk, h0, c0, train, proj=True)
        _count("train_fwd" if train else "fwd", 1, bf16)
        return outs
    with torch.cuda.device(dev):
        outs = _f32_fwd(x, None, w, b, rk, h0, c0, train,
                        "training forward" if train else "forward")
    _count("train_fwd" if train else "fwd", 1, bf16)
    return outs


def lstm_seq_fwd(x, w, b, rk, h0, c0):
    """The inference forward (signature and results of
    :func:`lstm_seq_fwd_plain`). CUDA tensors launch, in f32,
    ``lstm_fwd_kernel`` on the current stream, and where x is bf16 the
    tensor-core route of ``csrc/lstm_seq_tc.cu`` (one projection launch,
    then one launch per time step: T+1 device launches, counted as one
    call), or raise; CPU tensors take the plain version."""
    if _device_of(x).type == "cpu":
        return lstm_seq_fwd_plain(x, w, b, rk, h0, c0)
    return _launch_fwd(x, w, b, rk, h0, c0, train=False)


def lstm_seq_train_fwd(x, w, b, rk, h0, c0):
    """The training forward (signature and results of
    :func:`lstm_seq_train_fwd_plain`). CUDA tensors launch
    ``lstm_fwd_kernel`` with its training outputs, or in bf16 the
    tensor-core route (T+1 device launches), or raise; CPU tensors take the
    plain version."""
    if _device_of(x).type == "cpu":
        return lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    return _launch_fwd(x, w, b, rk, h0, c0, train=True)


def lstm_seq_bwd(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t):
    """The backward (signature and results of :func:`lstm_seq_bwd_plain`).

    CUDA tensors launch, in f32, ``csrc/lstm_bwd_f32.cu``: the reverse walk
    over the whole batch (T + 1 launches of ``lstm_bwd_walk_kernel``, which
    write dz per step to scratch), then ``lstm_bwd_dx_kernel`` and
    ``wgrad_kernel<lstm_bwd_wgrad>`` (dRk, dW and db over all T*B rows, in a
    fixed order) — Rk and W read as stored, so ``rk_t`` and ``w_t`` that are
    transposed views of them (as :class:`LstmSeqCore` passes them) are not
    copied; where z is bf16, the tensor-core walk of ``csrc/lstm_seq_tc.cu``
    (two launches a step), its dRk product and the dW / db pass (2T+2 device
    launches); either counted as two; or raise. CPU tensors take the plain
    version."""
    args = (z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t)
    dev = _device_of(z)
    if dev.type == "cpu":
        return lstm_seq_bwd_plain(*args)
    if z.dim() != 3 or x.dim() != 3 or rk_t.dim() != 2 or w_t.dim() != 2:
        raise ValueError("z must be [T, B, 4H], x [T, B, IN], rk_t [4H, H] and w_t [4H, IN]")
    T, B, H4 = z.shape
    H, IN = H4 // 4, x.shape[-1]
    bf16 = z.dtype == torch.bfloat16
    s3 = lambda width: (T, B, width)
    if bf16:  # the tensor-core walk reads the rows of Rkᵀ and Wᵀ
        rk_t, w_t = rk_t.contiguous(), w_t.contiguous()
        weights = {"rk_t": (rk_t, (H4, H)), "w_t": (w_t, (H4, IN))}
    else:  # the FFMA kernels read Rk [H, 4H] and W [IN, 4H]
        rk, w = rk_t.T.contiguous(), w_t.T.contiguous()
        weights = {"rk": (rk, (H, H4)), "w": (w, (IN, H4))}
    _check(dev, {"z": (z, s3(H4)), "c_prev": (c_prev, s3(H)), "c": (c, s3(H)),
                 "h_prev": (h_prev, s3(H)), "x": (x, s3(IN)), "dh_seq": (dh_seq, s3(H)),
                 "dc_seq": (dc_seq, s3(H)), **weights},
           bf16=frozenset({"z", "h_prev", "x", "rk_t"}) if bf16 else frozenset())
    stream = torch.cuda.current_stream(dev).cuda_stream
    sd = torch.bfloat16 if bf16 else torch.float32
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        dx, drk, dw, db = new(T, B, IN, dtype=sd), new(H, H4, dtype=sd), new(IN, H4), new(H4)
        if bf16:
            lib = _tc_kernels()
            wt, xs = tc_walk_weights(rk_t, w_t.to(torch.bfloat16))
            dh0, dc0 = torch.zeros((B, H), device=dev), torch.zeros((B, H), device=dev)
            dz, dzb = new(T, B, H4), new(T, B, H4, dtype=torch.bfloat16)
            _raise_if(lib.cvl_lstm_tc_walk(
                *(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, wt)), wt.shape[1], xs,
                *(t.data_ptr() for t in (dx, dh0, dc0, dz, dzb)), T, B, IN, H, stream),
                "bf16 backward walk")
            _count("bwd", 1, bf16)
            _raise_if(lib.cvl_lstm_tc_drk(h_prev.data_ptr(), dzb.data_ptr(), drk.data_ptr(),
                                          T * B, H, 1, stream), "bf16 dRk")
            _raise_if(lib.cvl_lstm_tc_dw_db(x.data_ptr(), dz.data_ptr(), dw.data_ptr(),
                                            db.data_ptr(), T * B, IN, H, stream),
                      "bf16 weight-gradient")
        else:
            lib = _bwd_kernels()
            z, rk, w = _aligned(z), _aligned(rk), _aligned(w)
            dh0, dc0 = new(B, H), torch.zeros((B, H), device=dev)
            # dz of every step (the walk's operand), the bias partial sums,
            # the row segments of the weight-gradient sums
            dz = new(T, B, H4)
            part = new(lib.cvl_lstm_bwd_f32_part_rows(T, B), H4)
            scratch = new(lib.cvl_lstm_bwd_f32_scratch(T, B, IN, H))
            _raise_if(lib.cvl_lstm_bwd_f32(
                *(t.data_ptr() for t in (z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk, w, dx, dh0,
                                         dc0, drk, dw, db, dz, part, scratch)),
                T, B, IN, H, stream), "backward")
            _count("bwd", 1, bf16)
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
    if bf16:
        with torch.cuda.device(dev):
            outs = _tc_steps(_tc_kernels(), xz, rk, h0, c0, train, proj=False)
        _count("xz_train_fwd" if train else "xz_fwd", 1, bf16)
        return outs
    with torch.cuda.device(dev):
        outs = _f32_fwd(None, xz, None, None, rk, h0, c0, train,
                        f"unfused {'training forward' if train else 'forward'}")
    _count("xz_train_fwd" if train else "xz_fwd", 1, bf16)
    return outs


def lstm_seq_xz_fwd(xz, rk, h0, c0):
    """The unfused inference forward (signature and results of
    :func:`lstm_seq_xz_fwd_plain`). CUDA tensors launch
    ``lstm_fwd_kernel`` in its xz mode, or where xz is bf16 the
    tensor-core steps of ``csrc/lstm_seq_tc.cu`` (T device launches, counted
    as one call), or raise; CPU tensors take the plain version."""
    if _device_of(xz).type == "cpu":
        return lstm_seq_xz_fwd_plain(xz, rk, h0, c0)
    return _launch_xz_fwd(xz, rk, h0, c0, train=False)


def lstm_seq_xz_train_fwd(xz, rk, h0, c0):
    """The unfused training forward (signature and results of
    :func:`lstm_seq_xz_train_fwd_plain`). CUDA tensors launch
    ``lstm_fwd_kernel`` in its xz mode with z as output, or in bf16 the
    tensor-core steps (T device launches), or raise; CPU tensors take the
    plain version."""
    if _device_of(xz).type == "cpu":
        return lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0)
    return _launch_xz_fwd(xz, rk, h0, c0, train=True)


def _launch_walk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """Check the walk's inputs (h_prev may be None) and launch it; returns
    (dz, dh0, dc0). Counts nothing: the caller's wrapper does. ``rk_t`` may
    be the transposed view of Rk (as :class:`LstmSeqCore` passes it): the
    f32 walk reads Rk ``[H, 4H]`` as stored, so that view is not copied; the
    bf16 walk reads the rows of Rkᵀ and makes them contiguous itself."""
    dev = z.device
    if z.dim() != 3 or rk_t.dim() != 2:
        raise ValueError("z must be [T, B, 4H] and rk_t [4H, H]")
    T, B, H4 = z.shape
    H = H4 // 4
    bf16 = z.dtype == torch.bfloat16
    s3 = lambda width: (T, B, width)
    if bf16:
        rk_t = rk_t.contiguous()
        weight = {"rk_t": (rk_t, (H4, H))}
    else:
        rk = rk_t.T.contiguous()
        weight = {"rk": (rk, (H, H4))}
    _check(dev, {"z": (z, s3(H4)), "c_prev": (c_prev, s3(H)), "c": (c, s3(H)),
                 "h_prev": (h_prev, s3(H)), "dh_seq": (dh_seq, s3(H)), "dc_seq": (dc_seq, s3(H)),
                 **weight},
           bf16=frozenset({"z", "h_prev", "rk_t"}) if bf16 else frozenset())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        dz = torch.empty((T, B, H4), dtype=z.dtype, device=dev)
        dh0, dc0 = torch.zeros((B, H), device=dev), torch.zeros((B, H), device=dev)
        if bf16:
            wt, _ = tc_walk_weights(rk_t)
            err = _tc_kernels().cvl_lstm_tc_walk(
                *(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, wt)), wt.shape[1], H,
                None, dh0.data_ptr(), dc0.data_ptr(), None, dz.data_ptr(), T, B, 0, H, stream)
        else:
            z, rk = _aligned(z), _aligned(rk)
            err = _bwd_kernels().cvl_lstm_bwd_f32_walk(
                *(t.data_ptr() for t in (z, c_prev, c, dh_seq, dc_seq, rk, dz, dh0, dc0)),
                T, B, H, stream)
    _raise_if(err, "walk")
    return dz, dh0, dc0


def lstm_seq_walk(z, c_prev, c, dh_seq, dc_seq, rk_t):
    """The dz-only walk (signature and results of
    :func:`lstm_seq_walk_plain`). CUDA tensors launch, in f32, the full
    backward's walk of ``csrc/lstm_bwd_f32.cu`` (T + 1 launches of
    ``lstm_bwd_walk_kernel``), or where z is bf16 the tensor-core walk of
    ``csrc/lstm_seq_tc.cu`` (two launches a step), either counted as one
    call, or raise; CPU tensors take the plain version."""
    if _device_of(z).type == "cpu":
        return lstm_seq_walk_plain(z, c_prev, c, dh_seq, dc_seq, rk_t)
    out = _launch_walk(z, c_prev, c, None, dh_seq, dc_seq, rk_t)
    _count("walk", 1, z.dtype == torch.bfloat16)
    return out


def lstm_seq_walk_drk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    """The drk walk (signature and results of
    :func:`lstm_seq_walk_drk_plain`). CUDA tensors launch the walk and then,
    in f32, ``wgrad_kernel<lstm_bwd_wgrad>``'s row-split sum (two launches),
    dRk over all T*B rows in a fixed order, in bf16 the tensor-core dRk
    product (counted as two calls), or raise; CPU tensors take the plain
    version."""
    if _device_of(z).type == "cpu":
        return lstm_seq_walk_drk_plain(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t)
    dz, dh0, dc0 = _launch_walk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t)
    bf16 = z.dtype == torch.bfloat16
    _count("drk", 1, bf16)
    dev = z.device
    T, B, H4 = z.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        drk = torch.empty((H4 // 4, H4), dtype=torch.float32, device=dev)
        if bf16:
            err = _tc_kernels().cvl_lstm_tc_drk(h_prev.data_ptr(), dz.data_ptr(),
                                                drk.data_ptr(), T * B, H4 // 4, 0, stream)
        else:
            lib = _bwd_kernels()
            scratch = torch.empty(lib.cvl_lstm_bwd_f32_drk_scratch(T * B, H4 // 4), device=dev)
            err = lib.cvl_lstm_bwd_f32_drk(h_prev.data_ptr(), dz.data_ptr(), drk.data_ptr(),
                                           scratch.data_ptr(), T * B, H4 // 4, stream)
    _raise_if(err, "dRk")
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
        dh, dc = dh.contiguous(), dc.contiguous()
        if full:  # views: the f32 kernels read rk and w as stored: the f32 kernels read rk and w as stored
            dx, dh0, dc0, drk_g, dw, db = lstm_seq_bwd(z, cp, c, hp, x, dh, dc, rk.T, w.T)
            return dx, dw, db, drk_g, dh0, dc0, None, None
        dz, dh0, dc0, drk_g = _walk_and_drk(drk, z, cp, c, hp, dh, dc, rk.T)
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
                                            dc.contiguous(), rk.T)
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
