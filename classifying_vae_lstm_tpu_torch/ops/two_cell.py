"""Two-cell (encoder + decoder) cl_vrnn training core: CUDA wrappers, plain
versions and the autograd function.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_two_cell.py``. The
whole recurrent core of the cl_vrnn model — encoder LSTM, z heads, z sample,
decoder LSTM — runs forward in one kernel (``csrc/two_cell.cu``: the
operands' layouts, then the TPU grid's skewed walk, a product over the whole
batch per step) and backward in one kernel of two calls
(``csrc/two_cell_tc.cu``: the reverse walk, a product over the whole batch
per step, then the gradient products). Each has a plain PyTorch version with the
same signature, written out step by step: :func:`two_cell_fwd_plain`, and
:func:`two_cell_bwd_plain`, which mirrors the TPU backward kernel (it is not
autograd of the plain forward), so the backward kernel can be held against
it on identical residuals.

Layouts are time-major, as in the TPU kernels: xe ``[T, B, INe]`` (x ‖ w),
xd ``[T, B, INd]`` ([x_prev ‖] w), eps ``[T, B, L]``; kernels ``[in, out]``;
the z heads packed to ``wz [H, 2L]`` / ``bz [2L]`` (no lane padding).

Every function has a bf16 stream mode, the Pallas kernels'
``compute_dtype=bf16``, chosen by the type of xe (of ze in the backward):
xe, xd and the six weight matrices (we, rke, wdx, rkd, kz, wz) are bf16, as
``two_cell_sequence`` casts them outside its custom vjp; eps, the biases and
the initial states stay f32. Products take bf16-rounded operands and sum in
f32 (the plain versions: ``a.bfloat16().float()`` operands of f32 matmuls,
since a CPU bf16 matmul would round its output). Rounding happens where the
Pallas bodies round: h and z as operands; ze, zd, hpe, he and hpd as they
are stored (the backward's gates read the stored ze/zd), hd, zargs and the
c streams not at all; in the backward dz_e, dz_d and dzargs as operands,
dxe and dxd as stored, and the six weight gradients once, after their f32
sums (``_core_bwd``'s casts); the bias gradients sum the unrounded dz.

:func:`two_cell_fwd` / :func:`two_cell_bwd` launch the kernels for CUDA
tensors (or raise: there is no fallback) and take the plain versions only
for CPU tensors. :func:`two_cell_sequence` is the model's entry; it packs
the weights and inputs outside the autograd function, so autograd routes
the cotangents of W and of the parameters back through the packing.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._checks import _check, _device_of
from .lstm import _gate_grads, _gates, bf16_operand

# launches since the counts were last set to 0: one per forward call, two per
# backward call (the reverse walk, 2T + 1 device launches, then the gradient
# products); the plain names count the f32 mode, the BF16_ names the bf16
# stream mode
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

_SMEM_LIMIT = 232448     # dynamic shared memory one Hopper block can use
# the bf16 stream mode's bf16 inputs of each kernel (the others are f32)
BF16_FWD_INPUTS = frozenset({"xe", "xd", "we", "rke", "wdx", "rkd", "kz", "wz"})
BF16_BWD_INPUTS = BF16_FWD_INPUTS | {"ze", "zd", "hpe", "he", "hpd"}


def fwd_smem_bytes(L: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one block of the forward's step kernel
    (``csrc/two_cell.cu``): the mainloop's ring, or after it the staged f32
    tile and the epilogue's op(h) of half the tile's rows and units, op(z)
    of half its rows, the tile's rows of Wz and columns of Kz, whichever is
    larger. The state lives in global memory: the hidden and input widths
    do not enter."""
    if bf16:  # 64 x 128 tiles: the ring, or the tile [64][132] + [32][32] + [32][L] + ...
        return max(46080, (64 * 132 + 32 * 32 + 32 * L + 32 * 2 * L + 128 * L) * 4)
    return max(27648, (32 * 36 + 16 * 8 + 16 * L + 8 * 2 * L + 32 * L) * 4)  # 32 x 32 FFMA


def fits(cfg) -> bool:
    """Does a block of the forward's step kernel fit Hopper's shared
    memory? Its state lives in global memory, so this holds at every
    hidden width (it is the latent width L that enters, through the
    epilogue's op(z))."""
    bf16 = bool(getattr(cfg, "bf16_compute", False))
    return fwd_smem_bytes(cfg.latent_dim, bf16) <= _SMEM_LIMIT


# The widest H at which the two-cell route takes a bf16 config: an H100
# (700 W), a training step (loss and backward) at B=1,024, D=88, L=2, T=16,
# tools/torch_two_cell_gate.py, with the forward of csrc/two_cell.cu over
# the whole batch on the tensor cores: two-cell faster at every H measured,
# 88 to 2,048 (1.24-2.19x; with the earlier 4-row FFMA forward the two-loop
# route won from H=768). The bound is the widest H measured. In f32 (B=200,
# L=8) the two-cell route was faster at every H measured, 88 to 2,048
# (1.11-3.22x).
BF16_TWO_CELL_MAX_H = 2048


def should_use(cfg, two_cell=None) -> bool:
    """Route ``lstm_backend='pallas'`` through the two-cell kernel?

    An explicit ``two_cell`` (or ``cfg.two_cell``) decides. Unset, the port
    takes the kernel where it accepts the config (no dropout, no remat, a
    forward block fits shared memory: :func:`fits`) and the H100 measurement
    above says it is the faster route: always in f32, up to
    ``BF16_TWO_CELL_MAX_H`` in the bf16 stream mode. The JAX package's gate
    (256 <= H < 1024, VMEM residency) is a TPU measurement and is not read
    here. ``two_cell=False`` sends ``pallas`` to the two-loop path, whose
    LSTMs run the whole-sequence kernels of ``ops/lstm_seq.py``."""
    if two_cell is None:
        two_cell = getattr(cfg, "two_cell", None)
    if two_cell is not None:
        return bool(two_cell)
    if getattr(cfg, "bf16_compute", False) and cfg.intermediate_dim > BF16_TWO_CELL_MAX_H:
        return False
    return cfg.dropout == 0.0 and not cfg.remat and fits(cfg)


# ------------------------------------------------------------ plain versions


def _mode(t):
    """(is the call in the bf16 stream mode, the rounding of a product's
    operand): the mode follows the type of the input stream ``t`` (xe here,
    x in ``ops/lstm_seq.py``; ze and z in the backwards)."""
    bf16 = t.dtype == torch.bfloat16
    return bf16, (bf16_operand if bf16 else (lambda a: a))


def two_cell_fwd_plain(xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d):
    """The forward kernel's function in torch ops.

    Returns ``(hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd)``, all
    ``[T, B, ...]``: the decoder's h, the packed z heads, both cells'
    pre-activations, and h / c before and after each cell (the backward's
    residuals). In the bf16 mode ze, zd, hpe, he and hpd come back as bf16,
    the rest as f32."""
    T = xe.shape[0]
    H, L = rke.shape[0], kz.shape[0]
    bf16, op = _mode(xe)
    xe, xd, we, rke, wdx, rkd, kz, wz = (a.float() for a in (xe, xd, we, rke, wdx, rkd, kz, wz))
    h_e, c_e, h_d, c_d = h0e, c0e, h0d, c0d
    outs = [[] for _ in range(11)]
    for t in range(T):
        hpe, cpe = op(h_e), c_e
        ze = xe[t] @ we + be + hpe @ rke
        h_e, c_e = _gates(ze, c_e, H)
        he = op(h_e)
        zargs = he @ wz + bz
        z = zargs[:, :L] + torch.exp(zargs[:, L:] / 2) * eps[t]
        hpd, cpd = op(h_d), c_d
        zd = xd[t] @ wdx + bd + op(z) @ kz + hpd @ rkd
        h_d, c_d = _gates(zd, c_d, H)
        for acc, v in zip(outs, (h_d, zargs, ze, zd, hpe, cpe, c_e, he, hpd, cpd, c_d)):
            acc.append(v)
    outs = [torch.stack(o) for o in outs]
    if bf16:
        for i in (2, 3, 4, 7, 8):  # ze, zd, hpe, he, hpd
            outs[i] = outs[i].bfloat16()
    return tuple(outs)


def two_cell_bwd_plain(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dzargs,
                       we, rke, wdx, rkd, kz, wz):
    """The backward kernel's function in torch ops, step by step.

    Walks time in reverse: decoder step t (its dh is the carry plus
    ``dhd[t]``; z-sample and z-head backward), then encoder step t (its dh
    is the carry plus the z heads' cotangent from decoder step t — the TPU
    kernel's ``dhez`` hand-off). Weight gradients accumulate step by step.
    Returns ``(dxe, dxd, dh0e, dc0e, dh0d, dc0d, drke, drkd, dwe, dwdx, dkz,
    dwz, dbe, dbd, dbz)``, the order of ``pallas_two_cell._bwd_call``. In the
    bf16 mode dxe, dxd and the six weight gradients come back as bf16."""
    T, B, H4 = ze.shape
    H, L = H4 // 4, kz.shape[0]
    bf16, op = _mode(ze)
    (ze, zd, hpe, he, hpd, xe, xd, we, rke, wdx, rkd, kz, wz) = (
        a.float() for a in (ze, zd, hpe, he, hpd, xe, xd, we, rke, wdx, rkd, kz, wz))
    zeros = lambda *s: cpe.new_zeros(s)
    dh_e, dc_e, dh_d, dc_d = (zeros(B, H) for _ in range(4))
    drke, drkd, dwe, dwdx, dkz, dwz = (torch.zeros_like(w) for w in (rke, rkd, we, wdx, kz, wz))
    dbe, dbd, dbz = zeros(H4), zeros(H4), zeros(2 * L)
    dxe, dxd = torch.zeros_like(xe), torch.zeros_like(xd)
    for t in reversed(range(T)):
        dz_d, dc_d = _gate_grads(zd[t], cd[t], cpd[t], dh_d + dhd[t], dc_d)
        dzo = op(dz_d)
        dh_d = dzo @ rkd.T
        dxd[t] = dzo @ wdx.T
        drkd += hpd[t].T @ dzo
        dwdx += xd[t].T @ dzo
        dbd += dz_d.sum(0)
        sig = torch.exp(zargs[t][:, L:] / 2)
        dz = dzo @ kz.T
        dza = torch.cat([dz + dzargs[t][:, :L], dz * eps[t] * sig * 0.5 + dzargs[t][:, L:]], -1)
        z = zargs[t][:, :L] + sig * eps[t]
        dkz += op(z).T @ dzo
        dzao = op(dza)
        dwz += he[t].T @ dzao
        dbz += dza.sum(0)
        dhez = dzao @ wz.T
        dz_e, dc_e = _gate_grads(ze[t], ce[t], cpe[t], dh_e + dhez, dc_e)
        dzo = op(dz_e)
        dh_e = dzo @ rke.T
        dxe[t] = dzo @ we.T
        drke += hpe[t].T @ dzo
        dwe += xe[t].T @ dzo
        dbe += dz_e.sum(0)
    if bf16:
        dxe, dxd, drke, drkd, dwe, dwdx, dkz, dwz = (
            a.bfloat16() for a in (dxe, dxd, drke, drkd, dwe, dwdx, dkz, dwz))
    return (dxe, dxd, dh_e, dc_e, dh_d, dc_d, drke, drkd, dwe, dwdx, dkz, dwz, dbe, dbd, dbz)


# ------------------------------------------------------------ the forward's layouts


def round8(n: int) -> int:
    """n rounded up to a multiple of 8 (16 bytes of bf16, two FFMA loads)."""
    return -(-n // 8) * 8


def fwd_tiles(H: int, bf16: bool) -> int:
    """Column tiles of a step's product: 4H interleaved columns in tiles of
    128 (bf16) or 32 (f32), BN / 4 units each."""
    return -(-4 * H // (128 if bf16 else 32))


def gate_rows_t(w, width: int):
    """Wᵀ ``[4H, width]`` of a gate-ordered weight ``w [K, 4H]``: row
    ``4u + g`` holds column ``g*H + u`` of w, K padded by zero columns to
    ``width``. The step products read a weight so."""
    K, H4 = w.shape
    out = w.new_zeros((H4, width))
    out[:, :K] = w.reshape(K, 4, H4 // 4).permute(2, 1, 0).reshape(H4, K)
    return out


def fwd_operands(xe, xd, we, rke, wdx, rkd, kz, h0e, h0d) -> dict:
    """The forward kernel's operands, as its first launch
    (``two_cell_layout_kernel`` of ``csrc/two_cell.cu``) lays them out in
    its scratch; the CPU tests read this definition. The x streams
    as ``[T*B, INp]`` rows (INp = round8(IN), zero pad columns), the weights
    as :func:`gate_rows_t` (We, Wdx to INp; Rk_e, Rk_d to Hp = round8(H)),
    Kz gate-interleaved (``ops/lstm_seq.py``'s ``interleave_gates``), and
    the h operands ``[2, B, Hp]`` of
    the stream type with h0 in buffer 0 (rounded to bf16 in the bf16 mode:
    h as an operand), zeros elsewhere."""
    from .lstm_seq import interleave_gates  # lstm_seq imports this module

    T, B, in_e = xe.shape
    in_d, H = xd.shape[-1], rke.shape[0]
    Hp = round8(H)
    rows = lambda x: torch.nn.functional.pad(
        x.reshape(T * B, x.shape[-1]), (0, round8(x.shape[-1]) - x.shape[-1])).contiguous()

    def hb(h0):
        buf = torch.zeros((2, B, Hp), dtype=xe.dtype, device=xe.device)
        buf[0, :, :H] = h0
        return buf

    return {"xe": rows(xe), "xd": rows(xd), "wet": gate_rows_t(we, round8(in_e)),
            "rket": gate_rows_t(rke, Hp), "wdxt": gate_rows_t(wdx, round8(in_d)),
            "rkdt": gate_rows_t(rkd, Hp), "kz": interleave_gates(kz).contiguous(),
            "hbe": hb(h0e), "hbd": hb(h0d)}


# ------------------------------------------------------------ CUDA wrappers

_lib_lock = threading.Lock()
_lib = None
_bwd_lib = None


def _kernels():
    """The built forward library (``csrc/two_cell.cu``) with its ctypes
    signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("two_cell")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cvl_two_cell_fwd_smem_bytes.argtypes = [I, I]
            lib.cvl_two_cell_fwd_smem_bytes.restype = LL
            lib.cvl_two_cell_fwd_tiles.argtypes = [I, I]
            lib.cvl_two_cell_fwd_tiles.restype = I
            for L, b in ((2, 1), (8, 0), (70, 1), (400, 0)):
                if lib.cvl_two_cell_fwd_smem_bytes(L, b) != fwd_smem_bytes(L, bool(b)):
                    raise RuntimeError("shared-memory layout of csrc/two_cell.cu differs from "
                                       f"fwd_smem_bytes at L={L}, bf16={b}")
            for H, b in ((256, 0), (512, 1), (20, 0), (20, 1)):
                if lib.cvl_two_cell_fwd_tiles(H, b) != fwd_tiles(H, bool(b)):
                    raise RuntimeError(f"column tiles of csrc/two_cell.cu differ at H={H}")
            lib.cvl_two_cell_fwd_scratch_bytes.argtypes = [I] * 7
            lib.cvl_two_cell_fwd_scratch_bytes.restype = LL
            for fn in (lib.cvl_two_cell_fwd, lib.cvl_two_cell_fwd_bf16):
                fn.argtypes = [P] * 28 + [I] * 6 + [P]
                fn.restype = I
            _lib = lib
        return _lib


def _bwd_kernels():
    """The built backward library (``csrc/two_cell_tc.cu``) with its ctypes
    signatures."""
    global _bwd_lib
    with _lib_lock:
        if _bwd_lib is None:
            lib = _build.load("two_cell_tc")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cvl_two_cell_part_count.argtypes = [I, I, I]
            lib.cvl_two_cell_part_count.restype = I
            lib.cvl_two_cell_grads_scratch.argtypes = [I] * 7
            lib.cvl_two_cell_grads_scratch.restype = LL
            for sfx in ("", "_bf16"):
                walk, grads = (getattr(lib, f"cvl_two_cell_{n}{sfx}") for n in ("walk", "grads"))
                walk.argtypes = [P] * 24 + [I] * 4 + [P]
                grads.argtypes = [P] * 25 + [I] * 6 + [P]
                walk.restype = grads.restype = I
            _bwd_lib = lib
        return _bwd_lib


def _count(which: str, n: int, bf16: bool):
    global FWD_LAUNCHES, BWD_LAUNCHES, BF16_FWD_LAUNCHES, BF16_BWD_LAUNCHES
    with _launch_lock:
        if which == "fwd" and bf16:
            BF16_FWD_LAUNCHES += n
        elif which == "fwd":
            FWD_LAUNCHES += n
        elif bf16:
            BF16_BWD_LAUNCHES += n
        else:
            BWD_LAUNCHES += n


def two_cell_fwd(xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d):
    """The forward kernel (signature and results of :func:`two_cell_fwd_plain`).

    CUDA tensors launch ``csrc/two_cell.cu`` on the current stream (or
    raise), in the bf16 stream mode where xe is bf16: the operands' layouts
    (one launch: :func:`fwd_operands` on the card), then T + 1 step
    launches, launch t running encoder step t and decoder step t - 1 over
    the whole batch. CPU tensors take the plain version."""
    args = (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d)
    dev = _device_of(xe)
    if dev.type == "cpu":
        return two_cell_fwd_plain(*args)
    if xe.dim() != 3 or rke.dim() != 2:
        raise ValueError("xe must be [T, B, INe] and rke [H, 4H]")
    T, B, in_e = xe.shape
    H, L, in_d = rke.shape[0], kz.shape[0], xd.shape[-1]
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"need T, B, H >= 1 (got {T}, {B}, {H})")
    H4 = 4 * H
    bf16 = xe.dtype == torch.bfloat16
    _check(dev, {"xe": (xe, (T, B, in_e)), "xd": (xd, (T, B, in_d)), "eps": (eps, (T, B, L)),
                 "we": (we, (in_e, H4)), "be": (be, (H4,)), "rke": (rke, (H, H4)),
                 "wdx": (wdx, (in_d, H4)), "bd": (bd, (H4,)), "rkd": (rkd, (H, H4)),
                 "kz": (kz, (L, H4)), "wz": (wz, (H, 2 * L)), "bz": (bz, (2 * L,)),
                 "h0e": (h0e, (B, H)), "c0e": (c0e, (B, H)), "h0d": (h0d, (B, H)),
                 "c0d": (c0d, (B, H))},
           bf16=BF16_FWD_INPUTS if bf16 else frozenset())
    if fwd_smem_bytes(L, bf16) > _SMEM_LIMIT:
        raise ValueError(f"latent width {L} is too wide for the two-cell forward's shared memory")
    lib = _kernels()
    sd = torch.bfloat16 if bf16 else torch.float32
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        # the laid-out operands (fwd_operands) and the z heads' partial sums:
        # one scratch buffer
        scratch = new(lib.cvl_two_cell_fwd_scratch_bytes(T, B, in_e, in_d, H, L, int(bf16)),
                      dtype=torch.uint8)
        # hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd
        outs = (new(T, B, H), new(T, B, 2 * L), new(T, B, H4, dtype=sd), new(T, B, H4, dtype=sd),
                new(T, B, H, dtype=sd), new(T, B, H), new(T, B, H), new(T, B, H, dtype=sd),
                new(T, B, H, dtype=sd), new(T, B, H), new(T, B, H))
        launch = lib.cvl_two_cell_fwd_bf16 if bf16 else lib.cvl_two_cell_fwd
        err = launch(*(t.data_ptr() for t in (*args, scratch, *outs)), T, B, in_e, in_d, H, L,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"two_cell forward kernel launch failed: CUDA error {err}")
    _count("fwd", 1, bf16)
    return outs


def two_cell_bwd(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dzargs,
                 we, rke, wdx, rkd, kz, wz):
    """The backward kernel (signature and results of :func:`two_cell_bwd_plain`).

    CUDA tensors launch ``csrc/two_cell_tc.cu`` on the current stream (or
    raise), in the bf16 stream mode where ze is bf16: the reverse walk
    (per step one product launch over the whole batch, both cells, with the
    decoder's gates in its epilogue, and one z hand-off launch; it writes dz
    and z per step to scratch), then the gradient products (dx, the weight
    gradients, the bias sums from the walk's partial sums), every sum in a
    fixed order. CPU tensors take the plain version."""
    args = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dzargs,
            we, rke, wdx, rkd, kz, wz)
    dev = _device_of(ze)
    if dev.type == "cpu":
        return two_cell_bwd_plain(*args)
    T, B, H4 = ze.shape
    H, L = H4 // 4, kz.shape[0]
    in_e, in_d = xe.shape[-1], xd.shape[-1]
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"need T, B, H >= 1 (got {T}, {B}, {H})")
    s3 = lambda w: (T, B, w)
    bf16 = ze.dtype == torch.bfloat16
    _check(dev, {"ze": (ze, s3(H4)), "zd": (zd, s3(H4)), "cpe": (cpe, s3(H)), "ce": (ce, s3(H)),
                 "cpd": (cpd, s3(H)), "cd": (cd, s3(H)), "hpe": (hpe, s3(H)), "he": (he, s3(H)),
                 "hpd": (hpd, s3(H)), "eps": (eps, s3(L)), "zargs": (zargs, s3(2 * L)),
                 "xe": (xe, s3(in_e)), "xd": (xd, s3(in_d)), "dhd": (dhd, s3(H)),
                 "dzargs": (dzargs, s3(2 * L)), "we": (we, (in_e, H4)), "rke": (rke, (H, H4)),
                 "wdx": (wdx, (in_d, H4)), "rkd": (rkd, (H, H4)), "kz": (kz, (L, H4)),
                 "wz": (wz, (H, 2 * L))},
           bf16=BF16_BWD_INPUTS if bf16 else frozenset())
    lib = _bwd_kernels()
    sfx = "_bf16" if bf16 else ""
    sd = torch.bfloat16 if bf16 else torch.float32
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        new = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
        # dz of both cells as the products' operand, the z hand-off's dzargs
        # and z, the bias partial sums per (step, row tile); the carries
        dze, dzd = new(T, B, H4, dtype=sd), new(T, B, H4, dtype=sd)
        dza, zs = new(T, B, 2 * L), new(T, B, L)
        part_e = new(T * lib.cvl_two_cell_part_count(B, int(bf16), 0), H4)
        part_d = new(T * lib.cvl_two_cell_part_count(B, int(bf16), 1), H4)
        dh0e, dh0d = new(B, H), new(B, H)
        dc0e, dc0d = (torch.zeros((B, H), device=dev) for _ in range(2))
        ptrs = [t.data_ptr() for t in (ze, zd, cpe, ce, cpd, cd, eps, zargs, dhd, dzargs, rke,
                                       rkd, kz, wz, dze, dzd, dza, zs, part_e, part_d, dh0e,
                                       dc0e, dh0d, dc0d)]
        err = getattr(lib, f"cvl_two_cell_walk{sfx}")(*ptrs, T, B, H, L, stream)
        if err != 0:
            raise RuntimeError(f"two_cell backward walk launch failed: CUDA error {err}")
        _count("bwd", 1, bf16)
        # dxe, dxd; drke, dwe, dbe, drkd, dwdx, dkz, dbd, dwz, dbz
        dxe, dxd = new(T, B, in_e, dtype=sd), new(T, B, in_d, dtype=sd)
        wgrads = (new(H, H4, dtype=sd), new(in_e, H4, dtype=sd), new(H4), new(H, H4, dtype=sd),
                  new(in_d, H4, dtype=sd), new(L, H4, dtype=sd), new(H4),
                  new(H, 2 * L, dtype=sd), new(2 * L))
        # the segments of the weight-gradient sums; in the bf16 mode the
        # tensor-core dW products read x with rows padded to 16 bytes
        scratch = new(lib.cvl_two_cell_grads_scratch(T, B, in_e, in_d, H, L, int(bf16)))
        pad8 = lambda x: (torch.nn.functional.pad(x, (0, -x.shape[-1] % 8))
                          if bf16 and x.shape[-1] % 8 else x)
        xe_k, xd_k = pad8(xe), pad8(xd)
        ptrs = [t.data_ptr() for t in (dze, dzd, dza, zs, part_e, part_d, hpe, he, hpd, xe_k,
                                       xd_k, we, wdx, dxe, dxd, *wgrads, scratch)]
        err = getattr(lib, f"cvl_two_cell_grads{sfx}")(*ptrs, T, B, in_e, in_d, H, L, stream)
    if err != 0:
        raise RuntimeError(f"two_cell gradient products launch failed: CUDA error {err}")
    _count("bwd", 1, bf16)
    drke, dwe, dbe, drkd, dwdx, dkz, dbd, dwz, dbz = wgrads
    return (dxe, dxd, dh0e, dc0e, dh0d, dc0d, drke, drkd, dwe, dwdx, dkz, dwz, dbe, dbd, dbz)


# ------------------------------------------------------------ autograd


class TwoCellCore(torch.autograd.Function):
    """``_two_cell_core`` of the JAX package: forward and backward kernels
    (or their plain versions on the CPU) behind one autograd node.

    Inputs: xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e,
    h0d, c0d; outputs: hd ``[T, B, H]`` and zargs ``[T, B, 2L]``, both f32.
    eps gets no gradient. With the bf16 set of inputs (see the module's
    note) it runs the bf16 stream mode and returns bf16 gradients for xe,
    xd and the six weight matrices."""

    @staticmethod
    def forward(ctx, xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d):
        (hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd) = two_cell_fwd(
            xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d)
        ctx.save_for_backward(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd,
                              we, rke, wdx, rkd, kz, wz)
        return hd, zargs

    @staticmethod
    def backward(ctx, dhd, dzargs):
        res = ctx.saved_tensors
        (dxe, dxd, dh0e, dc0e, dh0d, dc0d, drke, drkd, dwe, dwdx, dkz, dwz, dbe, dbd,
         dbz) = two_cell_bwd(*res[:13], dhd.contiguous(), dzargs.contiguous(), *res[13:])
        return (dxe, dxd, None, dwe, dbe, drke, dwdx, dbd, drkd, dkz, dwz, dbz,
                dh0e, dc0e, dh0d, dc0d)


def pack_inputs(params, cfg, x, x_prev, W, eps, compute_dtype=None) -> tuple:
    """The core's 16 inputs from the model's parameters and a window batch:
    time-major streams xe = x ‖ w and xd = [x_prev ‖] w, the decoder kernel
    split into its x/w rows (``wdx``) and z rows (``kz``), the z heads packed
    side by side, zero initial states. Differentiable torch ops, so autograd
    routes the cotangents of W and of the parameters back through them.
    ``compute_dtype=torch.bfloat16`` casts xe, xd and the six weight
    matrices to bf16 here, outside the core, as ``two_cell_sequence`` does
    (their gradients come back bf16-valued, as f32); the biases and eps stay
    f32."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} (None, float32 or bfloat16)")
    sd = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    B, T, D = x.shape
    H, L, K = cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    enc, dec = params["encoder_h"], params["decoder_h"]
    w_rep = W[:, None, :].expand(B, T, K)
    n_xp = D if cfg.use_x_prev else 0
    xe = torch.cat([x, w_rep], dim=-1)
    if cfg.use_x_prev:
        xdc = torch.cat([x_prev, w_rep], dim=-1)
        wdx = torch.cat([dec["kernel"][:n_xp], dec["kernel"][n_xp + L:]], dim=0)
    else:
        xdc = w_rep
        wdx = dec["kernel"][n_xp + L:]
    kz = dec["kernel"][n_xp:n_xp + L]
    wz = torch.cat([params["Z_mean"]["kernel"], params["Z_log_var"]["kernel"]], dim=-1)
    bz = torch.cat([params["Z_mean"]["bias"], params["Z_log_var"]["bias"]])
    tm = lambda a: a.transpose(0, 1).to(sd).contiguous()
    w = lambda a: a.to(sd).contiguous()
    zeros = x.new_zeros((B, H))
    return (tm(xe), tm(xdc), eps.transpose(0, 1).contiguous(), w(enc["kernel"]),
            enc["bias"].contiguous(), w(enc["recurrent_kernel"]), w(wdx),
            dec["bias"].contiguous(), w(dec["recurrent_kernel"]), w(kz), w(wz),
            bz.contiguous(), zeros, zeros, zeros, zeros)


def two_cell_sequence(params, cfg, x, x_prev, W, eps, compute_dtype=None):
    """Fused encoder -> z -> decoder core over a window batch.

    Drop-in for the encode_z_sequence + sample + decode_sequence composition
    at ``dropout == 0``: x ``[B, T, D]``, x_prev ``[B, T, D]`` (with
    ``use_x_prev``), W ``[B, K]``, eps ``[B, T, L]``; returns ``(h_d_seq [B,
    T, H], Z_mean [B, T, L], Z_log_var [B, T, L], Z [B, T, L])``, all f32.
    The X head stays outside. ``compute_dtype=torch.bfloat16`` runs the bf16
    stream mode (:func:`pack_inputs` casts outside the core).
    """
    L = cfg.latent_dim
    hd, zargs = TwoCellCore.apply(*pack_inputs(params, cfg, x, x_prev, W, eps, compute_dtype))
    hd = hd.transpose(0, 1)
    zargs = zargs.transpose(0, 1)
    zm, zlv = zargs[..., :L], zargs[..., L:]
    return hd, zm, zlv, zm + torch.exp(zlv / 2) * eps
