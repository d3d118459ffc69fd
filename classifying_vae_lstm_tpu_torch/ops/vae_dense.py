"""cl_vae dense-stack training core: CUDA wrappers, plain versions and the
autograd function.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_vae.py``. The whole
cl_vae graph — key encoder, logistic-normal w sample, latent encoder, z
sample, decoder, frame head — runs forward in one launch and backward in one
launch (``csrc/vae_dense.cu``: the row pass, a grid barrier, then every
weight and bias gradient, in one cooperative grid). Both lay out a call by
:func:`plan`: the weights *resident* in each block's shared memory (bulk
copies, one mbarrier a weight) where they fit beside a tile of 4 rows,
else *streamed* through a ring of chunks. The bf16
mode of both is ``csrc/vae_dense_tc.cu``, the wide layers as tensor-core
products over the whole batch and the narrow ones in row kernels (the
forward 3 launches, counted as one; the backward 8, counted as two, 9 when
B > 128). Each has a plain PyTorch
version with the same signature: :func:`vae_dense_fwd_plain`, and
:func:`vae_dense_bwd_plain`, which mirrors the TPU backward kernel (it is not
autograd of the plain forward: it recomputes z and the exp factors from the
zargs / wargs residuals and takes the relu masks from the post-activations),
so the backward kernel can be held against it on identical residuals.

Both directions have a bf16 mode, the JAX kernels' ``compute_dtype=bf16``,
chosen by the operands' type: x, x_prev and every kernel (weight matrix)
bf16; the biases and the noise f32. Each product rounds its left operand to
bf16 where the TPU kernels' ``mm`` does and accumulates in f32; the
residuals a1, a2, a3 come out as f32 tensors holding bf16-rounded values;
the weight gradients are products of bf16-rounded operands, rounded and
returned as bf16; the bias gradients are f32 column sums of the unrounded
cotangents; dx and dx_prev are bf16. :func:`pack_inputs` casts under
``cfg.bf16_compute`` (differentiably, as JAX ``padm`` does), so autograd
hands the f32 parameters bf16-valued weight gradients, as JAX's does.

Layouts: rows ``[B, ...]``; kernels ``[in, out]``, read as stored in both
directions; the w heads packed to ``wwz [Cw, 2(K-1)]`` / ``bwz``, the z
heads to ``wzz [H, 2L]`` / ``bzz`` (no lane padding); the latent encoder's
kernel split into its x rows ``whx`` and w rows ``whw2``, the decoder's into
its w rows ``wdw``, x_prev rows ``wdxp`` (``None`` without ``use_x_prev``,
as is ``xp``) and z rows ``wdz``.

:func:`vae_dense_fwd` / :func:`vae_dense_bwd` launch the kernels for CUDA
tensors (or raise: there is no fallback) and take the plain versions only
for CPU tensors. In the f32 mode they check each call's devices, types,
shapes and layout once per signature (the tuple of every tensor's shape,
strides, type and device), allocate the outputs in one buffer, pass an
operand that does not start on 16 bytes as an aligned copy, and hand the
kernel one array of pointers. :func:`vae_apply_core` is the model's entry;
it packs the weights outside the autograd function, so autograd routes the
parameter cotangents back through the packing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch
from torch._utils import _unflatten_dense_tensors

from . import _build
from ._checks import _aligned, _check, _device_of

# launches since the counts were last set to 0: one per forward call; per
# backward call one in the f32 mode (the row pass and the weight gradients in
# one launch) and two in the bf16 mode (its 8 or 9 launches); the BF16_
# counts are the bf16-mode share of each
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

_SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block can use
# the JAX kernel's lane width: K and L up to it, so both packages route the
# same configs to their kernels
_MAX_WIDTH = 128
# the operands that are bf16 in the bf16 mode: x, x_prev and the kernels
_BF16_OPERANDS = frozenset({"x", "xp", "whw", "wwz", "whx", "whw2", "wzz", "wdw", "wdxp",
                            "wdz", "wxh"})

# csrc/vae_dense.cu's layout constants (checked against its plan at load)
_RES_THREADS = 512      # threads a block, resident layout
_STR_THREADS = 256      # threads a block, streamed layout
_BAR_BYTES = 128        # the mbarriers at the start of shared memory
_SLOT_MIN = 8448        # floats of a ring slot, at least
_STAGES = 3             # ring slots, at most
_WG_STAGE = 24576       # floats, at least, of the weight region (the weight gradients' staging)
_RES_ROWS = 4           # rows a block, resident layout


def _tile_bytes(D: int, Cw: int, H: int, L: int, K: int, use_xp: bool) -> int:
    """Shared memory of a 4-row tile of the first design's activations
    (forward: x, x_prev, a1, wargs, w, a2, zargs, z, a3; backward: each
    layer's cotangent): the width rule the kernels keep."""
    fwd = D * (1 + int(use_xp)) + Cw + 2 * (K - 1) + K + 2 * H + 3 * L
    bwd = 2 * D + 2 * H + K + 3 * L + 2 * (K - 1) + Cw
    return 16 * max(fwd, bwd)


class Plan(NamedTuple):
    """How a call is laid out on the card (``make_plan`` in
    ``csrc/vae_dense.cu`` is its mirror)."""
    resident: bool   # every weight resident in a block's shared memory; else streamed
    rows: int        # batch rows a block
    threads: int     # threads a block
    stages: int      # ring slots (streamed; 0 resident)
    slot: int        # floats a ring slot (streamed; 0 resident)
    tiles: int       # row tiles: the forward's blocks
    wg_tile: int     # the weight-gradient tile's width (32 at B <= 256, else 64)
    wg_tiles: int    # the backward's weight-gradient tiles
    wfloats: int     # floats of the weight region (the weights, or the ring)
    fwd_smem: int    # dynamic shared memory bytes of a forward block
    bwd_smem: int    # of a backward block
    scratch: int     # floats of the backward's scratch


def _up4(n: int) -> int:
    return (n + 3) & ~3


def _weight_shapes(D, Cw, H, L, K, use_xp):
    """[in, out] of the chain's weights in the forward's order: whw, wwz,
    whx, whw2, wzz, wdw, wdz, wdxp, wxh (wdxp absent without x_prev)."""
    return [(D, Cw), (Cw, 2 * (K - 1)), (D, H), (K, H), (H, 2 * L), (K, H), (L, H),
            (D if use_xp else 0, H), (H, D)]


def _wg_shapes(D, Cw, H, L, K, use_xp):
    """[M, N] of the backward's weight and bias gradients (M = 1: a bias)."""
    K2 = 2 * (K - 1)
    jobs = [(D, Cw), (1, Cw), (Cw, K2), (1, K2), (D, H), (K, H), (1, H), (H, 2 * L),
            (1, 2 * L), (K, H), (L, H), (1, H), (H, D), (1, D)]
    return jobs + [(D, H)] if use_xp else jobs


def _fwd_tiles(D, Cw, H, L, K, use_xp, R, T):
    """Floats of a forward block's row tiles: x, x_prev, a1, wargs, w, a2
    (a3 too), zargs, z, eps_w, eps_z, each [F][R] on 16 bytes; the split
    products' partial sums; the six biases."""
    t = lambda F: _up4(F * R)
    K1 = K - 1
    return (t(D) * (1 + int(use_xp)) + t(Cw) + t(2 * K1) + t(K) + t(H) + t(2 * L) + 2 * t(L)
            + t(K1) + T * R + _up4(Cw + 2 * K1 + 2 * H + 2 * L + D))


def _bwd_tiles(D, Cw, H, L, K, R, T):
    """Floats of a backward block's row tiles: dxh, dd (dh too), dwt, dz,
    dza, dxs, dwa, dhw, the staged w, wargs, eps_w, dwargs, zargs, eps_z,
    dzargs; the split products' partial sums; the relu masks of a3, a2, a1
    as bits."""
    t = lambda F: _up4(F * R)
    K1 = K - 1
    words = lambda F: -(-F // 32)
    return (2 * t(D) + t(H) + 2 * t(K) + 2 * t(L) + 3 * t(2 * L) + 3 * t(2 * K1) + t(Cw)
            + t(K1) + T * R + 2 * t(words(H)) + t(words(Cw)))


def plan(B: int, D: int, Cw: int, H: int, L: int, K: int, use_xp: bool) -> Plan | None:
    """The layout of a call of the f32 kernels, or None where they refuse
    the shape (exactly where :func:`fits` refuses the config).

    Resident where every weight (at least the weight-gradient staging) and
    a tile of 4 rows fit a block of 512 threads' shared memory in both
    directions; else streamed,
    256 threads a block, through a ring of ``_STAGES`` (else fewer, at least
    2) slots of at least one row of the widest weight, one column of the
    tallest and ``_SLOT_MIN`` floats, with the most rows a block (8, 4, 2,
    1) that fit beside it. The weight gradients take 32-wide tiles at B <=
    256 and 64-wide ones above."""
    R = _RES_ROWS
    if not (B >= 1 and D >= 1 and Cw >= 1 and H >= 1 and 2 <= K <= _MAX_WIDTH
            and 1 <= L <= _MAX_WIDTH):
        return None
    if _tile_bytes(D, Cw, H, L, K, use_xp) > _SMEM_LIMIT:
        return None
    present = [(r, c) for r, c in _weight_shapes(D, Cw, H, L, K, use_xp) if r]
    smem = lambda wf, r, t: (_BAR_BYTES + 4 * (wf + _fwd_tiles(D, Cw, H, L, K, use_xp, r, t)),
                             _BAR_BYTES + 4 * (wf + _bwd_tiles(D, Cw, H, L, K, r, t)))
    wres = max(_WG_STAGE, sum(_up4(r * c) for r, c in present))
    layout = None
    if max(smem(wres, R, _RES_THREADS)) <= _SMEM_LIMIT:
        layout = (True, R, _RES_THREADS, 0, 0, wres)
    else:
        # a slot holds one row of every weight, and one column (the backward's bands)
        slot = _up4(max(_SLOT_MIN, max(max(c, r + 1) for r, c in present)))
        for stages in range(_STAGES, 1, -1):
            wf = max(stages * slot, _WG_STAGE)
            rows = next((r for r in (8, 4, 2, 1)
                         if max(smem(wf, r, _STR_THREADS)) <= _SMEM_LIMIT), 0)
            if rows:
                layout = (False, rows, _STR_THREADS, stages, slot, wf)
                break
        if layout is None:
            return None
    resident, rows, threads, stages, slot, wf = layout
    wg_tile = 32 if B <= 256 else 64
    wg = sum(-(-M // wg_tile) * -(-N // wg_tile) for M, N in _wg_shapes(D, Cw, H, L, K, use_xp))
    fwd_smem, bwd_smem = smem(wf, rows, threads)
    return Plan(resident, rows, threads, stages, slot, -(-B // rows), wg_tile, wg, wf, fwd_smem,
                bwd_smem, B * (D + 2 * H + 3 * L + 2 * (K - 1) + Cw))


def _cfg_dims(cfg):
    return (cfg.original_dim, cfg.intermediate_class_dim, cfg.intermediate_dim, cfg.latent_dim,
            cfg.n_classes, cfg.use_x_prev)


def smem_bytes(cfg) -> int:
    """Dynamic shared memory of one block of the larger f32 kernel, by
    :func:`plan` (the same at every batch size); 0 where it refuses."""
    p = plan(1, *_cfg_dims(cfg))
    return max(p.fwd_smem, p.bwd_smem) if p else 0


def fits(cfg) -> bool:
    """Does the config have the structure the kernels compute (hidden
    layers, 2 <= K <= 128, L <= 128), and does a 4-row tile of the first
    design's activations fit Hopper's shared memory (the width rule the
    port keeps, so both packages route the same configs)?"""
    return (cfg.has_hidden and 2 <= cfg.n_classes <= _MAX_WIDTH
            and cfg.latent_dim <= _MAX_WIDTH and _tile_bytes(*_cfg_dims(cfg)) <= _SMEM_LIMIT)


def should_use(cfg, train_backend=None) -> bool:
    """Route the training forward through the dense-stack kernels?

    ``pallas`` means whenever they accept the config (:func:`fits`); ``xla``
    and ``auto`` mean never. This is the JAX rule without its TPU
    measurement, which the port does not read."""
    if train_backend is None:
        train_backend = getattr(cfg, "train_backend", "xla")
    return train_backend == "pallas" and fits(cfg)


# ------------------------------------------------------------ plain versions


def _mode(whw):
    """(is the call in bf16 mode, the left-operand rounding of its products)."""
    bf16 = whw.dtype == torch.bfloat16
    return bf16, (lambda a: a.bfloat16().float()) if bf16 else (lambda a: a)


def _f32(*ts):
    return tuple(None if t is None else t.float() for t in ts)


def vae_dense_fwd_plain(x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz,
                        wdw, wdxp, wdz, bd, wxh, bxh):
    """The forward kernel's function in torch ops.

    Returns ``(xhat [B, D], wargs [B, 2(K-1)], zargs [B, 2L], w [B, K], a1
    [B, Cw], a2 [B, H], a3 [B, H])``: the outputs and the residuals, all
    f32. The w softmax runs over K lanes whose last is the appended zero
    logit. In bf16 mode (bf16 ``whw``) each product's left operand is
    rounded to bf16 and multiplied in f32 — ``a.bfloat16().float() @
    w.float()`` — since a CPU bf16 matmul would round its output to bf16,
    which the TPU kernel's f32-accumulating product does not; a1, a2, a3
    hold their rounded values."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    _, op = _mode(whw)
    x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh = _f32(
        x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    a1 = op(torch.relu(x @ whw + bhw))
    wargs = a1 @ wwz + bwz
    wn = wargs[:, :K1] + torch.exp(wargs[:, K1:] / 2) * eps_w
    w = torch.softmax(torch.cat([wn, wn.new_zeros((wn.shape[0], 1))], dim=-1), dim=-1)
    a2 = op(torch.relu(x @ whx + op(w) @ whw2 + bh))
    zargs = a2 @ wzz + bzz
    z = zargs[:, :L] + torch.exp(zargs[:, L:] / 2) * eps_z
    d = op(w) @ wdw + op(z) @ wdz + bd
    if xp is not None:
        d = d + xp @ wdxp
    a3 = op(torch.relu(d))
    xhat = torch.sigmoid(a3 @ wxh + bxh)
    return xhat, wargs, zargs, w, a1, a2, a3


def vae_dense_bwd_plain(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                        dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh):
    """The backward kernel's function in torch ops, layer by layer as the TPU
    kernel (``pallas_vae._bwd_kernel`` :258-319) runs it.

    Returns ``(dx, dxp, dwhw, dbhw, dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz,
    dwdw, dwdxp, dwdz, dbd, dwxh, dbxh)``; ``dxp`` and ``dwdxp`` are ``None``
    without ``xp``. In bf16 mode (bf16 ``whw``) each cotangent is rounded to
    bf16 before its transposed product, both operands of each weight
    gradient are rounded and the gradient is returned as bf16 (the TPU
    kernel's ``acc``, then ``_core_bwd``'s cast), the bias gradients are
    sums of the unrounded f32 cotangents, and dx, dx_prev are bf16."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    bf16, op = _mode(whw)
    x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh = _f32(
        x, xp, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    wgrad = lambda a, g: op(a).T @ op(g)
    # frame head: sigmoid backward
    dxh_pre = dxhat * xhat * (1.0 - xhat)
    dwxh, dbxh = wgrad(a3, dxh_pre), dxh_pre.sum(0)
    dd_pre = (op(dxh_pre) @ wxh.T) * (a3 > 0)
    # decoder: z recomputed from the zargs residual
    sig_z = torch.exp(zargs[:, L:] / 2)
    z = zargs[:, :L] + sig_z * eps_z
    dwdw, dwdz, dbd = wgrad(w, dd_pre), wgrad(z, dd_pre), dd_pre.sum(0)
    dwdxp = wgrad(xp, dd_pre) if xp is not None else None
    dxp = op(dd_pre) @ wdxp.T if xp is not None else None
    dw_tot = dw + op(dd_pre) @ wdw.T
    dz = op(dd_pre) @ wdz.T
    # z sample + z heads backward
    dza = torch.cat([dz + dzargs[:, :L], dz * eps_z * sig_z * 0.5 + dzargs[:, L:]], dim=-1)
    dwzz, dbzz = wgrad(a2, dza), dza.sum(0)
    dh_pre = (op(dza) @ wzz.T) * (a2 > 0)
    # latent encoder backward
    dwhx, dwhw2, dbh = wgrad(x, dh_pre), wgrad(w, dh_pre), dh_pre.sum(0)
    dx = op(dh_pre) @ whx.T
    dw_tot = dw_tot + op(dh_pre) @ whw2.T
    # logistic-normal sample backward: softmax vjp, the pinned zero logit dropped
    dlogits = w * (dw_tot - torch.sum(dw_tot * w, dim=-1, keepdim=True))
    dw_norm = dlogits[:, :K1]
    sig_w = torch.exp(wargs[:, K1:] / 2)
    dwa = torch.cat([dw_norm + dwargs[:, :K1], dw_norm * eps_w * sig_w * 0.5 + dwargs[:, K1:]],
                    dim=-1)
    # w heads + key encoder backward
    dwwz, dbwz = wgrad(a1, dwa), dwa.sum(0)
    dhw_pre = (op(dwa) @ wwz.T) * (a1 > 0)
    dwhw, dbhw = wgrad(x, dhw_pre), dhw_pre.sum(0)
    dx = dx + op(dhw_pre) @ whw.T
    if bf16:
        b = lambda t: None if t is None else t.bfloat16()
        dx, dxp, dwhw, dwwz, dwhx, dwhw2, dwzz, dwdw, dwdxp, dwdz, dwxh = (
            b(t) for t in (dx, dxp, dwhw, dwwz, dwhx, dwhw2, dwzz, dwdw, dwdxp, dwdz, dwxh))
    return (dx, dxp, dwhw, dbhw, dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz, dwdw, dwdxp, dwdz,
            dbd, dwxh, dbxh)


# ------------------------------------------------------------ CUDA wrappers

_lib_lock = threading.Lock()
_lib = None


# shapes (B, D, Cw, H, L, K, use_xp) at which the library's plan is held
# against :func:`plan` when it loads: resident twice; streamed at 8, 4, 2 and 1
# rows a block, the last in two ring slots; refused (K past 128)
_PLAN_CHECKS = ((100, 88, 88, 88, 4, 13, 1), (11, 16, 8, 24, 3, 4, 0),
                (1024, 976, 256, 1024, 16, 13, 1), (9, 1024, 256, 2048, 16, 13, 1),
                (5, 1024, 256, 5120, 16, 13, 1), (3, 7000, 64, 96, 4, 5, 1),
                (4, 16, 14400, 16, 1, 2, 0), (100, 88, 88, 88, 4, 129, 1))


def _kernels():
    """The built library with its ctypes signatures; its plan checked
    against :func:`plan`."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("vae_dense")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.cvl_vae_dense_plan.argtypes = [I] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
            lib.cvl_vae_dense_plan.restype = I
            for shape in _PLAN_CHECKS:
                out = (ctypes.c_longlong * 12)()
                ok = lib.cvl_vae_dense_plan(*shape, out)
                want = plan(*shape)
                if (not ok, tuple(out) if ok else None) != (
                        want is None, tuple(int(v) for v in want) if want else None):
                    raise RuntimeError("the plan of csrc/vae_dense.cu differs from "
                                       f"ops/vae_dense.plan at {shape}")
            for fn in (lib.cvl_vae_dense_fwd, lib.cvl_vae_dense_bwd):
                fn.argtypes = [P] + [I] * 8 + [P]
                fn.restype = I
            _lib = lib
        return _lib


_tc_lib = None


def _tc_kernels():
    """The built bf16 library (``csrc/vae_dense_tc.cu``) with its ctypes
    signatures."""
    global _tc_lib
    with _lib_lock:
        if _tc_lib is None:
            lib = _build.load("vae_dense_tc")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.cvl_vae_tc_bwd_scratch.argtypes = [I] * 7
            lib.cvl_vae_tc_bwd_scratch.restype = ctypes.c_longlong
            lib.cvl_vae_tc_bwd.argtypes = [P] * 43 + [I] * 6 + [P]
            lib.cvl_vae_tc_bwd.restype = I
            lib.cvl_vae_tc_fwd_scratch.argtypes = [I] * 4
            lib.cvl_vae_tc_fwd_scratch.restype = ctypes.c_longlong
            lib.cvl_vae_tc_fwd.argtypes = [P] * 28 + [I] * 6 + [P]
            lib.cvl_vae_tc_fwd.restype = I
            _tc_lib = lib
        return _tc_lib


def _count(which: str, n: int, bf16: bool):
    global FWD_LAUNCHES, BWD_LAUNCHES, BF16_FWD_LAUNCHES, BF16_BWD_LAUNCHES
    with _launch_lock:
        if which == "fwd":
            FWD_LAUNCHES += n
            BF16_FWD_LAUNCHES += n * bf16
        else:
            BWD_LAUNCHES += n
            BF16_BWD_LAUNCHES += n * bf16


def _dims(x, xp, whw, whx, whw2, wdz, wdxp):
    """(B, D, Cw, H, L, K, use_xp) from the operands, checked against the
    kernels' limits."""
    if x.dim() != 2 or whw.dim() != 2 or whx.dim() != 2:
        raise ValueError("x must be [B, D], whw [D, Cw] and whx [D, H]")
    (B, D), Cw, H = x.shape, whw.shape[1], whx.shape[1]
    K, L = whw2.shape[0], wdz.shape[0]
    if B < 1:
        raise ValueError(f"need B >= 1 (got {B})")
    if (xp is None) != (wdxp is None):
        raise ValueError("xp and wdxp go together (both given with use_x_prev, or both None)")
    if not (2 <= K <= _MAX_WIDTH and 1 <= L <= _MAX_WIDTH):
        raise ValueError(f"the dense-stack kernels take 2 <= K <= {_MAX_WIDTH} and "
                         f"1 <= L <= {_MAX_WIDTH} (got K={K}, L={L})")
    use_xp = xp is not None
    if _tile_bytes(D, Cw, H, L, K, use_xp) > _SMEM_LIMIT:
        raise ValueError(f"a row tile needs {_tile_bytes(D, Cw, H, L, K, use_xp)} B of shared "
                         f"memory (limit {_SMEM_LIMIT}): widths too large for the dense-stack "
                         "kernels")
    return B, D, Cw, H, L, K, use_xp


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev) -> int:
    """The current CUDA stream of ``dev`` as an int."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


def _signature(ts) -> tuple:
    return tuple(None if t is None else (t.shape, t.stride(), t.dtype, t.device) for t in ts)


class _Call(NamedTuple):
    """What one signature of f32 operands needs: its dimensions, plan and
    output layout."""
    dims: tuple      # B, D, Cw, H, L, K, use_xp
    plan: Plan
    shapes: tuple    # the outputs' shapes (None: absent)
    total: int       # their elements
    templates: list  # a meta tensor of each present output's shape


_calls: dict = {}
_MAX_SIGNATURES = 64


def _f32_call(direction: str, dev, args) -> _Call:
    """The checks of an f32 call, run once per signature of its operands:
    raise on anything the kernels do not take."""
    key = (direction, _signature(args))
    call = _calls.get(key)
    if call is not None:
        return call
    shaping = (0, 1, 4, 8, 9, 15, 14) if direction == "fwd" else (0, 1, 15, 17, 18, 22, 21)
    B, D, Cw, H, L, K, use_xp = dims = _dims(*(args[i] for i in shaping))
    K2 = 2 * (K - 1)
    if direction == "fwd":
        _check(dev, _fwd_shapes(args, B, D, Cw, H, L, K))
        shapes = ((B, D), (B, K2), (B, 2 * L), (B, K), (B, Cw), (B, H), (B, H))
    else:
        _check(dev, _bwd_shapes(args, B, D, Cw, H, L, K))
        shapes = ((B, D), (B, D) if use_xp else None, (D, Cw), (Cw,), (Cw, K2), (K2,), (D, H),
                  (K, H), (H,), (H, 2 * L), (2 * L,), (K, H), (D, H) if use_xp else None,
                  (L, H), (H,), (H, D), (D,))
    p = plan(*dims)
    if p is None:
        raise ValueError(f"the dense-stack kernels have no layout for {dims}")
    templates = [torch.empty(s, device="meta") for s in shapes if s is not None]
    if len(_calls) >= _MAX_SIGNATURES:
        _calls.clear()
    call = _calls[key] = _Call(dims, p, shapes, sum(t.numel() for t in templates), templates)
    return call


def _fwd_shapes(args, B, D, Cw, H, L, K):
    (x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz, bd, wxh,
     bxh) = args
    K2 = 2 * (K - 1)
    return {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
            "eps_z": (eps_z, (B, L)), "whw": (whw, (D, Cw)), "bhw": (bhw, (Cw,)),
            "wwz": (wwz, (Cw, K2)), "bwz": (bwz, (K2,)), "whx": (whx, (D, H)),
            "whw2": (whw2, (K, H)), "bh": (bh, (H,)), "wzz": (wzz, (H, 2 * L)),
            "bzz": (bzz, (2 * L,)), "wdw": (wdw, (K, H)), "wdxp": (wdxp, (D, H)),
            "wdz": (wdz, (L, H)), "bd": (bd, (H,)), "wxh": (wxh, (H, D)), "bxh": (bxh, (D,))}


def _bwd_shapes(args, B, D, Cw, H, L, K):
    (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat, dwargs, dzargs, dw, whw, wwz,
     whx, whw2, wzz, wdw, wdxp, wdz, wxh) = args
    K2 = 2 * (K - 1)
    return {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
            "eps_z": (eps_z, (B, L)), "a1": (a1, (B, Cw)), "a2": (a2, (B, H)),
            "a3": (a3, (B, H)), "xhat": (xhat, (B, D)), "wargs": (wargs, (B, K2)),
            "zargs": (zargs, (B, 2 * L)), "w": (w, (B, K)), "dxhat": (dxhat, (B, D)),
            "dwargs": (dwargs, (B, K2)), "dzargs": (dzargs, (B, 2 * L)), "dw": (dw, (B, K)),
            "whw": (whw, (D, Cw)), "wwz": (wwz, (Cw, K2)), "whx": (whx, (D, H)),
            "whw2": (whw2, (K, H)), "wzz": (wzz, (H, 2 * L)), "wdw": (wdw, (K, H)),
            "wdxp": (wdxp, (D, H)), "wdz": (wdz, (L, H)), "wxh": (wxh, (H, D))}


def _outputs(call: _Call, dev) -> list:
    """The call's outputs as views of one f32 buffer, made in one call (None
    where absent). Returned by an autograd function, an in-place change of
    one raises, as it does for any function's several views."""
    views = iter(_unflatten_dense_tensors(torch.empty(call.total, dtype=torch.float32, device=dev),
                                          call.templates))
    return [None if s is None else next(views) for s in call.shapes]


# the weight matrices among each direction's operands: the kernels copy them
# in 16-byte pieces, so they are passed on 16 bytes
_FWD_WEIGHTS = frozenset((4, 6, 8, 9, 11, 13, 14, 15, 17))
_BWD_WEIGHTS = frozenset(range(15, 24))


_tls = threading.local()


def _pointers(ts, weights: frozenset, keep: list) -> int:
    """The address of an array (this thread's, reused by its next call) of
    the tensors' data pointers (None: null); a weight (its index in
    ``weights``) that does not start on 16 bytes is passed as an aligned
    copy, kept alive in ``keep`` until the launch is queued."""
    ptrs = [0 if t is None else t.data_ptr() for t in ts]
    for i in weights:
        if ptrs[i] & 15:
            t = ts[i].clone()
            keep.append(t)
            ptrs[i] = t.data_ptr()
    state = getattr(_tls, "ptrs", None)
    if state is None:
        arr = np.zeros(64, dtype=np.uint64)
        state = _tls.ptrs = (arr, arr.ctypes.data)
    arr, addr = state
    arr[:len(ptrs)] = ptrs
    return addr


_barriers: dict = {}


def _barrier(dev, stream: int):
    """The backward's grid-barrier state on ``dev`` for ``stream``: two
    zeroed words, which every launch leaves as it found them."""
    key = (dev.index, stream)
    bar = _barriers.get(key)
    if bar is None:
        bar = _barriers.setdefault(key, torch.zeros(2, dtype=torch.int32, device=dev))
    return bar


def vae_dense_fwd(x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz,
                  wdw, wdxp, wdz, bd, wxh, bxh):
    """The forward kernel (signature and results of :func:`vae_dense_fwd_plain`).

    CUDA tensors launch, in the f32 mode, ``vae_dense_fwd_kernel`` on the
    current stream (one block a row tile, the weights resident or streamed
    as :func:`plan` says); where ``whw`` is bf16, ``csrc/vae_dense_tc.cu``'s
    forward (the products that do not depend on w, the narrow chain in a
    row kernel, the frame head; 3 device launches counted as one); or
    raise. CPU tensors take the plain version."""
    args = (x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz,
            bd, wxh, bxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_fwd_plain(*args)
    if whw.dtype == torch.bfloat16:
        return _tc_fwd(args, dev)
    return _f32_fwd(args, dev, None)


# the parts of each f32 kernel that block 0 times (:func:`phase_ms`); a part
# holds its layers' waits for their weights
FWD_PARTS = ("inputs", "key encoder", "w heads", "w sample", "latent encoder",
             "z heads and sample", "decoder", "frame head")
BWD_PARTS = ("inputs and frame head", "decoder", "decoder's shares", "z sample",
             "latent encoder", "latent encoder's shares", "w sample", "key encoder", "dx",
             "grid barrier", "weight gradients")


def _f32_fwd(args, dev, clock):
    call = _f32_call("fwd", dev, args)
    B, D, Cw, H, L, K, use_xp = call.dims
    lib = _kernels()
    outs = _outputs(call, dev)
    keep = []
    ptrs = _pointers((*args, *outs, clock), _FWD_WEIGHTS, keep)
    err = lib.cvl_vae_dense_fwd(ptrs, B, D, Cw, H, L, K, int(use_xp), dev.index, _stream(dev))
    if err != 0:
        raise RuntimeError(f"vae_dense forward kernel launch failed: CUDA error {err}")
    _count("fwd", 1, False)
    return tuple(outs)


def _tc_fwd(args, dev):
    """The bf16 mode's forward (``csrc/vae_dense_tc.cu``)."""
    x, xp, whw, whx, whw2, wdz, wdxp = (args[i] for i in (0, 1, 4, 8, 9, 15, 14))
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    _check(dev, _fwd_shapes(args, B, D, Cw, H, L, K), bf16=_BF16_OPERANDS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        outs = (new(B, D), new(B, 2 * (K - 1)), new(B, 2 * L), new(B, K), new(B, Cw), new(B, H),
                new(B, H))
        lib = _tc_kernels()
        ins = tuple(_aligned(t) for t in args)
        scratch = new(lib.cvl_vae_tc_fwd_scratch(B, H, int(use_xp), 0))
        scratch_b = torch.empty(lib.cvl_vae_tc_fwd_scratch(B, H, int(use_xp), 1),
                                dtype=torch.bfloat16, device=dev)
        err = lib.cvl_vae_tc_fwd(*(_ptr(t) for t in (*ins, *outs, scratch, scratch_b)),
                                 B, D, Cw, H, L, K, stream)
    if err != 0:
        raise RuntimeError(f"vae_dense forward kernel launch failed: CUDA error {err}")
    _count("fwd", 1, True)
    return outs


def vae_dense_bwd(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                  dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh):
    """The backward kernel (signature and results of :func:`vae_dense_bwd_plain`).

    CUDA tensors launch, in the f32 mode, ``vae_dense_bwd_kernel``: one
    cooperative launch whose blocks run the row pass (dx, dxp and each
    layer's pre-activation cotangent into one scratch), meet at a grid
    barrier, then form every weight and bias gradient, each summed over the
    B rows in a fixed order; where ``whw`` is bf16, ``csrc/vae_dense_tc.cu``
    (the wide layers and weight gradients on the tensor cores, every weight
    read as stored; 8 device launches, 9 when B > 128, counted as two); or
    raise. CPU tensors take the plain version."""
    args = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat, dwargs, dzargs, dw,
            whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_bwd_plain(*args)
    if whw.dtype == torch.bfloat16:
        return _tc_bwd(args, dev)
    return _f32_bwd(args, dev, None)


def _f32_bwd(args, dev, clock):
    call = _f32_call("bwd", dev, args)
    B, D, Cw, H, L, K, use_xp = call.dims
    lib = _kernels()
    grads = _outputs(call, dev)
    scratch = torch.empty(call.plan.scratch, dtype=torch.float32, device=dev)
    stream = _stream(dev)
    keep = []
    ptrs = _pointers((*args, *grads, scratch, _barrier(dev, stream), clock), _BWD_WEIGHTS, keep)
    err = lib.cvl_vae_dense_bwd(ptrs, B, D, Cw, H, L, K, int(use_xp), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"vae_dense backward kernel launch failed: CUDA error {err}")
    _count("bwd", 1, False)
    return tuple(grads)


def phase_ms(direction: str, *args) -> tuple[dict, int]:
    """One launch of the f32 kernel of ``direction`` ("fwd" or "bwd"; the
    arguments of :func:`vae_dense_fwd` or :func:`vae_dense_bwd`, on CUDA
    tensors; counted as the wrapper counts it), timed part by part on the
    card by block 0 (``%globaltimer``). Returns the ms of each of
    :data:`FWD_PARTS` or :data:`BWD_PARTS` (the barrier's is block 0's wait
    for the slowest block) and the blocks the launch ran: the forward's row
    tiles, or the backward's cooperative grid as the launch sized it."""
    dev = _device_of(args[0])
    whw = args[4 if direction == "fwd" else 15]
    if dev.type != "cuda" or whw.dtype != torch.float32:
        raise ValueError("phase_ms times the f32 kernels on CUDA tensors")
    parts = FWD_PARTS if direction == "fwd" else BWD_PARTS
    clock = torch.zeros(len(parts) + 1, dtype=torch.int64, device=dev)
    (_f32_fwd if direction == "fwd" else _f32_bwd)(args, dev, clock)
    words = clock.cpu().tolist()
    blocks = _f32_call(direction, dev, args).plan.tiles if direction == "fwd" else words[-1]
    return dict(zip(parts, (ns / 1e6 for ns in words))), int(blocks)


def _tc_bwd(args, dev):
    """The bf16 mode's backward (``csrc/vae_dense_tc.cu``); its scratch in
    one f32 and one bf16 buffer."""
    x, xp, whw, whx, whw2, wdz, wdxp = (args[i] for i in (0, 1, 15, 17, 18, 22, 21))
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    K2 = 2 * (K - 1)
    _check(dev, _bwd_shapes(args, B, D, Cw, H, L, K), bf16=_BF16_OPERANDS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        new = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
        g = lambda *s: new(*s, dt=torch.bfloat16)  # a weight gradient: bf16
        dx, dxp = g(B, D), (g(B, D) if use_xp else None)
        wgrads = (g(D, Cw), new(Cw), g(Cw, K2), new(K2), g(D, H), g(K, H), new(H),
                  g(H, 2 * L), new(2 * L), g(K, H), g(D, H) if use_xp else None, g(L, H),
                  new(H), g(H, D), new(D))
        lib = _tc_kernels()
        ins = tuple(_aligned(t) for t in args)
        n_f = lib.cvl_vae_tc_bwd_scratch(B, D, Cw, H, L, K, 0)
        n_b = lib.cvl_vae_tc_bwd_scratch(B, D, Cw, H, L, K, 1)
        scratch = torch.empty(n_f, dtype=torch.float32, device=dev)
        scratch_b = torch.empty(n_b, dtype=torch.bfloat16, device=dev)
        err = lib.cvl_vae_tc_bwd(*(_ptr(v) for v in (*ins, dx, dxp, *wgrads, scratch, scratch_b)),
                                 B, D, Cw, H, L, K, stream)
    if err != 0:
        raise RuntimeError(f"vae_dense bf16 backward launch failed: CUDA error {err}")
    _count("bwd", 2, True)
    return (dx, dxp, *wgrads)


# ------------------------------------------------------------ autograd


class VaeDenseCore(torch.autograd.Function):
    """``_vae_core`` of the JAX package: forward and backward kernels (or
    their plain versions on the CPU) behind one autograd node.

    Inputs: x, xp, eps_w, eps_z and the fifteen packed weights and biases
    (the signature of :func:`vae_dense_fwd`); outputs: xhat, wargs, zargs, w.
    The mode follows the inputs' type (bf16 kernels: the bf16 mode), and
    each gradient comes back in its input's type. The noise gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz,
                wdw, wdxp, wdz, bd, wxh, bxh):
        xhat, wargs, zargs, w, a1, a2, a3 = vae_dense_fwd(
            x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz,
            bd, wxh, bxh)
        ctx.save_for_backward(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                              whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
        return xhat, wargs, zargs, w

    @staticmethod
    def backward(ctx, dxhat, dwargs, dzargs, dw):
        res = ctx.saved_tensors
        cot = (dxhat.contiguous(), dwargs.contiguous(), dzargs.contiguous(), dw.contiguous())
        (dx, dxp, dwhw, dbhw, dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz, dwdw, dwdxp, dwdz, dbd,
         dwxh, dbxh) = vae_dense_bwd(*res[:11], *cot, *res[11:])
        return (dx, dxp, None, None, dwhw, dbhw, dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz, dwdw,
                dwdxp, dwdz, dbd, dwxh, dbxh)


def pack_inputs(params, cfg, x, x_prev, eps_w, eps_z) -> tuple:
    """The core's 19 inputs from the model's parameters and a batch: the w
    and z heads packed side by side, the latent encoder's kernel split into
    its x and w rows, the decoder's into its w, x_prev and z rows. Under
    ``cfg.bf16_compute`` x, x_prev and every kernel are cast to bf16 (the
    biases and the noise stay f32), as JAX ``padm``/``padx`` cast them.
    Differentiable torch ops, so autograd routes the parameter cotangents
    back through them (a bf16 gradient reaches its f32 parameter as f32)."""
    D, K = cfg.original_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    c = lambda t: t.contiguous()
    m = (lambda t: t.to(torch.bfloat16).contiguous()) if cfg.bf16_compute else c
    heads = lambda a, b: (m(torch.cat([params[a]["kernel"], params[b]["kernel"]], dim=1)),
                          c(torch.cat([params[a]["bias"], params[b]["bias"]])))
    wwz, bwz = heads("w_mean", "w_log_var")
    wzz, bzz = heads("z_mean", "z_log_var")
    hk, dk = params["h"]["kernel"], params["decoder_h"]["kernel"]
    return (m(x), m(x_prev) if cfg.use_x_prev else None, c(eps_w), c(eps_z),
            m(params["h_w"]["kernel"]), c(params["h_w"]["bias"]), wwz, bwz,
            m(hk[:D]), m(hk[D:]), c(params["h"]["bias"]), wzz, bzz,
            m(dk[:K]), m(dk[K:K + D]) if cfg.use_x_prev else None, m(dk[K + n_xp:]),
            c(params["decoder_h"]["bias"]), m(params["x_decoded_mean"]["kernel"]),
            c(params["x_decoded_mean"]["bias"]))


def vae_apply_core(params, cfg, x, x_prev, eps_w, eps_z) -> dict:
    """The whole cl_vae graph over a batch ``[B, D]`` through the
    dense-stack kernels.

    Drop-in for the ``encode_w`` -> logistic-normal sample -> ``encode_z``
    -> Gaussian sample -> ``decode`` composition at ``cfg.has_hidden``, with
    the noise given (``eps_w [B, K-1]``, ``eps_z [B, L]``); returns the named
    tensors of :func:`..models.cl_vae.apply`, z recomputed outside the core.
    Under ``cfg.bf16_compute`` the core runs in its bf16 mode."""
    if not fits(cfg):
        raise ValueError(f"the dense-stack kernels do not take this config ({cfg})")
    K1, L = cfg.n_classes - 1, cfg.latent_dim
    xhat, wargs, zargs, w = VaeDenseCore.apply(*pack_inputs(params, cfg, x, x_prev, eps_w, eps_z))
    z_mean, z_log_var = zargs[:, :L], zargs[:, L:]
    return {
        "x_decoded_mean": xhat,
        "w": w,
        "w_mean": wargs[:, :K1],
        "w_log_var": wargs[:, K1:],
        "z": z_mean + torch.exp(z_log_var / 2) * eps_z,
        "z_mean": z_mean,
        "z_log_var": z_log_var,
    }
