"""cl_vae dense-stack training core: CUDA wrappers, plain versions and the
autograd function.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_vae.py``. The whole
cl_vae graph — key encoder, logistic-normal w sample, latent encoder, z
sample, decoder, frame head — runs forward in one kernel and backward in one
kernel of two launches (``csrc/vae_dense.cu``); the backward's bf16 mode is
``csrc/vae_dense_tc.cu``, the wide layers as tensor-core products over the
whole batch and the narrow ones in row kernels (8 launches, counted as two,
9 when B > 128). Each has a plain PyTorch
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

Layouts: rows ``[B, ...]``; kernels ``[in, out]``; the w heads packed to
``wwz [Cw, 2(K-1)]`` / ``bwz``, the z heads to ``wzz [H, 2L]`` / ``bzz`` (no
lane padding); the latent encoder's kernel split into its x rows ``whx`` and
w rows ``whw2``, the decoder's into its w rows ``wdw``, x_prev rows ``wdxp``
(``None`` without ``use_x_prev``, as is ``xp``) and z rows ``wdz``.

:func:`vae_dense_fwd` / :func:`vae_dense_bwd` launch the kernels for CUDA
tensors (or raise: there is no fallback) and take the plain versions only
for CPU tensors. :func:`vae_apply_core` is the model's entry; it packs the
weights outside the autograd function, so autograd routes the parameter
cotangents back through the packing.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._checks import _aligned, _check, _device_of

# launches since the counts were last set to 0: one per forward call, two per
# backward call (the row pass, then the weight-gradient pass); the BF16_
# counts are the bf16-mode share of each
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

_ROWS_PER_BLOCK = 4     # kRows in csrc/vae_dense.cu
_SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block can use
# the JAX kernel's lane width: K and L up to it, so both packages route the
# same configs to their kernels
_MAX_WIDTH = 128
# the operands that are bf16 in the bf16 mode: x, x_prev and the kernels
_BF16_OPERANDS = frozenset({"x", "xp", "whw", "wwz", "whx", "whw2", "wzz", "wdw", "wdxp",
                            "wdz", "wxh"})


def _smem_bytes(D: int, Cw: int, H: int, L: int, K: int, use_xp: bool) -> int:
    fwd = D * (1 + int(use_xp)) + Cw + 2 * (K - 1) + K + 2 * H + 3 * L
    bwd = 2 * D + 2 * H + K + 3 * L + 2 * (K - 1) + Cw
    return 4 * _ROWS_PER_BLOCK * max(fwd, bwd)


def smem_bytes(cfg) -> int:
    """Shared memory of one block of the larger row kernel: the tile's
    activations (forward: x, x_prev, a1, wargs, w, a2, zargs, z, a3;
    backward: each layer's cotangent) for each of its rows."""
    return _smem_bytes(cfg.original_dim, cfg.intermediate_class_dim, cfg.intermediate_dim,
                       cfg.latent_dim, cfg.n_classes, cfg.use_x_prev)


def fits(cfg) -> bool:
    """Does the config have the structure the kernels compute (hidden
    layers, 2 <= K <= 128, L <= 128), and does one row tile's activations fit
    Hopper's shared memory?"""
    return (cfg.has_hidden and 2 <= cfg.n_classes <= _MAX_WIDTH
            and cfg.latent_dim <= _MAX_WIDTH and smem_bytes(cfg) <= _SMEM_LIMIT)


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


def _kernels():
    """The built library with its ctypes signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("vae_dense")
            P, I = ctypes.c_void_p, ctypes.c_int
            smem = lib.cvl_vae_dense_smem_bytes
            smem.argtypes, smem.restype = [I] * 6, ctypes.c_longlong
            for shape in ((88, 88, 88, 4, 13, 1), (976, 256, 1024, 16, 13, 1),
                          (16, 8, 24, 3, 4, 0)):
                if smem(*shape) != _smem_bytes(*shape):
                    raise RuntimeError("shared-memory layout of csrc/vae_dense.cu differs from "
                                       f"_smem_bytes at {shape}")
            lib.cvl_vae_dense_fwd.argtypes = [I] + [P] * 26 + [I] * 7 + [P]
            lib.cvl_vae_dense_bwd.argtypes = [P] * 28 + [I] * 7 + [P]
            lib.cvl_vae_dense_wgrad.argtypes = [P] * 28 + [I] * 7 + [P]
            for fn in (lib.cvl_vae_dense_fwd, lib.cvl_vae_dense_bwd, lib.cvl_vae_dense_wgrad):
                fn.restype = I
            _lib = lib
        return _lib


_tc_lib = None


def _tc_kernels():
    """The built bf16 backward library (``csrc/vae_dense_tc.cu``) with its
    ctypes signatures."""
    global _tc_lib
    with _lib_lock:
        if _tc_lib is None:
            lib = _build.load("vae_dense_tc")
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.cvl_vae_tc_bwd_scratch.argtypes = [I] * 7
            lib.cvl_vae_tc_bwd_scratch.restype = ctypes.c_longlong
            lib.cvl_vae_tc_bwd.argtypes = [P] * 43 + [I] * 6 + [P]
            lib.cvl_vae_tc_bwd.restype = I
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
    if _smem_bytes(D, Cw, H, L, K, use_xp) > _SMEM_LIMIT:
        raise ValueError(f"a row tile needs {_smem_bytes(D, Cw, H, L, K, use_xp)} B of shared "
                         f"memory (limit {_SMEM_LIMIT}): widths too large for the dense-stack "
                         "kernels")
    return B, D, Cw, H, L, K, use_xp


def _ptr(t):
    return None if t is None else t.data_ptr()


def vae_dense_fwd(x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz,
                  wdw, wdxp, wdz, bd, wxh, bxh):
    """The forward kernel (signature and results of :func:`vae_dense_fwd_plain`).

    CUDA tensors launch ``vae_dense_fwd_kernel`` on the current stream (or
    raise), in bf16 mode where ``whw`` is bf16; CPU tensors take the plain
    version."""
    args = (x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz,
            bd, wxh, bxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_fwd_plain(*args)
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    bf16 = whw.dtype == torch.bfloat16
    K2 = 2 * (K - 1)
    _check(dev, {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
                 "eps_z": (eps_z, (B, L)), "whw": (whw, (D, Cw)), "bhw": (bhw, (Cw,)),
                 "wwz": (wwz, (Cw, K2)), "bwz": (bwz, (K2,)), "whx": (whx, (D, H)),
                 "whw2": (whw2, (K, H)), "bh": (bh, (H,)), "wzz": (wzz, (H, 2 * L)),
                 "bzz": (bzz, (2 * L,)), "wdw": (wdw, (K, H)), "wdxp": (wdxp, (D, H)),
                 "wdz": (wdz, (L, H)), "bd": (bd, (H,)), "wxh": (wxh, (H, D)), "bxh": (bxh, (D,))},
           bf16=_BF16_OPERANDS if bf16 else frozenset())
    lib = _kernels()
    with torch.cuda.device(dev):
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        outs = (new(B, D), new(B, K2), new(B, 2 * L), new(B, K), new(B, Cw), new(B, H),
                new(B, H))
        err = lib.cvl_vae_dense_fwd(int(bf16), *(_ptr(t) for t in args + outs), B, D, Cw, H, L,
                                    K, int(use_xp), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vae_dense forward kernel launch failed: CUDA error {err}")
    _count("fwd", 1, bf16)
    return outs


def vae_dense_bwd(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                  dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh):
    """The backward kernel (signature and results of :func:`vae_dense_bwd_plain`).

    CUDA tensors launch, in the f32 mode, ``vae_dense_bwd_kernel`` (the row
    pass, which writes dx, dxp and each layer's pre-activation cotangent to
    scratch) and then ``wgrad_kernel<vae_dense_wgrad>`` (every weight and bias
    gradient, summed over the B rows in a fixed order); where ``whw`` is
    bf16, ``csrc/vae_dense_tc.cu`` (the wide layers and weight gradients on
    the tensor cores, every weight read as stored; 8 device launches, 9 when
    B > 128, counted as two); or raise. CPU tensors take the plain version."""
    args = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat, dwargs, dzargs, dw,
            whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_bwd_plain(*args)
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    bf16 = whw.dtype == torch.bfloat16
    K2 = 2 * (K - 1)
    _check(dev, {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
                 "eps_z": (eps_z, (B, L)), "a1": (a1, (B, Cw)), "a2": (a2, (B, H)),
                 "a3": (a3, (B, H)), "xhat": (xhat, (B, D)), "wargs": (wargs, (B, K2)),
                 "zargs": (zargs, (B, 2 * L)), "w": (w, (B, K)), "dxhat": (dxhat, (B, D)),
                 "dwargs": (dwargs, (B, K2)), "dzargs": (dzargs, (B, 2 * L)), "dw": (dw, (B, K)),
                 "whw": (whw, (D, Cw)), "wwz": (wwz, (Cw, K2)), "whx": (whx, (D, H)),
                 "whw2": (whw2, (K, H)), "wzz": (wzz, (H, 2 * L)), "wdw": (wdw, (K, H)),
                 "wdxp": (wdxp, (D, H)), "wdz": (wdz, (L, H)), "wxh": (wxh, (H, D))},
           bf16=_BF16_OPERANDS if bf16 else frozenset())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        new = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
        wt = torch.bfloat16 if bf16 else torch.float32
        dx, dxp = new(B, D, dt=wt), (new(B, D, dt=wt) if use_xp else None)
        g = lambda *s: new(*s, dt=wt)  # a weight gradient: the mode's type
        wgrads = (g(D, Cw), new(Cw), g(Cw, K2), new(K2), g(D, H), g(K, H), new(H),
                  g(H, 2 * L), new(2 * L), g(K, H), g(D, H) if use_xp else None, g(L, H),
                  new(H), g(H, D), new(D))
        if bf16:
            _tc_bwd(args, dx, dxp, wgrads, B, D, Cw, H, L, K, stream)
            return (dx, dxp, *wgrads)
        lib = _kernels()
        # the row pass reads each weight transposed, one row per output
        # column of its layer, so neighbouring threads read neighbouring words
        t = lambda m: m.T.contiguous()
        wd = torch.cat([wdw, wdxp, wdz] if use_xp else [wdw, wdz], 0)
        w_t = (t(wxh), t(wd), t(wzz), t(torch.cat([whx, whw2], 0)), t(wwz), t(whw))
        scratch = (new(B, D), new(B, H), new(B, 2 * L), new(B, H), new(B, K2), new(B, Cw),
                   new(B, L))  # dxh_pre, dd_pre, dza, dh_pre, dwa, dhw_pre, zs
        ptrs = [_ptr(v) for v in (eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat,
                                  dwargs, dzargs, dw, *w_t, dx, dxp, *scratch)]
        err = lib.cvl_vae_dense_bwd(*ptrs, B, D, Cw, H, L, K, int(use_xp), stream)
        if err != 0:
            raise RuntimeError(f"vae_dense backward kernel launch failed: CUDA error {err}")
        _count("bwd", 1, bf16)
        dxh_pre, dd_pre, dza, dh_pre, dwa, dhw_pre, zs = scratch
        ptrs = [_ptr(v) for v in (x, xp, a1, a2, a3, w, zs, dxh_pre, dd_pre, dza, dh_pre, dwa,
                                  dhw_pre, *wgrads)]
        err = lib.cvl_vae_dense_wgrad(*ptrs, B, D, Cw, H, L, K, int(use_xp), stream)
    if err != 0:
        raise RuntimeError(f"vae_dense weight-gradient kernel launch failed: CUDA error {err}")
    _count("bwd", 1, bf16)
    return (dx, dxp, *wgrads)


def _tc_bwd(args, dx, dxp, wgrads, B, D, Cw, H, L, K, stream):
    """The bf16 mode's backward (``csrc/vae_dense_tc.cu``) into dx, dxp and
    the gradients; its scratch in one f32 and one bf16 buffer."""
    lib = _tc_kernels()
    dev = dx.device
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
