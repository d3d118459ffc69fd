"""cl_vae dense-stack training core: CUDA wrappers, plain versions and the
autograd function.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_vae.py``. The whole
cl_vae graph — key encoder, logistic-normal w sample, latent encoder, z
sample, decoder, frame head — runs forward in one kernel and backward in one
kernel of two launches (``csrc/vae_dense.cu``). Each has a plain PyTorch
version with the same signature: :func:`vae_dense_fwd_plain`, and
:func:`vae_dense_bwd_plain`, which mirrors the TPU backward kernel (it is not
autograd of the plain forward: it recomputes z and the exp factors from the
zargs / wargs residuals and takes the relu masks from the post-activations),
so the backward kernel can be held against it on identical residuals.

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
from .two_cell import _check, _device_of

# launches since the counts were last set to 0: one per forward call, two per
# backward call (the row pass, then the weight-gradient pass)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
_launch_lock = threading.Lock()

_ROWS_PER_BLOCK = 4     # kRows in csrc/vae_dense.cu
_SMEM_LIMIT = 232448    # dynamic shared memory one Hopper block can use
# the JAX kernel's lane width: K and L up to it, so both packages route the
# same configs to their kernels
_MAX_WIDTH = 128
BF16_TODO = ("the bf16 mode of the dense-stack kernels is not ported yet "
             "(ROADMAP Queue 2 item 7)")


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


def vae_dense_fwd_plain(x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz,
                        wdw, wdxp, wdz, bd, wxh, bxh):
    """The forward kernel's function in torch ops.

    Returns ``(xhat [B, D], wargs [B, 2(K-1)], zargs [B, 2L], w [B, K], a1
    [B, Cw], a2 [B, H], a3 [B, H])``: the outputs and the residuals. The w
    softmax runs over K lanes whose last is the appended zero logit."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    a1 = torch.relu(x @ whw + bhw)
    wargs = a1 @ wwz + bwz
    wn = wargs[:, :K1] + torch.exp(wargs[:, K1:] / 2) * eps_w
    w = torch.softmax(torch.cat([wn, wn.new_zeros((wn.shape[0], 1))], dim=-1), dim=-1)
    a2 = torch.relu(x @ whx + w @ whw2 + bh)
    zargs = a2 @ wzz + bzz
    z = zargs[:, :L] + torch.exp(zargs[:, L:] / 2) * eps_z
    d = w @ wdw + z @ wdz + bd
    if xp is not None:
        d = d + xp @ wdxp
    a3 = torch.relu(d)
    xhat = torch.sigmoid(a3 @ wxh + bxh)
    return xhat, wargs, zargs, w, a1, a2, a3


def vae_dense_bwd_plain(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                        dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh):
    """The backward kernel's function in torch ops, layer by layer as the TPU
    kernel (``pallas_vae._bwd_kernel`` :258-319) runs it.

    Returns ``(dx, dxp, dwhw, dbhw, dwwz, dbwz, dwhx, dwhw2, dbh, dwzz, dbzz,
    dwdw, dwdxp, dwdz, dbd, dwxh, dbxh)``; ``dxp`` and ``dwdxp`` are ``None``
    without ``xp``."""
    K1, L = eps_w.shape[-1], eps_z.shape[-1]
    # frame head: sigmoid backward
    dxh_pre = dxhat * xhat * (1.0 - xhat)
    dwxh, dbxh = a3.T @ dxh_pre, dxh_pre.sum(0)
    dd_pre = (dxh_pre @ wxh.T) * (a3 > 0)
    # decoder: z recomputed from the zargs residual
    sig_z = torch.exp(zargs[:, L:] / 2)
    z = zargs[:, :L] + sig_z * eps_z
    dwdw, dwdz, dbd = w.T @ dd_pre, z.T @ dd_pre, dd_pre.sum(0)
    dwdxp = xp.T @ dd_pre if xp is not None else None
    dxp = dd_pre @ wdxp.T if xp is not None else None
    dw_tot = dw + dd_pre @ wdw.T
    dz = dd_pre @ wdz.T
    # z sample + z heads backward
    dza = torch.cat([dz + dzargs[:, :L], dz * eps_z * sig_z * 0.5 + dzargs[:, L:]], dim=-1)
    dwzz, dbzz = a2.T @ dza, dza.sum(0)
    dh_pre = (dza @ wzz.T) * (a2 > 0)
    # latent encoder backward
    dwhx, dwhw2, dbh = x.T @ dh_pre, w.T @ dh_pre, dh_pre.sum(0)
    dx = dh_pre @ whx.T
    dw_tot = dw_tot + dh_pre @ whw2.T
    # logistic-normal sample backward: softmax vjp, the pinned zero logit dropped
    dlogits = w * (dw_tot - torch.sum(dw_tot * w, dim=-1, keepdim=True))
    dw_norm = dlogits[:, :K1]
    sig_w = torch.exp(wargs[:, K1:] / 2)
    dwa = torch.cat([dw_norm + dwargs[:, :K1], dw_norm * eps_w * sig_w * 0.5 + dwargs[:, K1:]],
                    dim=-1)
    # w heads + key encoder backward
    dwwz, dbwz = a1.T @ dwa, dwa.sum(0)
    dhw_pre = (dwa @ wwz.T) * (a1 > 0)
    dwhw, dbhw = x.T @ dhw_pre, dhw_pre.sum(0)
    dx = dx + dhw_pre @ whw.T
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
            lib.cvl_vae_dense_fwd.argtypes = [P] * 26 + [I] * 7 + [P]
            lib.cvl_vae_dense_bwd.argtypes = [P] * 28 + [I] * 7 + [P]
            lib.cvl_vae_dense_wgrad.argtypes = [P] * 28 + [I] * 7 + [P]
            for fn in (lib.cvl_vae_dense_fwd, lib.cvl_vae_dense_bwd, lib.cvl_vae_dense_wgrad):
                fn.restype = I
            _lib = lib
        return _lib


def _count(which: str, n: int):
    global FWD_LAUNCHES, BWD_LAUNCHES
    with _launch_lock:
        if which == "fwd":
            FWD_LAUNCHES += n
        else:
            BWD_LAUNCHES += n


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
    raise); CPU tensors take the plain version."""
    args = (x, xp, eps_w, eps_z, whw, bhw, wwz, bwz, whx, whw2, bh, wzz, bzz, wdw, wdxp, wdz,
            bd, wxh, bxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_fwd_plain(*args)
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    K2 = 2 * (K - 1)
    _check(dev, {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
                 "eps_z": (eps_z, (B, L)), "whw": (whw, (D, Cw)), "bhw": (bhw, (Cw,)),
                 "wwz": (wwz, (Cw, K2)), "bwz": (bwz, (K2,)), "whx": (whx, (D, H)),
                 "whw2": (whw2, (K, H)), "bh": (bh, (H,)), "wzz": (wzz, (H, 2 * L)),
                 "bzz": (bzz, (2 * L,)), "wdw": (wdw, (K, H)), "wdxp": (wdxp, (D, H)),
                 "wdz": (wdz, (L, H)), "bd": (bd, (H,)), "wxh": (wxh, (H, D)), "bxh": (bxh, (D,))})
    lib = _kernels()
    with torch.cuda.device(dev):
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        outs = (new(B, D), new(B, K2), new(B, 2 * L), new(B, K), new(B, Cw), new(B, H),
                new(B, H))
        err = lib.cvl_vae_dense_fwd(*(_ptr(t) for t in args + outs), B, D, Cw, H, L, K,
                                    int(use_xp), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vae_dense forward kernel launch failed: CUDA error {err}")
    _count("fwd", 1)
    return outs


def vae_dense_bwd(x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w,
                  dxhat, dwargs, dzargs, dw, whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh):
    """The backward kernel (signature and results of :func:`vae_dense_bwd_plain`).

    CUDA tensors launch ``vae_dense_bwd_kernel`` (the row pass, which writes
    dx, dxp and each layer's pre-activation cotangent to scratch) and then
    ``wgrad_kernel<vae_dense_wgrad>`` (every weight and bias gradient, summed over
    the B rows in a fixed order), or raise; CPU tensors take the plain
    version."""
    args = (x, xp, eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat, dwargs, dzargs, dw,
            whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
    dev = _device_of(x)
    if dev.type == "cpu":
        return vae_dense_bwd_plain(*args)
    B, D, Cw, H, L, K, use_xp = _dims(x, xp, whw, whx, whw2, wdz, wdxp)
    K2 = 2 * (K - 1)
    _check(dev, {"x": (x, (B, D)), "xp": (xp, (B, D)), "eps_w": (eps_w, (B, K - 1)),
                 "eps_z": (eps_z, (B, L)), "a1": (a1, (B, Cw)), "a2": (a2, (B, H)),
                 "a3": (a3, (B, H)), "xhat": (xhat, (B, D)), "wargs": (wargs, (B, K2)),
                 "zargs": (zargs, (B, 2 * L)), "w": (w, (B, K)), "dxhat": (dxhat, (B, D)),
                 "dwargs": (dwargs, (B, K2)), "dzargs": (dzargs, (B, 2 * L)), "dw": (dw, (B, K)),
                 "whw": (whw, (D, Cw)), "wwz": (wwz, (Cw, K2)), "whx": (whx, (D, H)),
                 "whw2": (whw2, (K, H)), "wzz": (wzz, (H, 2 * L)), "wdw": (wdw, (K, H)),
                 "wdxp": (wdxp, (D, H)), "wdz": (wdz, (L, H)), "wxh": (wxh, (H, D))})
    lib = _kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        # the row pass reads each weight transposed, one row per output
        # column of its layer, so neighbouring threads read neighbouring words
        t = lambda m: m.T.contiguous()
        wd = torch.cat([wdw, wdxp, wdz] if use_xp else [wdw, wdz], 0)
        w_t = (t(wxh), t(wd), t(wzz), t(torch.cat([whx, whw2], 0)), t(wwz), t(whw))
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        dx, dxp = new(B, D), (new(B, D) if use_xp else None)
        scratch = (new(B, D), new(B, H), new(B, 2 * L), new(B, H), new(B, K2), new(B, Cw),
                   new(B, L))  # dxh_pre, dd_pre, dza, dh_pre, dwa, dhw_pre, zs
        ptrs = [_ptr(v) for v in (eps_w, eps_z, a1, a2, a3, xhat, wargs, zargs, w, dxhat,
                                  dwargs, dzargs, dw, *w_t, dx, dxp, *scratch)]
        err = lib.cvl_vae_dense_bwd(*ptrs, B, D, Cw, H, L, K, int(use_xp), stream)
        if err != 0:
            raise RuntimeError(f"vae_dense backward kernel launch failed: CUDA error {err}")
        _count("bwd", 1)
        wgrads = (new(D, Cw), new(Cw), new(Cw, K2), new(K2), new(D, H), new(K, H), new(H),
                  new(H, 2 * L), new(2 * L), new(K, H), new(D, H) if use_xp else None, new(L, H),
                  new(H), new(H, D), new(D))
        dxh_pre, dd_pre, dza, dh_pre, dwa, dhw_pre, zs = scratch
        ptrs = [_ptr(v) for v in (x, xp, a1, a2, a3, w, zs, dxh_pre, dd_pre, dza, dh_pre, dwa,
                                  dhw_pre, *wgrads)]
        err = lib.cvl_vae_dense_wgrad(*ptrs, B, D, Cw, H, L, K, int(use_xp), stream)
    if err != 0:
        raise RuntimeError(f"vae_dense weight-gradient kernel launch failed: CUDA error {err}")
    _count("bwd", 1)
    return (dx, dxp, *wgrads)


# ------------------------------------------------------------ autograd


class VaeDenseCore(torch.autograd.Function):
    """``_vae_core`` of the JAX package: forward and backward kernels (or
    their plain versions on the CPU) behind one autograd node.

    Inputs: x, xp, eps_w, eps_z and the fifteen packed weights and biases
    (the signature of :func:`vae_dense_fwd`); outputs: xhat, wargs, zargs, w.
    The noise gets no gradient."""

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
    its x and w rows, the decoder's into its w, x_prev and z rows.
    Differentiable torch ops, so autograd routes the parameter cotangents
    back through them."""
    D, K = cfg.original_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    c = lambda t: t.contiguous()
    heads = lambda m, v: (c(torch.cat([params[m]["kernel"], params[v]["kernel"]], dim=1)),
                          c(torch.cat([params[m]["bias"], params[v]["bias"]])))
    wwz, bwz = heads("w_mean", "w_log_var")
    wzz, bzz = heads("z_mean", "z_log_var")
    hk, dk = params["h"]["kernel"], params["decoder_h"]["kernel"]
    return (c(x), c(x_prev) if cfg.use_x_prev else None, c(eps_w), c(eps_z),
            c(params["h_w"]["kernel"]), c(params["h_w"]["bias"]), wwz, bwz,
            c(hk[:D]), c(hk[D:]), c(params["h"]["bias"]), wzz, bzz,
            c(dk[:K]), c(dk[K:K + D]) if cfg.use_x_prev else None, c(dk[K + n_xp:]),
            c(params["decoder_h"]["bias"]), c(params["x_decoded_mean"]["kernel"]),
            c(params["x_decoded_mean"]["bias"]))


def vae_apply_core(params, cfg, x, x_prev, eps_w, eps_z) -> dict:
    """The whole cl_vae graph over a batch ``[B, D]`` through the
    dense-stack kernels.

    Drop-in for the ``encode_w`` -> logistic-normal sample -> ``encode_z``
    -> Gaussian sample -> ``decode`` composition at ``cfg.has_hidden``, with
    the noise given (``eps_w [B, K-1]``, ``eps_z [B, L]``); returns the named
    tensors of :func:`..models.cl_vae.apply`, z recomputed outside the core.
    The bf16 mode is not ported yet and raises."""
    if cfg.bf16_compute:
        raise NotImplementedError(BF16_TODO)
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
