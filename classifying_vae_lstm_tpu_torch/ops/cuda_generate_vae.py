"""Whole-generation cl_vae sampler: CUDA kernel wrapper and plain version.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_generate_vae.py``. The
kernel (``csrc/generate_cl_vae.cu``) runs the entire autoregressive loop —
relu z-encoder hidden, z heads, z draw (or the prior's draw with
``use_z_prior``), relu decoder hidden over (w, z, the one-step-lagged
``x_prev_t``), sigmoid frame head, Bernoulli draw, feedback — in one launch,
with every weight in shared memory. The sampler is a pure function of its
pre-drawn noise (``eps`` for z, ``u`` for the frames), so the kernel is held
against :func:`generate_cl_vae_batch_plain` on the card and the plain
version against the JAX package on the CPU, with the same noise.

:func:`generate_cl_vae_batch_cuda` launches the kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# launches of the kernel since the count was last set to 0
LAUNCHES = 0
_launch_lock = threading.Lock()

_SONGS_PER_BLOCK = 2      # kSongs in csrc/generate_cl_vae.cu
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
_INT8_TODO = ("int8 weights (pallas_generate_vae.py:192 _make_kernel_int8) are not "
              "ported yet: ROADMAP Queue 2")
_NO_HIDDEN = ("the cl_vae generation kernel needs hidden layers (intermediate_dim > 0), "
              "as the JAX kernel does; configs without them are not served yet "
              "(ROADMAP Queue 2 item 4)")


def pick_mode(cfg) -> str:
    """Weight precision: the checkpoint's numerics, f32 unless it computes
    its matmuls in bf16 (``cfg.bf16_compute``). Never int8."""
    return "bf16" if cfg.bf16_compute else "f32"


def _smem_bytes(D: int, H: int, L: int, use_x_prev: bool, bf16: bool) -> int:
    songs = _SONGS_PER_BLOCK * (2 * D + 4 * H + L)  # x_prev, x_prev_t, encb, decb, h_e, h_d, z
    floats = songs + L * H + 2 * L + D               # decoder z rows, z and frame biases
    weights = (2 + int(use_x_prev)) * D * H + 2 * L * H
    return 4 * floats + (2 if bf16 else 4) * weights


def smem_bytes(cfg, mode: str | None = None) -> int:
    """Shared memory of one block: every weight (the encoder x rows, the
    decoder x_prev rows, the frame head and the z heads in the mode's type;
    the decoder z rows and the biases in f32) and, for each song of the
    block's tile, its carried frames, folds, hidden layers and z."""
    return _smem_bytes(cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim,
                       cfg.use_x_prev, (mode or pick_mode(cfg)) == "bf16")


def fits(cfg, mode: str | None = None) -> bool:
    """Do the weights and one block's songs fit Hopper's shared memory?"""
    return cfg.has_hidden and smem_bytes(cfg, mode) <= _SMEM_LIMIT


def _resolve_mode(cfg, mode):
    if not cfg.has_hidden:
        raise ValueError(_NO_HIDDEN)
    mode = mode or pick_mode(cfg)
    if mode == "int8":
        raise NotImplementedError(_INT8_TODO)
    if mode not in ("f32", "bf16"):
        raise ValueError(f"unknown mode {mode!r} (f32 or bf16)")
    return mode


def _pack(params, cfg, ws, mode: str) -> dict:
    """The kernel's operands: weights split by input rows (the large ones
    in the mode's type) and the per-song f32 folds of the w rows and
    biases, ``encb = ws @ h.kernel[D:] + h.bias`` and ``decb = ws @
    decoder_h.kernel[:K] + decoder_h.bias``."""
    D, K = cfg.original_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    wt = torch.bfloat16 if mode == "bf16" else torch.float32
    enc, dec = params["h"], params["decoder_h"]
    cast = lambda w: w.to(wt).contiguous()
    return {
        "wke": cast(enc["kernel"][:D]),
        # w rows and bias folded per song: plain f32 products (TF32 is off)
        "encb": (torch.matmul(ws, enc["kernel"][D:]) + enc["bias"]).contiguous(),
        # z heads transposed: one row per output, read along k by a warp
        "wz_t": cast(torch.cat([params["z_mean"]["kernel"], params["z_log_var"]["kernel"]], 1).T),
        "bz": torch.cat([params["z_mean"]["bias"], params["z_log_var"]["bias"]]).contiguous(),
        "wkd_x": cast(dec["kernel"][K : K + n_xp]) if cfg.use_x_prev else None,
        "wkd_z": dec["kernel"][K + n_xp :].contiguous(),  # f32 in every mode
        "decb": (torch.matmul(ws, dec["kernel"][:K]) + dec["bias"]).contiguous(),
        "wx": cast(params["x_decoded_mean"]["kernel"]),
        "bx": params["x_decoded_mean"]["bias"].contiguous(),
    }


def generate_cl_vae_batch_plain(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                                use_z_prior: bool = False, return_probs: bool = False,
                                mode: str | None = None):
    """The kernel's function step by step in torch ops (its plain version).

    x_seeds [B, D] (one seed frame per song); eps [B, nsteps, L]; u [B,
    nsteps, D]; ws [B, K]; returns [B, nsteps, D] frames (probabilities with
    ``return_probs``). Both carried frames start as the seed; each step the
    lagged frame takes the old ``x_prev`` before ``x_prev`` takes the new
    frame. The decoder's z rows are added as L rank-1 terms, in order, as in
    the kernels. In bf16 mode the large weights and their x/h operands are
    rounded to bf16 and multiplied in f32 — ``a.bfloat16().float() @
    w.bfloat16().float()`` — since a CPU bf16 matmul would round its output
    to bf16, which the JAX ``preferred_element_type=f32`` product does not.
    """
    mode = _resolve_mode(cfg, mode)
    L = cfg.latent_dim
    w = {k: (v.float() if v is not None else None)
         for k, v in _pack(params, cfg, ws, mode).items()}
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    x_prev = x_prev_t = x_seeds
    outs = []
    for s in range(nsteps):
        h_e = torch.relu(op(x_prev) @ w["wke"] + w["encb"])
        zmv = op(h_e) @ w["wz_t"].T + w["bz"]
        z = eps[:, s] if use_z_prior else zmv[:, :L] + torch.exp(zmv[:, L:] / 2) * eps[:, s]
        z_d = w["decb"]
        for l in range(L):
            z_d = z_d + z[:, l : l + 1] * w["wkd_z"][l]
        if cfg.use_x_prev:
            z_d = z_d + op(x_prev_t) @ w["wkd_x"]
        xm = torch.sigmoid(op(torch.relu(z_d)) @ w["wx"] + w["bx"])
        x_t = (u[:, s] < xm).to(xm.dtype)
        x_prev_t, x_prev = x_prev, x_t
        outs.append(xm if return_probs else x_t)
    return torch.stack(outs, dim=1)


_lib_lock = threading.Lock()
_lib_fn = None


def _kernel():
    """The built kernel's C entry point, with its ctypes signature."""
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            lib = _build.load("generate_cl_vae")
            smem = lib.cvl_generate_cl_vae_smem_bytes
            smem.argtypes, smem.restype = [ctypes.c_int] * 5, ctypes.c_longlong
            for shape in ((88, 88, 4, 1, 0), (88, 256, 4, 1, 1), (12, 16, 3, 0, 0)):
                if smem(*shape) != _smem_bytes(*shape):
                    raise RuntimeError("shared-memory layout of csrc/generate_cl_vae.cu "
                                       f"differs from _smem_bytes at {shape}")
            fn = lib.cvl_generate_cl_vae
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [I] + [P] * 13 + [I] * 8 + [P]
            fn.restype = I
            _lib_fn = fn
        return _lib_fn


def _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode):
    """Raise on anything the kernel does not take."""
    if x_seeds.dim() != 2:
        raise ValueError(f"x_seeds must be [B, D], got {tuple(x_seeds.shape)}")
    B, D = x_seeds.shape
    H, L, K = cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    if nsteps < 1 or B < 1:
        raise ValueError(f"need B, nsteps >= 1 (got {B}, {nsteps})")
    if D != cfg.original_dim:
        raise ValueError(f"seed width {D} != original_dim {cfg.original_dim}")
    if not fits(cfg, mode):
        raise ValueError(f"weights and one block's songs need {smem_bytes(cfg, mode)} B of "
                         f"shared memory (limit {_SMEM_LIMIT}); hidden {H} is too wide for "
                         "this kernel in mode " + mode)
    dev = x_seeds.device
    n_xp = D if cfg.use_x_prev else 0
    expect = {
        "x_seeds": (x_seeds, (B, D)), "eps": (eps, (B, nsteps, L)),
        "u": (u, (B, nsteps, D)), "ws": (ws, (B, K)),
        "h/kernel": (params["h"]["kernel"], (D + K, H)),
        "h/bias": (params["h"]["bias"], (H,)),
        "z_mean/kernel": (params["z_mean"]["kernel"], (H, L)),
        "z_mean/bias": (params["z_mean"]["bias"], (L,)),
        "z_log_var/kernel": (params["z_log_var"]["kernel"], (H, L)),
        "z_log_var/bias": (params["z_log_var"]["bias"], (L,)),
        "decoder_h/kernel": (params["decoder_h"]["kernel"], (K + n_xp + L, H)),
        "decoder_h/bias": (params["decoder_h"]["bias"], (H,)),
        "x_decoded_mean/kernel": (params["x_decoded_mean"]["kernel"], (H, D)),
        "x_decoded_mean/bias": (params["x_decoded_mean"]["bias"], (D,)),
    }
    for name, (t, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x_seeds on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def generate_cl_vae_batch_cuda(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                               use_z_prior: bool = False, return_probs: bool = False,
                               mode: str | None = None):
    """Kernel counterpart of ``generate_cl_vae_batch_pallas`` (same signature).

    x_seeds [B, D]; eps [B, nsteps, L]; u [B, nsteps, D]; ws [B, K]; returns
    [B, nsteps, D]. CUDA tensors launch the kernel on the current stream (or
    raise: there is no fallback); CPU tensors take
    :func:`generate_cl_vae_batch_plain`. ``mode`` is ``"f32"`` or ``"bf16"``
    (default :func:`pick_mode`); ``"int8"`` is not ported yet, and a config
    without hidden layers raises ``ValueError`` as the JAX kernel does.
    """
    global LAUNCHES
    mode = _resolve_mode(cfg, mode)
    if x_seeds.device.type == "cpu":
        return generate_cl_vae_batch_plain(params, cfg, x_seeds, nsteps, eps, u, ws,
                                           use_z_prior=use_z_prior,
                                           return_probs=return_probs, mode=mode)
    if x_seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seeds.device}")
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    B, D = x_seeds.shape
    dev = x_seeds.device
    fn = _kernel()
    with torch.cuda.device(dev):
        w = _pack(params, cfg, ws, mode)
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(int(mode == "bf16"), x_seeds.data_ptr(), eps.data_ptr(), u.data_ptr(),
                 ptr(w["wke"]), ptr(w["encb"]), ptr(w["wz_t"]), ptr(w["bz"]),
                 ptr(w["wkd_x"]), ptr(w["wkd_z"]), ptr(w["decb"]), ptr(w["wx"]),
                 ptr(w["bx"]), out.data_ptr(),
                 B, nsteps, D, cfg.intermediate_dim, cfg.latent_dim,
                 int(cfg.use_x_prev), int(use_z_prior), int(return_probs),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"generate_cl_vae kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
    return out
