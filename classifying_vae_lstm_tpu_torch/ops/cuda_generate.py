"""Whole-generation cl_vrnn sampler: CUDA kernel wrapper and plain version.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_generate.py``. The
kernel (``csrc/generate_cl_vrnn.cu``) runs the entire autoregressive loop —
encoder cell, z heads, z draw, decoder cell, sigmoid frame head, Bernoulli
draw, feedback — in one launch. The sampler is a pure function of its
pre-drawn noise (``eps`` for z, ``u`` for the frames), so the kernel is held
against :func:`generate_cl_vrnn_batch_plain` on the card and the plain
version against the JAX package on the CPU, with the same noise.

:func:`generate_cl_vrnn_batch_cuda` launches the kernel for CUDA tensors
(or raises) and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .lstm import _gates

# launches of the kernel since the count was last set to 0
LAUNCHES = 0
_launch_lock = threading.Lock()

_SONGS_PER_BLOCK = 4      # kSongs in csrc/generate_cl_vrnn.cu
_UNITS_PER_PASS = 256     # kUnits in csrc/generate_cl_vrnn.cu
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
_INT8_TODO = ("int8 weights (pallas_generate.py:211 _make_kernel_int8) are not "
              "ported yet: ROADMAP Queue 2")


def pick_mode(cfg) -> str:
    """Weight precision: the checkpoint's numerics, f32 unless it computes
    its matmuls in bf16 (``cfg.bf16_compute``). Never int8."""
    return "bf16" if cfg.bf16_compute else "f32"


def _smem_bytes(D: int, H: int, L: int) -> int:
    return ((D + 6 * H + L) * _SONGS_PER_BLOCK + 4 * _SONGS_PER_BLOCK * _UNITS_PER_PASS) * 4


def smem_bytes(cfg) -> int:
    """Shared memory of one block: x_in, h (two buffers) and c of both
    cells, and z, for each song of the block's tile, plus the gate stages'
    partial sums."""
    return _smem_bytes(cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim)


def fits(cfg) -> bool:
    """Does one block's carried state fit Hopper's shared memory?"""
    return smem_bytes(cfg) <= _SMEM_LIMIT


def _resolve_mode(cfg, mode):
    mode = mode or pick_mode(cfg)
    if mode == "int8":
        raise NotImplementedError(_INT8_TODO)
    if mode not in ("f32", "bf16"):
        raise ValueError(f"unknown mode {mode!r} (f32 or bf16)")
    return mode


def _pack(params, cfg, ws, D: int, mode: str) -> dict:
    """The kernel's operands: weights split by input rows (in the mode's
    type) and the per-song f32 folds of the w rows and biases."""
    L = cfg.latent_dim
    wt = torch.bfloat16 if mode == "bf16" else torch.float32
    enc, dec = params["encoder_h"], params["decoder_h"]
    n_xp = D if cfg.use_x_prev else 0
    cast = lambda w: w.to(wt).contiguous()
    return {
        "wke_x": cast(enc["kernel"][:D]),
        "rke": cast(enc["recurrent_kernel"]),
        # w rows and bias folded per song: plain f32 products (TF32 is off)
        "encb": (torch.matmul(ws, enc["kernel"][D:]) + enc["bias"]).contiguous(),
        # heads transposed: one row per output column, read along k by a warp
        "wz_t": cast(torch.cat([params["Z_mean"]["kernel"], params["Z_log_var"]["kernel"]], 1).T),
        "bz": torch.cat([params["Z_mean"]["bias"], params["Z_log_var"]["bias"]]).contiguous(),
        "wkd_x": cast(dec["kernel"][:n_xp]) if cfg.use_x_prev else None,
        "wkd_z": cast(dec["kernel"][n_xp : n_xp + L]),
        "rkd": cast(dec["recurrent_kernel"]),
        "decb": (torch.matmul(ws, dec["kernel"][n_xp + L :]) + dec["bias"]).contiguous(),
        "wx_t": cast(params["X_decoded_mean"]["kernel"].T),
        "bx": params["X_decoded_mean"]["bias"].contiguous(),
    }


def generate_cl_vrnn_batch_plain(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                                 return_probs: bool = False, mode: str | None = None):
    """The kernel's function step by step in torch ops (its plain version).

    x_seeds [B, Tseed, D]; eps [B, total, L]; u [B, total, D]; ws [B, K];
    returns [B, nsteps, D] post-seed frames (probabilities with
    ``return_probs``). In bf16 mode the weights and the x/h operands are
    rounded to bf16 and multiplied in f32 — ``a.bfloat16().float() @
    w.bfloat16().float()`` — since a CPU bf16 matmul would round its output
    to bf16, which the JAX ``preferred_element_type=f32`` product does not.
    """
    mode = _resolve_mode(cfg, mode)
    B, Tseed, D = x_seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    w = _pack(params, cfg, ws, D, mode)
    f = {k: (v.float() if v is not None else None) for k, v in w.items()}
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    h_e = c_e = h_d = c_d = x_seeds.new_zeros((B, H))
    x_prev = x_seeds.new_zeros((B, D))
    outs = []
    for t in range(Tseed + nsteps):
        x_in = x_seeds[:, t] if t < Tseed else x_prev
        z_e = op(x_in) @ f["wke_x"] + f["encb"] + op(h_e) @ f["rke"]
        h_e, c_e = _gates(z_e, c_e, H)
        zmv = op(h_e) @ f["wz_t"].T + f["bz"]
        z = zmv[:, :L] + torch.exp(zmv[:, L:] / 2) * eps[:, t]
        z_d = f["decb"] + op(h_d) @ f["rkd"] + z @ f["wkd_z"]
        if cfg.use_x_prev:
            z_d = z_d + op(x_in) @ f["wkd_x"]
        h_d, c_d = _gates(z_d, c_d, H)
        xm = torch.sigmoid(op(h_d) @ f["wx_t"].T + f["bx"])
        x_prev = (u[:, t] < xm).to(xm.dtype)
        if t >= Tseed:
            outs.append(xm if return_probs else x_prev)
    return torch.stack(outs, dim=1)


_lib_lock = threading.Lock()
_lib_fn = None


def _kernel():
    """The built kernel's C entry point, with its ctypes signature."""
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            lib = _build.load("generate_cl_vrnn")
            smem = lib.cvl_generate_cl_vrnn_smem_bytes
            smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
            if smem(88, 256, 8) != _smem_bytes(88, 256, 8):
                raise RuntimeError("shared-memory layout of csrc/generate_cl_vrnn.cu "
                                   "differs from _smem_bytes")
            fn = lib.cvl_generate_cl_vrnn
            P, I = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [I] + [P] * 15 + [I] * 8 + [P]
            fn.restype = I
            _lib_fn = fn
        return _lib_fn


def _check(params, cfg, x_seeds, nsteps, eps, u, ws):
    """Raise on anything the kernel does not take."""
    if x_seeds.dim() != 3:
        raise ValueError(f"x_seeds must be [B, Tseed, D], got {tuple(x_seeds.shape)}")
    B, Tseed, D = x_seeds.shape
    H, L, K = cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    total = Tseed + nsteps
    if nsteps < 1 or Tseed < 1 or B < 1:
        raise ValueError(f"need B, Tseed, nsteps >= 1 (got {B}, {Tseed}, {nsteps})")
    if D != cfg.original_dim:
        raise ValueError(f"seed width {D} != original_dim {cfg.original_dim}")
    if not fits(cfg):
        raise ValueError(f"state of one block needs {smem_bytes(cfg)} B of shared memory "
                         f"(limit {_SMEM_LIMIT}); hidden {H} is too wide for this kernel")
    dev = x_seeds.device
    n_xp = D if cfg.use_x_prev else 0
    expect = {
        "x_seeds": (x_seeds, (B, Tseed, D)), "eps": (eps, (B, total, L)),
        "u": (u, (B, total, D)), "ws": (ws, (B, K)),
        "encoder_h/kernel": (params["encoder_h"]["kernel"], (D + K, 4 * H)),
        "encoder_h/recurrent_kernel": (params["encoder_h"]["recurrent_kernel"], (H, 4 * H)),
        "encoder_h/bias": (params["encoder_h"]["bias"], (4 * H,)),
        "decoder_h/kernel": (params["decoder_h"]["kernel"], (n_xp + L + K, 4 * H)),
        "decoder_h/recurrent_kernel": (params["decoder_h"]["recurrent_kernel"], (H, 4 * H)),
        "decoder_h/bias": (params["decoder_h"]["bias"], (4 * H,)),
        "Z_mean/kernel": (params["Z_mean"]["kernel"], (H, L)),
        "Z_mean/bias": (params["Z_mean"]["bias"], (L,)),
        "Z_log_var/kernel": (params["Z_log_var"]["kernel"], (H, L)),
        "Z_log_var/bias": (params["Z_log_var"]["bias"], (L,)),
        "X_decoded_mean/kernel": (params["X_decoded_mean"]["kernel"], (H, D)),
        "X_decoded_mean/bias": (params["X_decoded_mean"]["bias"], (D,)),
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


def generate_cl_vrnn_batch_cuda(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                                return_probs: bool = False, mode: str | None = None):
    """Kernel counterpart of ``generate_cl_vrnn_batch_pallas`` (same signature).

    x_seeds [B, Tseed, D]; eps [B, total, L]; u [B, total, D]; ws [B, K];
    returns [B, nsteps, D]. CUDA tensors launch the kernel on the current
    stream (or raise: there is no fallback); CPU tensors take
    :func:`generate_cl_vrnn_batch_plain`. ``mode`` is ``"f32"`` or ``"bf16"``
    (default :func:`pick_mode`); ``"int8"`` is not ported yet.
    """
    global LAUNCHES
    mode = _resolve_mode(cfg, mode)
    if x_seeds.device.type == "cpu":
        return generate_cl_vrnn_batch_plain(params, cfg, x_seeds, nsteps, eps, u, ws,
                                            return_probs=return_probs, mode=mode)
    if x_seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seeds.device}")
    _check(params, cfg, x_seeds, nsteps, eps, u, ws)
    B, Tseed, D = x_seeds.shape
    dev = x_seeds.device
    fn = _kernel()
    with torch.cuda.device(dev):
        w = _pack(params, cfg, ws, D, mode)
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(int(mode == "bf16"), x_seeds.data_ptr(), eps.data_ptr(), u.data_ptr(),
                 ptr(w["wke_x"]), ptr(w["rke"]), ptr(w["encb"]), ptr(w["wz_t"]), ptr(w["bz"]),
                 ptr(w["wkd_x"]), ptr(w["wkd_z"]), ptr(w["rkd"]), ptr(w["decb"]),
                 ptr(w["wx_t"]), ptr(w["bx"]), out.data_ptr(),
                 B, Tseed, Tseed + nsteps, D, cfg.intermediate_dim, cfg.latent_dim,
                 int(cfg.use_x_prev), int(return_probs),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"generate_cl_vrnn kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
    return out
