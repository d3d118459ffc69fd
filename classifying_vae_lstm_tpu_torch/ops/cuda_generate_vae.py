"""Whole-generation cl_vae sampler: CUDA kernel wrappers and plain version.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_generate_vae.py``. Two
kernels in ``csrc/generate_cl_vae.cu`` run the entire autoregressive loop —
relu z-encoder hidden, z heads, z draw (or the prior's draw with
``use_z_prior``), relu decoder hidden over (w, z, the one-step-lagged
``x_prev_t``), sigmoid frame head, Bernoulli draw, feedback — in one launch:
``generate_kernel`` with every weight in shared memory, where they fit
(:func:`fits`), and ``generate_wide_kernel``, which reads the weights from L2
every step, for every other config: wider models, and models without hidden
layers (the z heads then read ``[x_prev, w]`` and the frame head ``[w,
x_prev_t, z]``, as JAX ``encode_z``/``decode`` at ``has_hidden=False``). The
sampler is a pure function of its pre-drawn noise (``eps`` for z, ``u`` for
the frames), so both kernels are held against
:func:`generate_cl_vae_batch_plain` on the card and the plain version
against the JAX package on the CPU, with the same noise.

:func:`generate_cl_vae_batch_cuda` launches a kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# launches since the counts were last set to 0: of either kernel, and of the
# wide kernel alone
LAUNCHES = 0
WIDE_LAUNCHES = 0
_launch_lock = threading.Lock()

_SONGS_PER_BLOCK = 2      # kSongs in csrc/generate_cl_vae.cu (both kernels)
_WIDE_THREADS = 512       # kWideThreads
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
_INT8_TODO = ("int8 weights (pallas_generate_vae.py:192 _make_kernel_int8) are not "
              "ported yet: ROADMAP Queue 2 item 4")


def pick_mode(cfg) -> str:
    """Weight precision: the checkpoint's numerics, f32 unless it computes
    its hidden layers in bf16 (``cfg.bf16_compute``). A config without hidden
    layers samples in f32, as the JAX package's XLA scan samples it. Never
    int8."""
    return "bf16" if cfg.bf16_compute and cfg.has_hidden else "f32"


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
    """Does the shared-memory kernel take the config: hidden layers, and the
    weights and one block's songs within Hopper's shared memory?"""
    return cfg.has_hidden and smem_bytes(cfg, mode) <= _SMEM_LIMIT


def kernel_for(cfg, mode: str | None = None) -> str:
    """The kernel a CUDA call launches: ``generate_cl_vae`` (weights in shared
    memory) where it :func:`fits`, ``generate_cl_vae_wide`` everywhere else."""
    return "generate_cl_vae" if fits(cfg, mode) else "generate_cl_vae_wide"


def _wide_state_floats(D: int, H: int, L: int, has_hidden: bool) -> int:
    return _SONGS_PER_BLOCK * (3 * D + L + (2 * H if has_hidden else 0))


def _wide_smem_bytes(D: int, H: int, L: int, has_hidden: bool, state_in_smem: bool) -> int:
    """Shared memory of one block of the wide kernel: the K-split partial
    sums and, where it fits, the tile's per-song state (both frames, the
    step's probabilities, z, and h_e and h_d with hidden layers)."""
    state = _wide_state_floats(D, H, L, has_hidden) if state_in_smem else 0
    return 4 * (_WIDE_THREADS * _SONGS_PER_BLOCK + state)


def _resolve_mode(cfg, mode):
    mode = mode or pick_mode(cfg)
    if mode == "int8":
        raise NotImplementedError(_INT8_TODO)
    if mode not in ("f32", "bf16"):
        raise ValueError(f"unknown mode {mode!r} (f32 or bf16)")
    return mode


def _pack(params, cfg, ws, mode: str) -> dict:
    """The kernels' operands: weights split by input rows (the large ones
    in the mode's type; the z rows in f32) and the per-song f32 folds of the
    w rows and biases. With hidden layers: ``encb = ws @ h.kernel[D:] +
    h.bias`` and ``decb = ws @ decoder_h.kernel[:K] + decoder_h.bias``.
    Without: ``zb = ws @ [z_mean | z_log_var].kernel[D:] + biases`` and ``xb
    = ws @ x_decoded_mean.kernel[:K] + x_decoded_mean.bias``."""
    D, K = cfg.original_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    wt = torch.bfloat16 if mode == "bf16" else torch.float32
    cast = lambda w: w.to(wt).contiguous()
    zk = torch.cat([params["z_mean"]["kernel"], params["z_log_var"]["kernel"]], 1)
    zbias = torch.cat([params["z_mean"]["bias"], params["z_log_var"]["bias"]])
    if not cfg.has_hidden:
        xk = params["x_decoded_mean"]["kernel"]
        return {
            "wz_t": cast(zk[:D].T),  # z heads' x_prev rows, transposed
            "zb": (torch.matmul(ws, zk[D:]) + zbias).contiguous(),
            "wx_xp": cast(xk[K : K + n_xp]) if cfg.use_x_prev else None,
            "wx_z": xk[K + n_xp :].contiguous(),  # f32 in every mode
            "xb": (torch.matmul(ws, xk[:K]) + params["x_decoded_mean"]["bias"]).contiguous(),
        }
    enc, dec = params["h"], params["decoder_h"]
    return {
        "wke": cast(enc["kernel"][:D]),
        # w rows and bias folded per song: plain f32 products (TF32 is off)
        "encb": (torch.matmul(ws, enc["kernel"][D:]) + enc["bias"]).contiguous(),
        # z heads transposed: one row per output, read along k by a warp
        "wz_t": cast(zk.T),
        "bz": zbias.contiguous(),
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
    frame. The z rows (of the decoder, or without hidden layers of the frame
    head) are added as L rank-1 terms, in order, as in the kernels. In bf16
    mode the large weights and their x/h operands are rounded to bf16 and
    multiplied in f32 — ``a.bfloat16().float() @ w.bfloat16().float()`` —
    since a CPU bf16 matmul would round its output to bf16, which the JAX
    ``preferred_element_type=f32`` product does not.
    """
    mode = _resolve_mode(cfg, mode)
    L = cfg.latent_dim
    w = {k: (v.float() if v is not None else None)
         for k, v in _pack(params, cfg, ws, mode).items()}
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    draw = lambda zmv, s: (eps[:, s] if use_z_prior
                           else zmv[:, :L] + torch.exp(zmv[:, L:] / 2) * eps[:, s])

    def rank1(acc, z, rows):
        for l in range(L):
            acc = acc + z[:, l : l + 1] * rows[l]
        return acc

    x_prev = x_prev_t = x_seeds
    outs = []
    for s in range(nsteps):
        if cfg.has_hidden:
            h_e = torch.relu(op(x_prev) @ w["wke"] + w["encb"])
            z = draw(op(h_e) @ w["wz_t"].T + w["bz"], s)
            z_d = rank1(w["decb"], z, w["wkd_z"])
            if cfg.use_x_prev:
                z_d = z_d + op(x_prev_t) @ w["wkd_x"]
            xm = torch.sigmoid(op(torch.relu(z_d)) @ w["wx"] + w["bx"])
        else:
            z = draw(op(x_prev) @ w["wz_t"].T + w["zb"], s)
            pre = rank1(w["xb"], z, w["wx_z"])
            if cfg.use_x_prev:
                pre = pre + op(x_prev_t) @ w["wx_xp"]
            xm = torch.sigmoid(pre)
        x_t = (u[:, s] < xm).to(xm.dtype)
        x_prev_t, x_prev = x_prev, x_t
        outs.append(xm if return_probs else x_t)
    return torch.stack(outs, dim=1)


_lib_lock = threading.Lock()
_lib = None


def _kernels():
    """The built library, its entry points' ctypes signatures set and its
    shared-memory layouts checked against :func:`_smem_bytes` and
    :func:`_wide_smem_bytes`."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("generate_cl_vae")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            smem = lib.cvl_generate_cl_vae_smem_bytes
            smem.argtypes, smem.restype = [I] * 5, LL
            for shape in ((88, 88, 4, 1, 0), (88, 256, 4, 1, 1), (12, 16, 3, 0, 0)):
                if smem(*shape) != _smem_bytes(*shape):
                    raise RuntimeError("shared-memory layout of csrc/generate_cl_vae.cu "
                                       f"differs from _smem_bytes at {shape}")
            wide = lib.cvl_generate_cl_vae_wide_smem_bytes
            wide.argtypes, wide.restype = [I] * 5, LL
            state = lib.cvl_generate_cl_vae_wide_state_floats
            state.argtypes, state.restype = [I] * 4, LL
            for shape in ((88, 512, 4, 1, 1), (1024, 1024, 16, 1, 0), (88, 0, 4, 0, 1)):
                if (wide(*shape) != _wide_smem_bytes(*shape)
                        or state(*shape[:4]) != _wide_state_floats(*shape[:4])):
                    raise RuntimeError("shared-memory layout of the wide kernel in "
                                       "csrc/generate_cl_vae.cu differs from _wide_smem_bytes "
                                       f"at {shape}")
            lib.cvl_generate_cl_vae.argtypes = [I] + [P] * 13 + [I] * 8 + [P]
            lib.cvl_generate_cl_vae_wide.argtypes = [I] + [P] * 16 + [I] * 11 + [P]
            lib.cvl_generate_cl_vae.restype = lib.cvl_generate_cl_vae_wide.restype = I
            _lib = lib
        return _lib


def _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode):
    """Raise on anything the kernels do not take."""
    if x_seeds.dim() != 2:
        raise ValueError(f"x_seeds must be [B, D], got {tuple(x_seeds.shape)}")
    B, D = x_seeds.shape
    H, L, K = cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    if nsteps < 1 or B < 1:
        raise ValueError(f"need B, nsteps >= 1 (got {B}, {nsteps})")
    if D != cfg.original_dim:
        raise ValueError(f"seed width {D} != original_dim {cfg.original_dim}")
    dev = x_seeds.device
    n_xp = D if cfg.use_x_prev else 0
    head_in = H if cfg.has_hidden else D + K
    expect = {
        "x_seeds": (x_seeds, (B, D)), "eps": (eps, (B, nsteps, L)),
        "u": (u, (B, nsteps, D)), "ws": (ws, (B, K)),
        "z_mean/kernel": (params["z_mean"]["kernel"], (head_in, L)),
        "z_mean/bias": (params["z_mean"]["bias"], (L,)),
        "z_log_var/kernel": (params["z_log_var"]["kernel"], (head_in, L)),
        "z_log_var/bias": (params["z_log_var"]["bias"], (L,)),
        "x_decoded_mean/kernel": (params["x_decoded_mean"]["kernel"],
                                  (H if cfg.has_hidden else K + n_xp + L, D)),
        "x_decoded_mean/bias": (params["x_decoded_mean"]["bias"], (D,)),
    }
    if cfg.has_hidden:
        expect.update({
            "h/kernel": (params["h"]["kernel"], (D + K, H)),
            "h/bias": (params["h"]["bias"], (H,)),
            "decoder_h/kernel": (params["decoder_h"]["kernel"], (K + n_xp + L, H)),
            "decoder_h/bias": (params["decoder_h"]["bias"], (H,)),
        })
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
    [B, nsteps, D]. CUDA tensors launch a kernel on the current stream (or
    raise: there is no fallback): the shared-memory kernel where it
    :func:`fits`, the wide kernel for every other width and for configs
    without hidden layers. CPU tensors take
    :func:`generate_cl_vae_batch_plain`. ``mode`` is ``"f32"`` or ``"bf16"``
    (default :func:`pick_mode`); ``"int8"`` is not ported yet.
    """
    global LAUNCHES, WIDE_LAUNCHES
    mode = _resolve_mode(cfg, mode)
    if x_seeds.device.type == "cpu":
        return generate_cl_vae_batch_plain(params, cfg, x_seeds, nsteps, eps, u, ws,
                                           use_z_prior=use_z_prior,
                                           return_probs=return_probs, mode=mode)
    if x_seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seeds.device}")
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    B, D = x_seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    dev = x_seeds.device
    lib = _kernels()
    wide = kernel_for(cfg, mode) == "generate_cl_vae_wide"
    flags = (int(cfg.use_x_prev), int(use_z_prior), int(return_probs))
    with torch.cuda.device(dev):
        w = _pack(params, cfg, ws, mode)
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16, seeds = int(mode == "bf16"), (x_seeds.data_ptr(), eps.data_ptr(), u.data_ptr())
        if not wide:
            err = lib.cvl_generate_cl_vae(
                bf16, *seeds, ptr(w["wke"]), ptr(w["encb"]), ptr(w["wz_t"]), ptr(w["bz"]),
                ptr(w["wkd_x"]), ptr(w["wkd_z"]), ptr(w["decb"]), ptr(w["wx"]), ptr(w["bx"]),
                out.data_ptr(), B, nsteps, D, H, L, *flags, stream)
        else:
            # past one block's shared memory the per-song state goes to a
            # global scratch, one slice per block
            hh = cfg.has_hidden
            state = None
            if _wide_smem_bytes(D, H, L, hh, True) > _SMEM_LIMIT:
                grid = -(-B // _SONGS_PER_BLOCK)
                state = torch.empty((grid, _wide_state_floats(D, H, L, hh)),
                                    dtype=torch.float32, device=dev)
            g = w.get
            err = lib.cvl_generate_cl_vae_wide(
                bf16, *seeds, ptr(g("wke")), ptr(g("encb")), ptr(g("wkd_x")), ptr(g("wkd_z")),
                ptr(g("decb")), ptr(w["wz_t"]), ptr(w["bz"] if hh else w["zb"]), ptr(g("wx")),
                ptr(g("wx_z")), ptr(g("wx_xp")), ptr(w["bx"] if hh else w["xb"]),
                out.data_ptr(), ptr(state), 0 if hh else 2 * L, 0 if hh else D, B, nsteps, D,
                H, L, int(hh), *flags, stream)
    if err != 0:
        raise RuntimeError(f"{kernel_for(cfg, mode)} kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
        WIDE_LAUNCHES += int(wide)
    return out
