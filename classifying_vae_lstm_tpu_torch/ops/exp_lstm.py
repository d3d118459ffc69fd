"""The step-decomposition probes of ``tools/``: CUDA wrappers, plain
versions and launch counts.

Counterparts of the Pallas kernels that three TPU tools build around their
own kernel bodies (``csrc/exp_lstm.cu`` has the CUDA side and its design):

* ``tools/exp_h512_ablation.py`` splits a bf16 training step at H=512 into
  parts, one microkernel a part: the serial recurrent product chain
  (:func:`chain_mm`), the same chain as two independent half-row chains
  (:func:`chain_mm_x2`), two full-width chains, independent
  (:func:`chain_mm_x2_fullwidth`) or with the two-cell coupling
  (:func:`chain_mm_encdec`), the forward and backward gate math
  (:func:`gates_fwd`, :func:`gates_bwd`) and the weight-gradient products
  off the chain (:func:`offchain_mm`);
* ``tools/exp_lstm_interleave.py`` pipelines the unfused training forward
  over two half-batches (:func:`lstm_interleave_train_fwd`);
* ``tools/repro_full_bwd_fault.py`` checks a reverse-walk stub at a batch
  that its 16-row tile does not divide, one feature at a time
  (:func:`mini_walk`, the cases :data:`MINI_CASES`).

Each function computes what its TPU kernel computes as the TPU runs it. The
h512 kernels set their scratch at grid step 0 only and the TPU walks the
grid in order, so block b of the batch starts from block b-1's final state:
a chain returns, for block b, the state after (b+1)*T steps of block 0's
rows of h0 (later blocks' h0 rows are never read), the gates kernels carry
their state over their own z blocks, and :func:`offchain_mm` multiplies
every block's hp and xp by block 0's dz. ``B`` must be a multiple of the
block ``bb`` (the tools' grid is ``B // bb``).

Each wrapper launches its kernel for CUDA tensors (or raises: there is no
fallback) and takes its plain version, the function of the same name with
``_plain``, only for CPU tensors. It checks its arguments once a signature
and adds one to its count, ``<NAME>_LAUNCHES``, where it launches (the mini
walk's call is one launch of the walk and one a sum of its tiles'
accumulators, counted as one).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._checks import _check, _device_of
from .lstm import _gates, bf16_operand
from .lstm_seq import interleave_gates, round8, tc_h_operand

T_STEPS = 16  # the tools' T
MINI_CASES = ("min_base", "min_dx_in", "min_dx_out", "min_dw", "min_db", "min_all")
KERNELS = ("chain_mm", "chain_mm_x2", "chain_mm_x2_fullwidth", "chain_mm_encdec", "gates_fwd",
           "gates_bwd", "offchain_mm", "interleave", "mini_walk")

# launches since the counts were last set to 0, one per wrapper call
CHAIN_MM_LAUNCHES = 0
CHAIN_MM_X2_LAUNCHES = 0
CHAIN_MM_X2_FULLWIDTH_LAUNCHES = 0
CHAIN_MM_ENCDEC_LAUNCHES = 0
GATES_FWD_LAUNCHES = 0
GATES_BWD_LAUNCHES = 0
OFFCHAIN_MM_LAUNCHES = 0
INTERLEAVE_LAUNCHES = 0
MINI_WALK_LAUNCHES = 0

_launch_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib = None
_checked: set = set()
_coop_blocks: dict = {}

# the cooperative kernels, as cvl_exp_coop_blocks names them
_COOP = {"chain_mm": 0, "chain_mm_x2": 1, "chain_mm_x2_fullwidth": 2, "chain_mm_encdec": 3,
         "interleave": 4}
_TILE_M, _TILE_N = 64, 128  # csrc/mma_bf16.cuh's block tile
_MINI_SMEM = 227 * 1024  # the shared memory a block may opt in to on sm_90


def counts() -> dict:
    """Launches of each kernel since :func:`reset_counts`."""
    return {k: globals()[f"{k.upper()}_LAUNCHES"] for k in KERNELS}


def reset_counts():
    with _launch_lock:
        for k in KERNELS:
            globals()[f"{k.upper()}_LAUNCHES"] = 0


def _count(which: str):
    with _launch_lock:
        globals()[f"{which.upper()}_LAUNCHES"] += 1


def _blocks(x, bb: int, groups: int = 1):
    """(B, width, nb) of a ``[B, width]`` input split into blocks of bb rows."""
    B = x.shape[0]
    if bb < groups or bb % groups or B % bb:
        raise ValueError(f"B={B} must be a multiple of bb={bb}"
                         + (f", and bb of {groups}" if groups > 1 else ""))
    return B, x.shape[1], B // bb


# ------------------------------------------------------------ plain versions


def _chain_steps(h, rk, H, nb, T, groups=1):
    # nb*T steps of h <- (bf16(h) @ rk)[:, :H] * 0.02, the whole 4H-wide
    # product computed as the TPU kernel computes it; the groups' rows apart
    rk = rk.float()
    parts = h.chunk(groups)
    outs = []
    for _ in range(nb):
        for _ in range(T):
            parts = [(bf16_operand(p) @ rk)[:, :H] * 0.02 for p in parts]
        outs.append(torch.cat(parts))
    return torch.cat(outs)


def chain_mm_plain(h0, rk, bb, T=T_STEPS):
    """``_chain_mm_kernel``'s function: h0 ``[B, H]`` f32, rk ``[H, 4H]``
    bf16 -> ``[B, H]`` f32, block b the state after (b+1)*T steps of
    ``h <- (bf16(h) @ rk)[:, :H] * 0.02`` from ``h0[:bb]``."""
    B, H, nb = _blocks(h0, bb)
    return _chain_steps(h0[:bb].float(), rk, H, nb, T)


def chain_mm_x2_plain(h0, rk, bb, T=T_STEPS):
    """``_chain_mm_x2_kernel``'s function: :func:`chain_mm_plain` with each
    step's product issued as two half-row products."""
    B, H, nb = _blocks(h0, bb, 2)
    return _chain_steps(h0[:bb].float(), rk, H, nb, T, groups=2)


def _pair_plain(h0, g0, rkA, rkB, bb, T, coupled):
    B, H, nb = _blocks(h0, bb)
    rkA, rkB = rkA.float(), rkB.float()
    hA, hB = h0[:bb].float(), g0[:bb].float()
    outA, outB = [], []
    for _ in range(nb):
        for _ in range(T):
            hA = (bf16_operand(hA) @ rkA)[:, :H] * 0.02
            opB = hB + 0.001 * hA if coupled else hB
            hB = (bf16_operand(opB) @ rkB)[:, :H] * 0.02
        outA.append(hA)
        outB.append(hB)
    return torch.cat(outA), torch.cat(outB)


def chain_mm_x2_fullwidth_plain(h0, g0, rkA, rkB, bb, T=T_STEPS):
    """``_chain_mm_x2_full_kernel``'s function: two independent chains, A
    from ``h0[:bb]`` with rkA and B from ``g0[:bb]`` with rkB -> (A, B),
    each ``[B, H]`` as :func:`chain_mm_plain`."""
    return _pair_plain(h0, g0, rkA, rkB, bb, T, coupled=False)


def chain_mm_encdec_plain(h0, g0, rkA, rkB, bb, T=T_STEPS):
    """``_chain_mm_encdec_kernel``'s function: the two chains of
    :func:`chain_mm_x2_fullwidth_plain`, B's step t on ``bf16(hB + 0.001 *
    hA)`` with hA A's output of the same step."""
    return _pair_plain(h0, g0, rkA, rkB, bb, T, coupled=True)


def chain_plain_blockwise(name, got, *args, bb, T=T_STEPS):
    """The plain version of chain ``name`` run one output block at a time,
    block b from the state the kernel's output ``got`` holds for block b-1
    (block 0 from the inputs). A chain rounds h to bf16 every step, so over
    nb*T steps a summation order that flips one rounding moves the whole
    chain by a few bf16 steps; started from the kernel's own state, each
    block's T steps are held apart. ``args`` are the plain version's
    inputs; returns what it returns."""
    plain = globals()[f"{name}_plain"]
    pair = isinstance(got, tuple)
    n = 2 if pair else 1  # the states: (h0, g0) or h0
    outs = []
    for b in range(args[0].shape[0] // bb):
        starts = args[:n] if b == 0 else (got if pair else (got,))
        rows = slice(max(b - 1, 0) * bb, max(b, 1) * bb)
        outs.append(plain(*(s[rows] for s in starts), *args[n:], bb, T))
    if pair:
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _hs(v):
    return torch.clamp(0.2 * v + 0.5, 0.0, 1.0)


def gates_fwd_plain(z0, bb, T=T_STEPS):
    """``_gates_fwd_kernel``'s function: z0 ``[B, 4H]`` f32 -> ``[B, H]``.
    The state c ``[bb, H]`` starts at 0; per block b and step, z = z0's
    block b + c[:, :1], the Keras gates and c <- o * tanh(f * c + i * g);
    block b of the output is c after block b."""
    B, H4, nb = _blocks(z0, bb)
    H = H4 // 4
    c = torch.zeros((bb, H), dtype=torch.float32, device=z0.device)
    outs = []
    for b in range(nb):
        zb = z0[b * bb:(b + 1) * bb].float()
        for _ in range(T):
            z = zb + c[:, :1]
            i, f, g, o = _hs(z[:, :H]), _hs(z[:, H:2 * H]), torch.tanh(z[:, 2 * H:3 * H]), \
                _hs(z[:, 3 * H:])
            c = o * torch.tanh(f * c + i * g)
        outs.append(c)
    return torch.cat(outs)


def gates_bwd_plain(z0, bb, T=T_STEPS):
    """``_gates_bwd_kernel``'s function: z0 ``[B, 4H]`` f32 -> ``[B, H]``.
    The state d ``[bb, H]`` starts at 0.1; per block b and step, the gate
    gradients of z0's block b with dh = d, folded back into d."""
    B, H4, nb = _blocks(z0, bb)
    H = H4 // 4
    d = torch.full((bb, H), 0.1, dtype=torch.float32, device=z0.device)
    band = lambda v: ((v > -2.5) & (v < 2.5)).float()  # noqa: E731
    outs = []
    for b in range(nb):
        z = z0[b * bb:(b + 1) * bb].float()
        zi, zf, zg, zo = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
        i, f, g, o = _hs(zi), _hs(zf), torch.tanh(zg), _hs(zo)
        for _ in range(T):
            dh = d
            tc = torch.tanh(f * 0.5 + i * g)
            do = dh * tc
            dc = dh * o * (1.0 - tc * tc) + d * f
            di, dg, df = dc * g, dc * i, dc * 0.5
            d = (0.2 * di * band(zi) + 0.2 * df * band(zf) + dg * (1.0 - g * g)
                 + 0.2 * do * band(zo))
        outs.append(d)
    return torch.cat(outs)


def offchain_mm_plain(hp, dz, xp, bb, T=T_STEPS):
    """``_offchain_mm_kernel``'s function: hp ``[B, H]``, dz ``[B, 4H]``, xp
    ``[B, IN]`` bf16 -> (drk ``[H, 4H]``, dw ``[IN, 4H]``) f32, the sums over
    the blocks b and T steps of ``hp_bᵀ @ dz_0`` and ``xp_bᵀ @ dz_0`` (dz_0
    block 0's rows of dz)."""
    B, H, nb = _blocks(hp, bb)
    d = dz[:bb].float()
    drk = torch.zeros((H, dz.shape[1]), dtype=torch.float32, device=hp.device)
    dw = torch.zeros((xp.shape[1], dz.shape[1]), dtype=torch.float32, device=hp.device)
    for b in range(nb):
        hb, xb = hp[b * bb:(b + 1) * bb].float(), xp[b * bb:(b + 1) * bb].float()
        for _ in range(T):
            drk += hb.T @ d
            dw += xb.T @ d
    return drk, dw


def lstm_interleave_train_fwd_plain(xz, rk, h0, c0):
    """``_interleaved_kernel``'s function, the unfused training forward
    (``lstm_seq.lstm_seq_xz_train_fwd_plain``'s results) written as the TPU
    kernel pipelines it: the batch in halves A (the first ``ceil(B/2)``
    rows) and B, A's product for step t+1 taken before B's gates of step t.
    xz ``[T, B, 4H]`` and rk ``[H, 4H]`` at the stream type, h0/c0 ``[B,
    H]`` f32 -> (h, c ``[T, B, H]`` f32, z ``[T, B, 4H]`` at xz's type); in
    bf16 h is rounded as the operand and z as it is stored."""
    T, B, H4 = xz.shape
    H = H4 // 4
    op = bf16_operand if xz.dtype == torch.bfloat16 else (lambda a: a)
    rkf = rk.float()
    halves = (slice(0, (B + 1) // 2), slice((B + 1) // 2, B))
    state = [(h0[s].float(), c0[s].float()) for s in halves]
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=xz.device)  # noqa: E731
    h, c, z = new(T, B, H), new(T, B, H), new(T, B, H4)
    zA = xz[0, halves[0]].float() + op(state[0][0]) @ rkf
    for t in range(T):
        zB = xz[t, halves[1]].float() + op(state[1][0]) @ rkf
        for k, zk in ((0, zA), (1, zB)):
            hk, ck = _gates(zk, state[k][1], H)
            state[k] = (hk, ck)
            s = halves[k]
            h[t, s], c[t, s], z[t, s] = hk, ck, zk
            if k == 0 and t + 1 < T:
                zA = xz[t + 1, halves[0]].float() + op(hk) @ rkf
    return h, c, z.to(xz.dtype)


def _mini_writes(case):
    return (case in ("min_dx_out", "min_all"), case in ("min_dw", "min_all"),
            case in ("min_db", "min_all"))


def mini_walk_plain(case, z, h, x, bb=16):
    """``_mini_kernel``'s function for one case of :data:`MINI_CASES`: z
    ``[T, B, 4H]``, h ``[T, B, H]``, x ``[T, B, IN]`` bf16 -> (dx ``[T, B,
    IN]`` bf16, drk ``[H, 4H]``, dw, db ``[1, 4H]``), the outputs the case
    does not write None. Per tile of bb rows, a reverse walk from a zero dh:
    ``dz = tanh(z[t]) + dh @ ones(H, 4H)``, dh <- dz[:, :H], drk +=
    h[t]ᵀ dz, dw += (x[t] at min_all, else h[t])ᵀ dz, db += the column sums
    of dz, dx[t] = bf16(dz[:, :IN] + x[t]); the rows past B of the last tile
    are masked to 0, so only rows < B are walked."""
    if case not in MINI_CASES:
        raise ValueError(f"case {case!r} (one of {MINI_CASES})")
    T, B, H4 = z.shape
    H, IN = h.shape[-1], x.shape[-1]
    dev = z.device
    has_dx, has_dw, has_db = _mini_writes(case)
    new = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    ones = torch.ones((H, H4), dtype=torch.float32, device=dev)
    dx = torch.zeros((T, B, IN), dtype=torch.bfloat16, device=dev) if has_dx else None
    drk = new(H, H4)
    dw = new(IN if case == "min_all" else H, H4) if has_dw else None
    db = new(1, H4) if has_db else None
    for r0 in range(0, B, bb):
        rows = slice(r0, min(r0 + bb, B))
        dh = new(rows.stop - r0, H)
        for t in reversed(range(T)):
            dz = torch.tanh(z[t, rows].float()) + dh @ ones
            hp, xp = h[t, rows].float(), x[t, rows].float()
            if has_dx:
                dx[t, rows] = (dz[:, :IN] + xp).to(torch.bfloat16)
            dh = dz[:, :H]
            drk += hp.T @ dz
            if has_dw:
                dw += (xp if case == "min_all" else hp).T @ dz
            if has_db:
                db += dz.sum(0, keepdim=True)
    return dx, drk, dw, db


# ------------------------------------------------------------ CUDA wrappers


def _kernels():
    """The built ``csrc/exp_lstm.cu`` with its ctypes signatures."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("exp_lstm")
            P, I = ctypes.c_void_p, ctypes.c_int
            argtypes = {"coop_blocks": [I], "chain": [P] * 5 + [I] * 6,
                        "pair": [P] * 10 + [I] * 6, "gates": [P] * 2 + [I] * 5,
                        "offchain": [P] * 5 + [I] * 5, "interleave": [P] * 8 + [I] * 5,
                        "mini": [I] + [P] * 10 + [I] * 4}
            for name, types in argtypes.items():
                fn = getattr(lib, f"cvl_exp_{name}")
                fn.argtypes = types + ([] if name == "coop_blocks" else [P])  # the stream last
                fn.restype = I
            _lib = lib
        return _lib


def _raise_if(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _check_once(sig, checks):
    """Run ``checks`` the first time the call signature ``sig`` is seen."""
    if sig not in _checked:
        checks()
        _checked.add(sig)


def _sig(name, *tensors, **ints):
    return (name, tuple((tuple(t.shape), t.dtype, t.device, t.is_contiguous())
                        for t in tensors), tuple(sorted(ints.items())))


def _grid(name: str, dev, items: int, groups: int = 1) -> int:
    """Blocks of a cooperative launch: each group at most its ``items`` and
    all of them resident on the card at once."""
    key = (name, dev.index)
    if key not in _coop_blocks:
        _coop_blocks[key] = _kernels().cvl_exp_coop_blocks(_COOP[name])
    per = min(items, _coop_blocks[key] // groups)
    if per < 1:
        raise RuntimeError(f"{name}: the card holds no cooperative grid of this kernel")
    return groups * per


def _items(rows: int, cols: int) -> int:
    return -(-rows // _TILE_M) * -(-cols // _TILE_N)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _chain(name, h0, rk, bb, T, groups):
    B, H, nb = _blocks(h0, bb, groups)
    dev = h0.device
    _check_once(_sig(name, h0, rk, bb=bb, T=T), lambda: _check(
        dev, {"h0": (h0, (B, H)), "rk": (rk, (H, 4 * H))}, bf16=frozenset({"rk"})))
    lib = _kernels()
    with torch.cuda.device(dev):
        grid = _grid(name, dev, _items(bb // groups, 4 * H), groups)
        hb = torch.zeros((2, bb, H), dtype=torch.bfloat16, device=dev)
        hb[0] = h0[:bb]
        out = torch.empty((B, H), dtype=torch.float32, device=dev)
        sink = torch.empty(grid * 128, dtype=torch.float32, device=dev)
        bar = torch.zeros(groups, dtype=torch.int32, device=dev)
        err = lib.cvl_exp_chain(rk.data_ptr(), hb.data_ptr(), out.data_ptr(), sink.data_ptr(),
                                bar.data_ptr(), bb, H, nb, T, groups, grid, _stream(dev))
    _raise_if(err, name)
    _count(name)
    return out


def chain_mm(h0, rk, bb, T=T_STEPS):
    """:func:`chain_mm_plain`'s function. CUDA tensors launch
    ``chain_kernel<1>`` (one cooperative launch for all nb*T steps) or
    raise; CPU tensors take the plain version."""
    if _device_of(h0).type == "cpu":
        return chain_mm_plain(h0, rk, bb, T)
    return _chain("chain_mm", h0, rk, bb, T, 1)


def chain_mm_x2(h0, rk, bb, T=T_STEPS):
    """:func:`chain_mm_x2_plain`'s function. CUDA tensors launch
    ``chain_kernel<2>`` (two groups of blocks, a half of the rows and a
    barrier each) or raise; CPU tensors take the plain version."""
    if _device_of(h0).type == "cpu":
        return chain_mm_x2_plain(h0, rk, bb, T)
    return _chain("chain_mm_x2", h0, rk, bb, T, 2)


def _pair(name, h0, g0, rkA, rkB, bb, T, coupled):
    B, H, nb = _blocks(h0, bb)
    dev = h0.device
    _check_once(_sig(name, h0, g0, rkA, rkB, bb=bb, T=T), lambda: _check(
        dev, {"h0": (h0, (B, H)), "g0": (g0, (B, H)), "rkA": (rkA, (H, 4 * H)),
              "rkB": (rkB, (H, 4 * H))}, bf16=frozenset({"rkA", "rkB"})))
    lib = _kernels()
    with torch.cuda.device(dev):
        grid = _grid(name, dev, 2 * _items(bb, 4 * H))  # the tiles of both chains
        hbA = torch.zeros((2, bb, H), dtype=torch.bfloat16, device=dev)
        hbA[0] = h0[:bb]
        hbB = torch.empty((2, bb, H), dtype=torch.bfloat16, device=dev)
        fA = torch.empty((2, bb, H), dtype=torch.float32, device=dev)
        outA, outB = (torch.empty((B, H), dtype=torch.float32, device=dev) for _ in range(2))
        sink = torch.empty(grid * 128, dtype=torch.float32, device=dev)
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.cvl_exp_pair(rkA.data_ptr(), rkB.data_ptr(), g0.data_ptr(), hbA.data_ptr(),
                               hbB.data_ptr(), fA.data_ptr(), outA.data_ptr(), outB.data_ptr(),
                               sink.data_ptr(), bar.data_ptr(), bb, H, nb, T, int(coupled), grid,
                               _stream(dev))
    _raise_if(err, name)
    _count(name)
    return outA, outB


def chain_mm_x2_fullwidth(h0, g0, rkA, rkB, bb, T=T_STEPS):
    """:func:`chain_mm_x2_fullwidth_plain`'s function. CUDA tensors launch
    ``pair_kernel<false>`` (the tiles of both chains spread over the grid,
    one barrier a step) or raise; CPU tensors take the plain version."""
    if _device_of(h0).type == "cpu":
        return chain_mm_x2_fullwidth_plain(h0, g0, rkA, rkB, bb, T)
    return _pair("chain_mm_x2_fullwidth", h0, g0, rkA, rkB, bb, T, False)


def chain_mm_encdec(h0, g0, rkA, rkB, bb, T=T_STEPS):
    """:func:`chain_mm_encdec_plain`'s function. CUDA tensors launch
    ``pair_kernel<true>`` (B two steps behind A on other blocks, one barrier
    a step) or raise; CPU tensors take the plain version."""
    if _device_of(h0).type == "cpu":
        return chain_mm_encdec_plain(h0, g0, rkA, rkB, bb, T)
    return _pair("chain_mm_encdec", h0, g0, rkA, rkB, bb, T, True)


def _gates_launch(name, z0, bb, T, bwd):
    B, H4, nb = _blocks(z0, bb)
    H, dev = H4 // 4, z0.device
    if H4 % 4 or (not bwd and H > 2048):
        raise ValueError(f"{name}: z0 must be [B, 4H]" + ("" if bwd else " with H <= 2,048"))
    _check_once(_sig(name, z0, bb=bb, T=T), lambda: _check(dev, {"z0": (z0, (B, H4))}))
    with torch.cuda.device(dev):
        out = torch.empty((B, H), dtype=torch.float32, device=dev)
        err = _kernels().cvl_exp_gates(z0.data_ptr(), out.data_ptr(), bb, H, nb, T, int(bwd),
                                       _stream(dev))
    _raise_if(err, name)
    _count(name)
    return out


def gates_fwd(z0, bb, T=T_STEPS):
    """:func:`gates_fwd_plain`'s function. CUDA tensors launch
    ``gates_fwd_kernel`` (a block a row of the state) or raise; CPU tensors
    take the plain version."""
    if _device_of(z0).type == "cpu":
        return gates_fwd_plain(z0, bb, T)
    return _gates_launch("gates_fwd", z0, bb, T, bwd=False)


def gates_bwd(z0, bb, T=T_STEPS):
    """:func:`gates_bwd_plain`'s function. CUDA tensors launch
    ``gates_bwd_kernel`` (a thread an element) or raise; CPU tensors take
    the plain version."""
    if _device_of(z0).type == "cpu":
        return gates_bwd_plain(z0, bb, T)
    return _gates_launch("gates_bwd", z0, bb, T, bwd=True)


def offchain_mm(hp, dz, xp, bb, T=T_STEPS):
    """:func:`offchain_mm_plain`'s function. CUDA tensors launch
    ``offchain_kernel`` (tensor-core tiles of [dRk ; dW], nb*T products
    each) or raise; CPU tensors take the plain version."""
    if _device_of(hp).type == "cpu":
        return offchain_mm_plain(hp, dz, xp, bb, T)
    B, H, nb = _blocks(hp, bb)
    IN, dev = xp.shape[1], hp.device
    _check_once(_sig("offchain_mm", hp, dz, xp, bb=bb, T=T), lambda: _check(
        dev, {"hp": (hp, (B, H)), "dz": (dz, (B, 4 * H)), "xp": (xp, (B, IN))},
        bf16=frozenset({"hp", "dz", "xp"})))
    with torch.cuda.device(dev):
        drk = torch.empty((H, 4 * H), dtype=torch.float32, device=dev)
        dw = torch.empty((IN, 4 * H), dtype=torch.float32, device=dev)
        err = _kernels().cvl_exp_offchain(hp.data_ptr(), dz.data_ptr(), xp.data_ptr(),
                                          drk.data_ptr(), dw.data_ptr(), bb, H, IN, nb, T,
                                          _stream(dev))
    _raise_if(err, "offchain_mm")
    _count("offchain_mm")
    return drk, dw


def lstm_interleave_train_fwd(xz, rk, h0, c0):
    """:func:`lstm_interleave_train_fwd_plain`'s function, bf16 streams.
    CUDA tensors launch ``interleave_kernel`` (one cooperative launch for
    all T steps, a barrier for each half-batch) or raise; CPU tensors take
    the plain version."""
    if _device_of(xz).type == "cpu":
        return lstm_interleave_train_fwd_plain(xz, rk, h0, c0)
    if xz.dim() != 3 or rk.dim() != 2:
        raise ValueError("xz must be [T, B, 4H] and rk [H, 4H]")
    T, B, H4 = xz.shape
    H, dev = rk.shape[0], xz.device
    if T < 1 or B < 2:
        raise ValueError(f"need T >= 1 and B >= 2 (got {T}, {B})")
    _check_once(_sig("interleave", xz, rk, h0, c0), lambda: _check(
        dev, {"xz": (xz, (T, B, 4 * H)), "rk": (rk, (H, 4 * H)), "h0": (h0, (B, H)),
              "c0": (c0, (B, H))}, bf16=frozenset({"xz", "rk"})))
    Hp = round8(H)
    with torch.cuda.device(dev):
        grid = _grid("interleave", dev, _items((B + 1) // 2, 4 * H))
        # held by names until the launch is queued
        rk_il, hb = interleave_gates(rk).contiguous(), tc_h_operand(h0, Hp)
        h, c = (torch.empty((T, B, H), dtype=torch.float32, device=dev) for _ in range(2))
        z = torch.empty((T, B, H4), dtype=torch.bfloat16, device=dev)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        err = _kernels().cvl_exp_interleave(xz.data_ptr(), rk_il.data_ptr(), hb.data_ptr(),
                                            c0.data_ptr(), h.data_ptr(), c.data_ptr(),
                                            z.data_ptr(), bar.data_ptr(), T, B, H, Hp, grid,
                                            _stream(dev))
    _raise_if(err, "interleave")
    _count("interleave")
    return h, c, z


def mini_walk(case, z, h, x, bb=16):
    """:func:`mini_walk_plain`'s function. CUDA tensors launch
    ``mini_walk_kernel<case>`` (16-row tiles, the last one partial where B
    is not a multiple of 16, each adding into its own accumulators for the
    whole walk) and then ``mini_sum_kernel`` once an accumulator (the tiles'
    partial sums in tile order), or raise; CPU tensors take the plain
    version."""
    if _device_of(z).type == "cpu":
        return mini_walk_plain(case, z, h, x, bb)
    if case not in MINI_CASES:
        raise ValueError(f"case {case!r} (one of {MINI_CASES})")
    if bb != 16:
        raise ValueError("the mini walk kernel takes tiles of 16 rows")
    T, B, H4 = z.shape
    H, IN, dev = H4 // 4, x.shape[-1], z.device
    if IN > H4:
        raise ValueError(f"IN={IN} past 4H={H4}")
    if 16 * (5 * H + IN) * 4 > _MINI_SMEM:
        raise ValueError(f"H={H}, IN={IN}: the walk's tile (16 x (5H + IN) f32) passes "
                         f"{_MINI_SMEM} bytes of shared memory")
    _check_once(_sig("mini_walk", z, h, x), lambda: _check(
        dev, {"z": (z, (T, B, H4)), "h": (h, (T, B, H)), "x": (x, (T, B, IN))},
        bf16=frozenset({"z", "h", "x"})))
    has_dx, has_dw, has_db = _mini_writes(case)
    nb, W = -(-B // 16), IN if case == "min_all" else H
    with torch.cuda.device(dev):
        new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
        pdrk, drk = new(nb, H, H4), new(H, H4)
        dx = torch.empty((T, B, IN), dtype=torch.bfloat16, device=dev) if has_dx else None
        pdw, dw = (new(nb, W, H4), new(W, H4)) if has_dw else (None, None)
        pdb, db = (new(nb, H4), new(1, H4)) if has_db else (None, None)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = _kernels().cvl_exp_mini(MINI_CASES.index(case), z.data_ptr(), h.data_ptr(),
                                      x.data_ptr(), ptr(dx), pdrk.data_ptr(), ptr(pdw),
                                      ptr(pdb), drk.data_ptr(), ptr(dw), ptr(db), T, B, H, IN,
                                      _stream(dev))
    _raise_if(err, f"mini walk {case}")
    _count("mini_walk")
    return dx, drk, dw, db
