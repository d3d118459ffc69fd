"""Whole-generation cl_vae sampler: CUDA kernel wrappers and plain version.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_generate_vae.py`` and,
for configs without hidden layers, of the JAX package's XLA scan
(``sampling/generate.py`` ``generate_cl_vae_batch_noise``). Three kernels in
``csrc/generate_cl_vae.cu`` run the entire autoregressive loop — relu
z-encoder hidden, z heads, z draw (or the prior's draw with
``use_z_prior``), relu decoder hidden over (w, z, the one-step-lagged
``x_prev_t``), sigmoid frame head, Bernoulli draw, feedback — in one launch:
``generate_cluster_kernel``, whose clusters of 1 to 8 blocks each own one
song and hold the f32 / bf16 weights in their shared memory, split by
hidden units and pitches (:func:`cluster_plan`, :func:`pack_cluster`), for
every config whose weights fit 8 blocks, with or without hidden layers;
``generate_vae_coop_kernel``, one cooperative launch whose blocks each own
hidden units (:func:`coop_grid`) and pitch tiles of the frame head
(:func:`head_split`), for the wider configs with hidden layers, in f32 /
bf16 and with the three large weights as per-column int8 codes where the
JAX package's precision rule says int8 (:func:`pick_mode`); and
``generate_wide_kernel``, which reads f32 or bf16 weights from L2 every
step, for what neither takes (:func:`kernel_for`). The sampler is a pure function of
its pre-drawn noise (``eps`` for z, ``u`` for the frames), so the kernels
are held against :func:`generate_cl_vae_batch_plain` on the card and the
plain version against the JAX package on the CPU, with the same noise.

:func:`generate_cl_vae_batch_cuda` launches a kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from . import _build
from .cuda_generate import _qmm, _quant_cols, _z_head, round16

# launches since the counts were last set to 0: of every f32/bf16 kernel, of
# the cluster one alone, of the wide one alone, of the cooperative one alone
# in f32/bf16, and of the cooperative one in int8
LAUNCHES = 0
CLUSTER_LAUNCHES = 0
WIDE_LAUNCHES = 0
COOP_LAUNCHES = 0
INT8_LAUNCHES = 0
_launch_lock = threading.Lock()

_SONGS_PER_BLOCK = 2      # kSongs in csrc/generate_cl_vae.cu (the wide kernel)
_WIDE_THREADS = 512       # kWideThreads
_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
_CLUSTER_SMEM = _SMEM_LIMIT - 256  # the cluster kernel's (kClStatic kept for its clock)
# the cluster kernel: songs a cluster (kClSongs: tiles of 2 and 4 songs were
# slower than 1 at 64 songs on an H100 80GB HBM3 at 700 W, PERF.md §6),
# blocks a cluster, threads a block, the steps of its noise ring (kClRing)
_CLUSTER_SONGS = 1
_CLUSTER_SIZES = (1, 2, 4, 8)
_CLUSTER_THREADS = (128, 256, 384, 512)
_CLUSTER_RING = 8
_CLUSTER_WARP_SLOTS = 16   # kClWarpSlots: a block's warps
_CLUSTER_ZPER = 4          # kClZPer: z heads a lane of an encoder column sums (2L <= 4 g)
_CLUSTER_REG_VALS = 24     # kClRegVals: values of k a lane keeps of a layer on the register path
_CLUSTER_REG_THREADS = 384  # kClRegThreads: the register path's most threads
# the cooperative kernel (int8, and f32 / bf16 at wide widths): a launch
# takes at most _COOP_ROWS songs (a call more in several launches); its ring
# holds _COOP_RING stages of _COOP_CPS 32-byte chunks of those songs' operands
# and of the streamed weights, at most _COOP_MAX_NT n8 tiles a product pass
_COOP_ROWS, _COOP_RING, _COOP_CPS, _COOP_MAX_NT = 64, 4, 8, 8
_COOP_MAX_BLOCKS = 136      # kMaxBlocks: the most blocks its cross-block loads take
_MODES = ("f32", "bf16", "int8")
_EBYTES = {"int8": 1, "bf16": 2, "f32": 4}  # bytes of an operand of each mode
# The JAX package's precision rule for this sampler (its ``_BUDGET`` and
# ``pick_mode``, ``pallas_generate_vae.py:44,72-95``): the weight bytes of
# each mode against 28 MiB less 2.5 MiB. It is a size of the TPU kernel's
# VMEM, not of this card; the port copies it because it decides which songs
# a checkpoint gives.
_JAX_LIMIT = 28 * 1024 * 1024 - int(2.5 * 1024 * 1024)


def _pad128(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def _jax_weight_bytes(D: int, H: int, L: int, mode: str) -> int:
    """The JAX package's ``_weight_bytes`` (``pallas_generate_vae.py:53-69``):
    each weight at the type its kernel loads it in, H and D lane-padded to
    multiples of 128 (the int8 mode keeps the z heads bf16 and the decoder z
    rows f32, with three f32 scale vectors)."""
    wb = {"f32": 4, "bf16": 2, "int8": 1}[mode]
    Hp, Dp = _pad128(H), _pad128(D)
    big = wb * (D * Hp + D * Hp + Hp * Dp)
    z_head = (2 if mode == "int8" else wb) * Hp * 128
    scales = 4 * (2 * Hp + Dp) if mode == "int8" else 0
    return big + z_head + 4 * L * Hp + 4 * (128 + Dp) + scales


def _jax_precision(cfg) -> str | None:
    """What the JAX package's ``pick_mode`` returns for ``cfg``: None without
    hidden layers; else f32 or bf16 (the checkpoint's numerics) while that
    mode's weights are under the limit, int8 past it for a bf16 checkpoint,
    else None (JAX then samples with its XLA scan)."""
    if not cfg.has_hidden:
        return None
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    ladder = ("bf16", "int8") if cfg.bf16_compute else ("f32",)
    return next((m for m in ladder if _jax_weight_bytes(D, H, L, m) < _JAX_LIMIT), None)


def pick_mode(cfg) -> str:
    """Weight precision, as the JAX package picks it: the checkpoint's
    numerics, f32 unless it computes its hidden layers in bf16
    (``cfg.bf16_compute``); int8 where such a checkpoint selects the kernel
    path (``cfg.gen_backend == "pallas"``) and the JAX rule says int8 (at
    D=1,024, L=16: H = 4,160 … 7,808). A config without hidden layers
    samples in f32, as the JAX package's XLA scan samples it. The JAX
    package's device check is not copied."""
    if not (cfg.bf16_compute and cfg.has_hidden):
        return "f32"
    if getattr(cfg, "gen_backend", "xla") == "pallas" and _jax_precision(cfg) == "int8":
        return "int8"
    return "bf16"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cluster_layers(D: int, H: int, L: int, has_hidden: bool, use_x_prev: bool, C: int):
    """(Hc, Dc, [(n, k)] of the encoder, the z heads, the decoder and the
    frame head): a block's hidden units and pitches, and the columns and
    depth of each layer's product in that block (0 where it has none)."""
    Dc = _cdiv(D, C)
    if has_hidden:
        Hc = _cdiv(H, C)
        return Hc, Dc, [(Hc, D), (2 * L, Hc), (Hc, D) if use_x_prev else (0, 0), (Dc, H)]
    return 0, Dc, [(0, 0), (2 * L, D), (0, 0), (Dc, D) if use_x_prev else (0, 0)]


def _round4(n: int) -> int:
    return _cdiv(n, 4) * 4


def cluster_layout(D: int, H: int, L: int, has_hidden: bool, use_x_prev: bool, eb: int, C: int,
                   T: int, g) -> dict:
    """One block's layout at a plan's geometry, as ``cl_layout`` in
    ``csrc/generate_cl_vae.cu`` computes it: per layer its columns ``n``,
    the 16-byte chunks ``nck`` a lane of its g sums and the chunks ``rs`` of
    a slab row (``nck g`` made an odd multiple of g where g < 8, so that the
    lanes of a warp load from distinct banks); a song's row of the frames
    and of h_d (``Da``, ``Ha`` floats); and the bytes of dynamic shared
    memory: four mbarriers, the slabs, then the f32 state (the z rows, the
    biases, three frames, h_d, the folds, the z heads' sums (with hidden
    layers a slot per warp, :data:`_CLUSTER_WARP_SLOTS`), z, the products
    that wait for z, and the noise ring), each part a multiple of 16
    bytes."""
    kp, S = 16 // eb, _CLUSTER_SONGS
    Hc, Dc, layers = _cluster_layers(D, H, L, has_hidden, use_x_prev, C)
    n, nck, rs, span = [], [], [], []
    off = 32
    for (ni, ki), gi in zip(layers, g):
        c = _cdiv(_cdiv(ki, kp), gi) if ni and ki else 0
        m = c + 1 if gi < 8 and c % 2 == 0 and ni and ki else c
        n.append(ni), nck.append(c), rs.append(m * gi), span.append(c * gi * kp)
        off += ni * m * gi * 16
    if has_hidden:
        Da, Ha = max(_round4(D), span[0], span[2]), max(_round4(H), span[3])
    else:
        Da, Ha = max(_round4(D), span[1], span[3]), 0
    own = Hc if has_hidden else Dc
    slots = _CLUSTER_WARP_SLOTS if has_hidden else 1
    floats = (L * own, 2 * L if has_hidden else 0, Dc if has_hidden else 0, 3 * S * Da, S * Ha,
              S * (Hc if has_hidden else 2 * L), S * (Hc if has_hidden else Dc),
              S * 2 * L * slots, S * L if has_hidden else 0,
              S * max(Hc, Dc), _CLUSTER_RING * S * (L + Dc))
    return {"Hc": Hc, "Dc": Dc, "n": n, "nck": nck, "rs": rs, "Da": Da, "Ha": Ha,
            "bytes": off + sum(16 * _cdiv(f, 4) for f in floats)}


def _layer_cost(n: int, k: int, g: int, T: int, kp: int) -> int:
    """The plan's measure of one layer's chain: rounds of columns times (the
    chunks a lane sums + two a butterfly level)."""
    if not (n and k):
        return 0
    return _cdiv(n, T // g) * (_cdiv(_cdiv(k, kp), g) + 2 * (g.bit_length() - 1))


def _regs_ok(has_hidden: bool, eb: int, T: int, g, lay: dict) -> bool:
    """The register path (``cl_regs_ok``): one song a cluster, at most
    :data:`_CLUSTER_REG_THREADS` threads, and every product it runs one
    column a group with at most :data:`_CLUSTER_REG_VALS` values of k a
    lane, which it keeps in registers for the launch."""
    if _CLUSTER_SONGS != 1 or T > _CLUSTER_REG_THREADS:
        return False
    kp = 16 // eb
    return all(not (n and c) or (n <= T // gi and c * kp <= _CLUSTER_REG_VALS)
               for i, (n, c, gi) in enumerate(zip(lay["n"], lay["nck"], g))
               if not (has_hidden and i == 1))


@functools.lru_cache(maxsize=256)
def _cluster_geometry(D: int, H: int, L: int, has_hidden: bool, use_x_prev: bool,
                      eb: int) -> dict | None:
    """The fewest blocks C whose shared memory holds the layout, and at that
    C the threads T and lanes a column g of each layer that make the step's
    chain shortest (:func:`_layer_cost`, ties to fewer threads); None where
    8 blocks do not hold it; a geometry the register path takes
    (:func:`_regs_ok`) before any that it does not. With hidden
    layers the decoder shares the encoder's pass (the same g), whose lanes
    also sum the z heads (g at least 2L / :data:`_CLUSTER_ZPER`; the z
    heads' slab is read a column at a time, g 1)."""
    kp = 16 // eb
    lanes = (1, 2, 4, 8, 16, 32)
    g_min = next((gg for gg in lanes if 2 * L <= _CLUSTER_ZPER * gg), None)
    if has_hidden and g_min is None:
        return None
    for C in _CLUSTER_SIZES:
        layers = _cluster_layers(D, H, L, has_hidden, use_x_prev, C)[2]
        best = None
        for T in _CLUSTER_THREADS:
            g = [min(lanes, key=lambda gg: (_layer_cost(n, k, gg, T, kp), gg))
                 for n, k in layers]
            if has_hidden:
                g[0] = min((gg for gg in lanes if gg >= g_min),
                           key=lambda gg: (_layer_cost(*layers[0], gg, T, kp), gg))
                g[1], g[2] = 1, g[0]
                layers_cost = [layers[0], (0, 0), layers[2], layers[3]]
            else:
                layers_cost = layers
            cost = (sum(_layer_cost(n, k, gi, T, kp) for (n, k), gi in zip(layers_cost, g))
                    + T // 128)
            lay = cluster_layout(D, H, L, has_hidden, use_x_prev, eb, C, T, g)
            regs = _regs_ok(has_hidden, eb, T, g, lay)
            if lay["bytes"] <= _CLUSTER_SMEM and (best is None or (not regs, cost) < best[0]):
                best = ((not regs, cost), {"C": C, "T": T, "g": tuple(g), "regs": regs, **lay})
        if best is not None:
            return best[1]
    return None


def cluster_plan(cfg, B: int, mode: str | None = None, n_sm: int = 132,
                 max_clusters=None) -> dict | None:
    """The cluster kernel's plan for a call of B songs in ``mode`` on a card
    of ``n_sm`` SMs: blocks a cluster C, threads T, lanes a column g per
    layer, the register path (``regs``) and :func:`cluster_layout`'s fields;
    ``clusters``, one a song, and ``waves``, the passes of the card they
    take: ``max_clusters(plan)`` clusters at once where given (the card's
    answer, :func:`_max_clusters`), else n_sm // C. None where the weights
    do not fit 8 blocks (or int8 mode: the cooperative kernel's)."""
    mode = mode or pick_mode(cfg)
    if mode == "int8":
        return None
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    plan = _cluster_geometry(D, H, L, bool(cfg.has_hidden), bool(cfg.use_x_prev), _EBYTES[mode])
    if plan is None:
        return None
    clusters = _cdiv(B, _CLUSTER_SONGS)
    at_once = max_clusters(plan) if max_clusters else n_sm // plan["C"]
    return {**plan, "clusters": clusters, "waves": _cdiv(clusters, max(1, at_once))}


def launch_plan(cfg, B: int, mode: str, dev) -> dict | None:
    """The plan a call of B songs on CUDA device ``dev`` launches: its SMs
    and the clusters of the plan it holds at once (:func:`_max_clusters`)."""
    return cluster_plan(cfg, B, mode, n_sm=_sm_count(dev), max_clusters=_max_clusters(dev, mode))


def fits(cfg, mode: str | None = None) -> bool:
    """Does the cluster kernel hold the config: f32 or bf16 weights (with or
    without hidden layers) within the shared memory of a cluster of at most
    8 blocks?"""
    return cluster_plan(cfg, 1, mode) is not None


def kernel_for(cfg, mode: str | None = None) -> str:
    """The kernel a CUDA call launches: ``generate_cl_vae_int8`` (the
    cooperative kernel on int8 codes) in int8 mode; ``generate_cl_vae_cluster``
    wherever it :func:`fits` (the committed checkpoints' width on one block,
    f32 at D=88 to H = 1,600 and bf16 to H = 2,624 on 8 blocks, models
    without hidden layers), which the routing sweep on an H100 80GB HBM3 at
    700 W found faster than the cooperative kernel at every width and
    serving bucket where both apply (PERF.md §6); the cooperative kernel in
    f32 / bf16 (``generate_cl_vae_coop``) for the other configs with hidden
    layers that it lays out (:func:`coop_plan`); and ``generate_cl_vae_wide``
    (f32 or bf16 weights) for what neither takes: models without hidden
    layers whose weights do not fit 8 blocks (f32 with x_prev from D ~ 670,
    whose D x D frame-head rows do not; or a z-head width 2L x D past one
    block), and configs with hidden layers past the cooperative kernel's
    latent width, in f32 and in bf16.

    The cooperative kernel keeps each block's columns of the z heads (in
    double) and of the decoder's z rows, and the songs' z, in shared
    memory, so it refuses a latent width past what one block holds beside
    its ring (:func:`coop_plan` raises): L <= 105 at D=1,024, H=5,120 on an
    H100, L <= 366 at D=88 from H=512, L <= 52 at H=7,808; the port's
    checkpoints have L = 2 ... 16. Every config gets a kernel: none
    raises here."""
    mode = mode or pick_mode(cfg)
    if mode == "int8":
        return "generate_cl_vae_int8"
    if fits(cfg, mode):
        return "generate_cl_vae_cluster"
    if cfg.has_hidden:
        try:
            for B in (1, _COOP_ROWS):
                coop_plan(cfg, B, 132, mode)
            return "generate_cl_vae_coop"
        except ValueError:
            pass
    return "generate_cl_vae_wide"


def _wide_state_floats(D: int, H: int, L: int, has_hidden: bool) -> int:
    return _SONGS_PER_BLOCK * (3 * D + L + (2 * H if has_hidden else 0))


def _wide_smem_bytes(D: int, H: int, L: int, has_hidden: bool, state_in_smem: bool) -> int:
    """Shared memory of one block of the wide kernel: the K-split partial
    sums and, where it fits, the tile's per-song state (both frames, the
    step's probabilities, z, and h_e and h_d with hidden layers)."""
    state = _wide_state_floats(D, H, L, has_hidden) if state_in_smem else 0
    return 4 * (_WIDE_THREADS * _SONGS_PER_BLOCK + state)


def coop_grid(H: int, n_sm: int) -> tuple[int, int]:
    """The cooperative kernel's grid on a card of ``n_sm`` SMs, in every
    mode: (nu, blocks), each block owning nu hidden units (a multiple of 8:
    one n8 tile of the products per 8 units), cdiv(H, nu) <= n_sm blocks. At
    H=5,120 on 132 SMs: 128 blocks of 40 units; at H=4,160: 130 of 32; at
    H=7,808: 122 of 64; at H=512: 64 of 8."""
    nu = 8 * -(-H // (8 * n_sm))
    return nu, -(-H // nu)


def head_split(D: int, G: int, B: int) -> tuple[int, int]:
    """How the cooperative kernel's G blocks share the frame head of a launch of B
    songs: (hs, P). Block g takes song group g % hs (the m16 tiles split in
    hs runs) and the P 8-pitch tiles of pitch group g // hs (tiles P (g //
    hs) .. + P - 1; the last groups may hold fewer, or none). Two song groups
    from 32 songs on: each block then reads half the songs' operands of h_d
    from L2 for twice the pitches."""
    hs = 2 if round16(min(B, _COOP_ROWS)) >= 32 else 1
    return hs, -(-(-(-D // 8)) // (G // hs))


def _coop_smem(D: int, H: int, L: int, nu: int, P: int, use_x_prev: bool, res_cells: bool,
               res_head: bool, eb: int = 1) -> int:
    """Shared memory of one block of the cooperative kernel whose operands
    are ``eb`` bytes (``coop_smem_bytes``): the ring (_COOP_CPS 32-byte chunks
    of 64 songs' operands a stage, each song's row padded by 16 bytes, and
    the chunks of the widest streamed weight pass), the resident slices (the
    x rows of both cells, the head's P tiles), the block's columns of the z
    heads in double, and in f32 h ([64][nu]), the block's columns of the two
    int8 scales and of the decoder's z rows, and the songs' z and rs."""
    per = 32 // eb  # k of a chunk
    NT, kcx, kch = nu // 8, -(-D // per), -(-H // per)
    wt = min(_COOP_MAX_NT, max(0 if res_cells else NT, 0 if res_head else P))
    ring = _COOP_RING * (_COOP_ROWS * (_COOP_CPS * 32 + 16) + _COOP_CPS * wt * 256)
    cells = kcx * (1 + int(use_x_prev)) * NT * 256 if res_cells else 0
    head = kch * P * 256 if res_head else 0
    zheads = 8 * nu * 2 * L  # the z heads' columns, in double
    return (ring + cells + head + zheads
            + 4 * (_COOP_ROWS * nu + nu * (2 + L) + _COOP_ROWS * (L + 1)))


def coop_residency(D: int, H: int, L: int, nu: int, P: int, use_x_prev: bool,
                   eb: int = 1) -> tuple[bool, bool] | None:
    """The residency rule: (x-row slices resident, head tiles resident), the
    first of both, the slices alone, neither whose block fits Hopper's
    shared memory; None where not even the streamed layout fits."""
    for res in ((True, True), (True, False), (False, False)):
        if _coop_smem(D, H, L, nu, P, use_x_prev, *res, eb) <= _SMEM_LIMIT:
            return res
    return None


def _resolve_mode(cfg, mode):
    mode = mode or pick_mode(cfg)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (f32, bf16 or int8)")
    if mode != "f32" and not cfg.has_hidden:
        # pick_mode never gives them: a config without hidden layers samples
        # in f32, as the JAX package's XLA scan samples it
        raise ValueError(f"{mode} weights need hidden layers (a config without them samples "
                         "in f32)")
    return mode


def _pack_int8(params, cfg, ws) -> dict:
    """The int8 kernel's operands, as JAX ``generate_cl_vae_batch_pallas``
    forms them in int8 mode (with the cl_vrnn sampler's ``_quant_cols``,
    which JAX's cl_vae int8 kernel imports too): the encoder x rows, the
    decoder x_prev rows and the frame head as int8 codes with f32 scales
    (``ske``, ``skd``, ``swx``), the z heads bf16 (transposed), the decoder
    z rows, the biases and the per-song folds f32. JAX pads H and D to
    multiples of 128: the padded columns have code 0 and change no value and
    no row max, so none is padded here."""
    w = _pack(params, cfg, ws, "f32")
    w["wke"], w["ske"] = _quant_cols(w["wke"])
    if cfg.use_x_prev:
        w["wkd_x"], w["skd"] = _quant_cols(w["wkd_x"])
    w["wx"], w["swx"] = _quant_cols(w["wx"])
    w["wz_t"] = w["wz_t"].to(torch.bfloat16)
    return w


def _col_tiles(w, ncols: int):
    """A weight ``[K, N]`` (int8 codes, bf16 or f32) -> ``[NT, KC, 64]``
    int32 words, NT = cdiv(ncols, 8) tiles of 8 columns, KC chunks of 32
    bytes of k (32 codes, 16 bf16 or 8 f32): a tile's chunk holds its 8
    columns one after the other, each column's k of the chunk in order (zero
    rows past K, zero columns past N). Lane (g, t) of ``mma.sync`` then loads
    bytes 8t .. 8t + 7 of column g: the B fragment (m16n8k32 s8, m16n8k16
    bf16) of the k that its A fragment pairs with them."""
    K, N = w.shape
    per = 32 // w.element_size()
    KC, NT = -(-K // per), -(-ncols // 8)
    wp = w.new_zeros((KC * per, NT * 8))
    wp[:K, :N] = w
    tiles = wp.view(KC, per, NT, 8).permute(2, 0, 3, 1).contiguous()
    return tiles.view(torch.int32).view(NT, KC, 64)


def pack_units(q, nu: int):
    """A cell's x rows ``[K, H]`` (int8 codes, bf16 or f32) -> ``[G, KC, NT,
    64]`` int32 words, G = cdiv(H, nu) blocks, KC chunks of k, NT = nu / 8 n8
    tiles: tile n of block g holds units g nu + 8n .. + 7 (zero columns past
    H, zero rows past K), laid out as :func:`_col_tiles` lays them."""
    K, H = q.shape
    G = -(-H // nu)
    tiles = _col_tiles(q, G * nu)
    return tiles.view(G, nu // 8, tiles.shape[1], 64).permute(0, 2, 1, 3).contiguous()


def pack_head_tiles(q, G: int, P: int, hs: int):
    """The frame head ``[H, D]`` (int8 codes, bf16 or f32) -> ``[G, KC, P,
    64]`` int32 words: slot j of block g is 8-pitch tile P (g // hs) + j (a
    zero tile past the last), laid out as :func:`_col_tiles` lays them."""
    tiles = _col_tiles(q, q.shape[1])  # [NTx, KC, 64]
    ntx, KC = tiles.shape[:2]
    idx = (torch.arange(G, device=q.device) // hs)[:, None] * P + torch.arange(P, device=q.device)
    padded = torch.cat([tiles, tiles.new_zeros((1, KC, 64))])
    sel = padded[torch.clamp(idx, max=ntx).reshape(-1)]  # index ntx: the zero tile
    return sel.view(G, P, KC, 64).permute(0, 2, 1, 3).contiguous()


def pack_coop(w: dict, cfg, nu: int, G: int, P: int, hs: int) -> dict:
    """The cooperative kernel's weights from :func:`_pack_int8`'s codes or
    :func:`_pack`'s bf16 / f32 values: each block's units of the encoder's x
    rows (``wke``) and of the decoder's x_prev rows (``wkd``, with
    ``use_x_prev``), and its pitch tiles of the frame head (``wx``)."""
    return {"wke": pack_units(w["wke"], nu),
            "wkd": pack_units(w["wkd_x"], nu) if cfg.use_x_prev else None,
            "wx": pack_head_tiles(w["wx"], G, P, hs)}


def _folds(params, cfg, ws) -> dict:
    """The per-song f32 folds of the w rows and biases: with hidden layers
    ``encb = ws @ h.kernel[D:] + h.bias`` and ``decb = ws @
    decoder_h.kernel[:K] + decoder_h.bias``; without, ``zb = ws @ [z_mean |
    z_log_var].kernel[D:] + biases`` and ``xb = ws @
    x_decoded_mean.kernel[:K] + x_decoded_mean.bias`` (plain f32 products:
    TF32 is off)."""
    D, K = cfg.original_dim, cfg.n_classes
    if not cfg.has_hidden:
        zk = torch.cat([params["z_mean"]["kernel"][D:], params["z_log_var"]["kernel"][D:]], 1)
        zbias = torch.cat([params["z_mean"]["bias"], params["z_log_var"]["bias"]])
        xdm = params["x_decoded_mean"]
        return {"zb": (torch.matmul(ws, zk) + zbias).contiguous(),
                "xb": (torch.matmul(ws, xdm["kernel"][:K]) + xdm["bias"]).contiguous()}
    enc, dec = params["h"], params["decoder_h"]
    return {"encb": (torch.matmul(ws, enc["kernel"][D:]) + enc["bias"]).contiguous(),
            "decb": (torch.matmul(ws, dec["kernel"][:K]) + dec["bias"]).contiguous()}


def _pack(params, cfg, ws, mode: str) -> dict:
    """The kernels' operands: weights split by input rows (the large ones
    in the mode's type; the z rows in f32) and the per-song f32 folds of the
    w rows and biases (:func:`_folds`)."""
    D, K = cfg.original_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    wt = torch.bfloat16 if mode == "bf16" else torch.float32
    cast = lambda w: w.to(wt).contiguous()
    zk = torch.cat([params["z_mean"]["kernel"], params["z_log_var"]["kernel"]], 1)
    zbias = torch.cat([params["z_mean"]["bias"], params["z_log_var"]["bias"]])
    folds = _folds(params, cfg, ws)
    if not cfg.has_hidden:
        xk = params["x_decoded_mean"]["kernel"]
        return {
            "wz_t": cast(zk[:D].T),  # z heads' x_prev rows, transposed
            "wx_xp": cast(xk[K : K + n_xp]) if cfg.use_x_prev else None,
            "wx_z": xk[K + n_xp :].contiguous(),  # f32 in every mode
            **folds,
        }
    dec = params["decoder_h"]
    return {
        "wke": cast(params["h"]["kernel"][:D]),
        # z heads transposed: one row per output
        "wz_t": cast(zk.T),
        "bz": zbias.contiguous(),
        "wkd_x": cast(dec["kernel"][K : K + n_xp]) if cfg.use_x_prev else None,
        "wkd_z": dec["kernel"][K + n_xp :].contiguous(),  # f32 in every mode
        "wx": cast(params["x_decoded_mean"]["kernel"]),
        "bx": params["x_decoded_mean"]["bias"].contiguous(),
        **folds,
    }


def _slab(wt, C: int, n: int, rs: int, kp: int, dtype):
    """A weight with a row per output column, k contiguous (``[N, K]``) ->
    ``[C, n, rs kp]`` of ``dtype``: block r's slab holds columns r n .. r n
    + n - 1, each row padded to rs 16-byte chunks (zero past N and K)."""
    N, K = wt.shape
    out = torch.zeros((C * n, rs * kp), dtype=dtype, device=wt.device)
    out[:N, :K] = wt
    return out.view(C, n, rs * kp)


def pack_cluster(params, cfg, mode: str, plan: dict) -> dict:
    """The cluster kernel's weights for ``plan``: a slab per layer (``w``:
    the encoder's x rows, the z heads, the decoder's x_prev rows, the frame
    head; None where absent), block r's share of each at index r (its units'
    columns of the x rows and its units' k of the z heads, its pitches'
    columns of the frame head; without hidden layers every block's z-head
    slab is the whole of the heads' x_prev rows), in the mode's type; and in
    f32 the z rows (of the decoder, or without hidden layers of the frame
    head) and, with hidden layers, the z heads' and the frame head's
    biases."""
    D, H, L, K = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    C, n, rs = plan["C"], plan["n"], plan["rs"]
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    kp = 16 // _EBYTES[mode]
    zk = torch.cat([params["z_mean"]["kernel"], params["z_log_var"]["kernel"]], 1)
    xk = params["x_decoded_mean"]["kernel"]
    w = [None] * 4
    if cfg.has_hidden:
        dec, Hc = params["decoder_h"]["kernel"], plan["Hc"]
        w[0] = _slab(params["h"]["kernel"][:D].T, C, n[0], rs[0], kp, dt)
        heads = torch.zeros((2 * L, C * Hc), dtype=torch.float32, device=zk.device)
        heads[:, :H] = zk.T
        w[1] = _slab(heads.view(2 * L, C, Hc).transpose(0, 1).reshape(C * 2 * L, Hc), C,
                     n[1], rs[1], kp, dt)
        if cfg.use_x_prev:
            w[2] = _slab(dec[K : K + n_xp].T, C, n[2], rs[2], kp, dt)
        w[3] = _slab(xk.T, C, n[3], rs[3], kp, dt)
        return {"w": w, "zrows": dec[K + n_xp :].contiguous(),
                "bz": torch.cat([params["z_mean"]["bias"], params["z_log_var"]["bias"]]),
                "bx": params["x_decoded_mean"]["bias"].contiguous()}
    w[1] = _slab(zk[:D].T.repeat(C, 1), C, n[1], rs[1], kp, dt)
    if cfg.use_x_prev:
        w[3] = _slab(xk[K : K + n_xp].T, C, n[3], rs[3], kp, dt)
    return {"w": w, "zrows": xk[K + n_xp :].contiguous(), "bz": None, "bx": None}


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
    ``preferred_element_type=f32`` product does not. In int8 mode the step
    is JAX's int8 kernel's (:func:`_plain_int8`).
    """
    mode = _resolve_mode(cfg, mode)
    if mode == "int8":
        return _plain_int8(params, cfg, x_seeds, nsteps, eps, u, ws, use_z_prior, return_probs)
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


def _plain_int8(params, cfg, x_seeds, nsteps, eps, u, ws, use_z_prior, return_probs):
    """The JAX int8 kernel's step (``pallas_generate_vae.py:205-251``), f32
    operations in its order: binary frames are exact codes; ``h_e = relu(x
    @ Wke + encb)``; the z heads in bf16; ``z_d = decb``, then the L f32 z
    rows, then the x_prev_t product; ``rs = max(max h_d, 1e-12) / 127`` per
    song and ``hd_q = round(h_d / rs)``; ``p = sigmoid(q * rs + bx)``."""
    L = cfg.latent_dim
    w = _pack_int8(params, cfg, ws)
    q64 = {k: w[k].double() for k in ("wke", "wkd_x", "wx") if w[k] is not None}
    x_prev = x_prev_t = torch.trunc(x_seeds)  # JAX's astype(int8); binary frames are exact
    outs = []
    for s in range(nsteps):
        h_e = torch.relu(_qmm(x_prev, q64["wke"], w["ske"]) + w["encb"])
        zmv = _z_head(h_e, w["wz_t"]) + w["bz"]
        z = eps[:, s] if use_z_prior else zmv[:, :L] + torch.exp(zmv[:, L:] / 2) * eps[:, s]
        z_d = w["decb"]
        for l in range(L):
            z_d = z_d + z[:, l : l + 1] * w["wkd_z"][l]
        if cfg.use_x_prev:
            z_d = z_d + _qmm(x_prev_t, q64["wkd_x"], w["skd"])
        h_d = torch.relu(z_d)
        m = torch.clamp_min(h_d.amax(dim=-1, keepdim=True), 1e-12)
        rs = m / torch.full_like(m, 127.0)
        xm = torch.sigmoid(_qmm(torch.round(h_d / rs), q64["wx"], w["swx"]) * rs + w["bx"])
        x_t = (u[:, s] < xm).to(xm.dtype)
        x_prev_t, x_prev = x_prev, x_t
        outs.append(xm if return_probs else x_t)
    return torch.stack(outs, dim=1)


_lib_lock = threading.Lock()
_lib = None


def _kernels():
    """The built library, its entry points' ctypes signatures set and its
    shared-memory layouts checked against :func:`cluster_layout`,
    :func:`_wide_smem_bytes` and :func:`_coop_smem`."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("generate_cl_vae")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            cl = lib.cvl_generate_cl_vae_cluster_smem_bytes
            cl.argtypes, cl.restype = [I] * 12, LL
            for shape in ((88, 88, 4, 1, 1, 4, 1, 384, (4, 8, 4, 4)),
                          (88, 256, 4, 1, 1, 4, 2, 512, (4, 8, 4, 8)),
                          (88, 0, 4, 0, 1, 4, 1, 256, (1, 16, 1, 4)),
                          (1024, 2048, 16, 1, 0, 2, 8, 512, (8, 32, 1, 16)),
                          (13, 37, 3, 1, 1, 2, 4, 128, (2, 1, 32, 16))):
                if cl(*shape[:8], *shape[8]) != cluster_layout(*shape)["bytes"]:
                    raise RuntimeError("shared-memory layout of the cluster kernel in "
                                       "csrc/generate_cl_vae.cu differs from cluster_layout at "
                                       f"{shape}")
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
            coop = lib.cvl_generate_cl_vae_coop_smem_bytes
            coop.argtypes, coop.restype = [I] * 9, LL
            for shape in ((1024, 5120, 16, 40, 2, 0, 1, 1, 1), (1024, 7808, 16, 64, 2, 1, 0, 0, 1),
                          (13, 262, 3, 8, 1, 0, 1, 0, 2), (64, 320, 4, 8, 8, 1, 0, 1, 4),
                          (1024, 5120, 16, 40, 2, 0, 1, 0, 2)):
                if coop(*shape) != _coop_smem(*shape):
                    raise RuntimeError("shared-memory layout of the cooperative kernel in "
                                       "csrc/generate_cl_vae.cu differs from _coop_smem at "
                                       f"{shape}")
            lib.cvl_generate_cl_vae_coop_state_words.argtypes = [I] * 5
            lib.cvl_generate_cl_vae_coop_state_words.restype = LL
            lib.cvl_generate_cl_vae_cluster.argtypes = [P] * 18 + [I] * 18 + [P, P]
            lib.cvl_generate_cl_vae_wide.argtypes = [I] + [P] * 16 + [I] * 11 + [P]
            lib.cvl_generate_cl_vae_coop.argtypes = [I] + [P] * 18 + [I] * 13 + [P]
            lib.cvl_generate_cl_vae_cluster_max_active.argtypes = [I] * 5 + [P]
            lib.cvl_generate_cl_vae_cluster_max_active.restype = I
            lib.cvl_generate_cl_vae_cluster.restype = lib.cvl_generate_cl_vae_wide.restype = I
            lib.cvl_generate_cl_vae_coop.restype = I
            _lib = lib
        return _lib


def _check_inputs(cfg, x_seeds, nsteps, eps, u, ws):
    """Raise on a call's inputs the kernels do not take."""
    if x_seeds.dim() != 2:
        raise ValueError(f"x_seeds must be [B, D], got {tuple(x_seeds.shape)}")
    B, D = x_seeds.shape
    if nsteps < 1 or B < 1:
        raise ValueError(f"need B, nsteps >= 1 (got {B}, {nsteps})")
    if D != cfg.original_dim:
        raise ValueError(f"seed width {D} != original_dim {cfg.original_dim}")
    _expect(x_seeds.device, {"x_seeds": (x_seeds, (B, D)),
                             "eps": (eps, (B, nsteps, cfg.latent_dim)),
                             "u": (u, (B, nsteps, D)), "ws": (ws, (B, cfg.n_classes))})


def _param_shapes(params, cfg) -> dict:
    D, H, L, K = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    n_xp = D if cfg.use_x_prev else 0
    head_in = H if cfg.has_hidden else D + K
    expect = {
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
    return expect


def _expect(dev, expect: dict):
    for name, (t, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x_seeds on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode):
    """Raise on anything the kernels do not take."""
    _check_inputs(cfg, x_seeds, nsteps, eps, u, ws)
    _expect(x_seeds.device, _param_shapes(params, cfg))


# the packed weights of recent (params, config, mode, plan, device) signatures, each
# with the parameter tensors it was made from (held, so that no other tensor
# takes their place) and their versions: a signature is checked and packed
# once, and again after an in-place change of a parameter
_PACKED: collections.OrderedDict = collections.OrderedDict()
_PACKED_MAX = 4


def cluster_operands(params, cfg, mode: str, plan: dict, dev) -> dict:
    """The cluster kernel's weights (:func:`pack_cluster`), checked and
    packed once per signature (:data:`_PACKED`); the per-song folds are
    formed in the kernel's prologue from the w rows as stored
    (:func:`_fold_rows`)."""
    tensors = tuple(t for t, _ in _param_shapes(params, cfg).values())
    key = (tuple(id(t) for t in tensors), cfg, mode, plan["C"], plan["T"], plan["g"], dev)
    hit = _PACKED.get(key)
    versions = tuple(t._version for t in tensors)
    if hit is None or hit[1] != versions or any(a is not b for a, b in zip(hit[0], tensors)):
        _expect(dev, _param_shapes(params, cfg))
        hit = _PACKED[key] = (tensors, versions, pack_cluster(params, cfg, mode, plan))
        while len(_PACKED) > _PACKED_MAX:
            _PACKED.popitem(last=False)
    _PACKED.move_to_end(key)
    return hit[2]


def _fold_rows(params, cfg) -> tuple[list, list]:
    """The addresses of the w rows and biases of the per-song folds, as the
    parameters store them (contiguous f32): with hidden layers the
    encoder's rows D.. and the decoder's rows 0.. (``encb``, ``decb``);
    without, z_mean's and z_log_var's rows D.. and the frame head's rows
    0.. (``zb``, ``xb``)."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    if cfg.has_hidden:
        enc, dec = params["h"], params["decoder_h"]
        return ([enc["kernel"].data_ptr() + 4 * D * H, dec["kernel"].data_ptr(), None],
                [enc["bias"].data_ptr(), dec["bias"].data_ptr(), None])
    zm, zv, xdm = params["z_mean"], params["z_log_var"], params["x_decoded_mean"]
    return ([zm["kernel"].data_ptr() + 4 * D * L, zv["kernel"].data_ptr() + 4 * D * L,
             xdm["kernel"].data_ptr()],
            [zm["bias"].data_ptr(), zv["bias"].data_ptr(), xdm["bias"].data_ptr()])


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=256)
def _max_clusters_at(dev, eb: int, regs: bool, C: int, T: int, smem: int) -> int:
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = _kernels().cvl_generate_cl_vae_cluster_max_active(eb, int(regs), C, T, smem,
                                                                ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return n.value


def _max_clusters(dev, mode: str):
    """The card's answer, for :func:`cluster_plan`: how many clusters of a
    plan's layout it holds at once (``cudaOccupancyMaxActiveClusters``; the
    blocks of a cluster share a GPC, so it can be fewer than n_sm // C)."""
    return lambda plan: _max_clusters_at(dev, _EBYTES[mode], plan["regs"], plan["C"], plan["T"],
                                         plan["bytes"])


def _launch_cluster(lib, params, cfg, x_seeds, nsteps, eps, u, ws, flags, mode, plan, out,
                    clock=None) -> int:
    """One launch of the cluster kernel at ``plan`` on the current stream
    (``clock``: an int64 per :data:`CLUSTER_PARTS`, or None). Returns its
    CUDA error."""
    B, D = x_seeds.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    w = cluster_operands(params, cfg, mode, plan, x_seeds.device)
    fw, fb = _fold_rows(params, cfg)
    return lib.cvl_generate_cl_vae_cluster(
        x_seeds.data_ptr(), eps.data_ptr(), u.data_ptr(), *(ptr(s) for s in w["w"]),
        ws.data_ptr(), *fw, *fb, ptr(w["zrows"]), ptr(w["bz"]), ptr(w["bx"]), out.data_ptr(), B,
        nsteps, D, cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes, int(cfg.has_hidden),
        *flags, _EBYTES[mode], plan["C"], plan["T"], *plan["g"], int(plan["regs"]),
        ptr(clock), torch.cuda.current_stream(x_seeds.device).cuda_stream)


# the parts of a step of the cluster kernel, in the order of its clock (block
# 0's thread 0; without hidden layers: the products, the block barrier as
# the first barrier, then the frame head's epilogue, z in each thread)
CLUSTER_PARTS = ("noise staging", "products", "z-head sums", "first barrier", "z",
                 "h_d epilogue", "second barrier", "frame head products", "frame head epilogue",
                 "noise wait", "last barrier")


def cluster_phase_ms(params, cfg, x_seeds, nsteps: int, eps, u, ws, use_z_prior: bool = False,
                     mode: str | None = None) -> dict:
    """One launch of the cluster kernel (counted, as the wrapper counts it)
    on CUDA tensors, timed part by part on the card by block 0
    (``%globaltimer``): ms of each of :data:`CLUSTER_PARTS` summed over the
    steps (a barrier's part is its wait, the slowest thread's lag and the
    barrier itself), with the plan (:func:`launch_plan`)."""
    global LAUNCHES, CLUSTER_LAUNCHES
    mode = _resolve_mode(cfg, mode)
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    dev = x_seeds.device
    plan = launch_plan(cfg, x_seeds.shape[0], mode, dev)
    if plan is None:
        raise ValueError("the cluster kernel does not hold this config")
    lib = _kernels()
    with torch.cuda.device(dev):
        clock = torch.zeros(len(CLUSTER_PARTS), dtype=torch.int64, device=dev)
        out = torch.empty((x_seeds.shape[0], nsteps, cfg.original_dim), dtype=torch.float32,
                          device=dev)
        err = _launch_cluster(lib, params, cfg, x_seeds, nsteps, eps, u, ws,
                              (int(cfg.use_x_prev), int(use_z_prior), 0), mode, plan, out, clock)
    if err != 0:
        raise RuntimeError(f"generate_cl_vae_cluster kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
        CLUSTER_LAUNCHES += 1
    return {**dict(zip(CLUSTER_PARTS, (ns / 1e6 for ns in clock.cpu().tolist()))),
            "plan": {k: plan[k] for k in ("C", "T", "g", "regs", "clusters", "waves")}}


def generate_cl_vae_batch_cuda(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                               use_z_prior: bool = False, return_probs: bool = False,
                               mode: str | None = None):
    """Kernel counterpart of ``generate_cl_vae_batch_pallas`` (same signature).

    x_seeds [B, D]; eps [B, nsteps, L]; u [B, nsteps, D]; ws [B, K]; returns
    [B, nsteps, D]. CUDA tensors launch the kernel :func:`kernel_for` names
    on the current stream (or raise: there is no fallback): in f32 and bf16
    mode the cluster kernel wherever its weights fit 8 blocks, the
    cooperative kernel for the other configs with hidden layers, the wide
    kernel for what neither takes; in int8 mode the cooperative kernel on
    int8 codes. CPU tensors take :func:`generate_cl_vae_batch_plain`.
    ``mode`` is ``"f32"``, ``"bf16"`` or ``"int8"`` (default
    :func:`pick_mode`).
    """
    global LAUNCHES, CLUSTER_LAUNCHES, WIDE_LAUNCHES, COOP_LAUNCHES, INT8_LAUNCHES
    mode = _resolve_mode(cfg, mode)
    if x_seeds.device.type == "cpu":
        return generate_cl_vae_batch_plain(params, cfg, x_seeds, nsteps, eps, u, ws,
                                           use_z_prior=use_z_prior,
                                           return_probs=return_probs, mode=mode)
    if x_seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seeds.device}")
    kernel = kernel_for(cfg, mode)
    if kernel == "generate_cl_vae_cluster":  # the parameters: once per signature
        _check_inputs(cfg, x_seeds, nsteps, eps, u, ws)
    else:
        _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    B, D = x_seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    dev = x_seeds.device
    lib = _kernels()
    flags = (int(cfg.use_x_prev), int(use_z_prior), int(return_probs))
    if kernel in ("generate_cl_vae_int8", "generate_cl_vae_coop"):
        with torch.cuda.device(dev):
            err, out = _launch_coop(lib, params, cfg, x_seeds, nsteps, eps, u, ws, flags, mode)
        if err != 0:
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
        with _launch_lock:
            if mode == "int8":
                INT8_LAUNCHES += 1
            else:
                LAUNCHES += 1
                COOP_LAUNCHES += 1
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    hh = cfg.has_hidden
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        seeds = (x_seeds.data_ptr(), eps.data_ptr(), u.data_ptr())
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        if kernel == "generate_cl_vae_cluster":
            err = _launch_cluster(lib, params, cfg, x_seeds, nsteps, eps, u, ws, flags, mode,
                                  launch_plan(cfg, B, mode, dev), out)
        else:
            w = _pack(params, cfg, ws, mode)
            # past one block's shared memory the per-song state goes to a
            # global scratch, one slice per block
            state = None
            if _wide_smem_bytes(D, H, L, hh, True) > _SMEM_LIMIT:
                grid = -(-B // _SONGS_PER_BLOCK)
                state = torch.empty((grid, _wide_state_floats(D, H, L, hh)),
                                    dtype=torch.float32, device=dev)
            g = w.get
            err = lib.cvl_generate_cl_vae_wide(
                _EBYTES[mode], *seeds, ptr(g("wke")), ptr(g("encb")), ptr(g("wkd_x")),
                ptr(g("wkd_z")), ptr(g("decb")), ptr(w["wz_t"]), ptr(w["bz"] if hh else w["zb"]),
                ptr(g("wx")), ptr(g("wx_z")), ptr(g("wx_xp")), ptr(w["bx"] if hh else w["xb"]),
                out.data_ptr(), ptr(state), 0 if hh else 2 * L, 0 if hh else D, B, nsteps, D,
                H, L, int(hh), *flags, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _launch_lock:
        LAUNCHES += 1
        if kernel == "generate_cl_vae_cluster":
            CLUSTER_LAUNCHES += 1
        else:
            WIDE_LAUNCHES += 1
    return out


def coop_plan(cfg, B: int, n_sm: int, mode: str = "int8") -> dict:
    """The cooperative kernel's layout for a launch of B <= 64 songs on
    ``n_sm`` SMs in ``mode``: the grid (nu, G), the frame head's split (hs,
    P) and the residency; raises where no layout fits."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    nu, G = coop_grid(H, n_sm)
    hs, P = head_split(D, G, B)
    res = coop_residency(D, H, L, nu, P, cfg.use_x_prev, _EBYTES[mode])
    if G > _COOP_MAX_BLOCKS:
        raise ValueError(f"the cooperative kernel takes at most {_COOP_MAX_BLOCKS} blocks, not {G}")
    if res is None:
        raise ValueError(f"the cooperative kernel does not take D={D}, H={H}, L={L} in {mode}: "
                         f"one block's layout needs more than {_SMEM_LIMIT} B of shared memory")
    return {"nu": nu, "G": G, "hs": hs, "P": P, "res": res}


def _coop_operands(params, cfg, ws, mode: str) -> dict:
    """The cooperative kernel's operands before the per-block packing: int8
    codes and scales (:func:`_pack_int8`), or :func:`_pack`'s bf16 / f32
    values."""
    return _pack_int8(params, cfg, ws) if mode == "int8" else _pack(params, cfg, ws, mode)


def _launch_coop(lib, params, cfg, x_seeds, nsteps, eps, u, ws, flags, mode, clock=None):
    """Form and pack the mode's operands, then one cooperative launch per 64
    songs, each with its zeroed global state (``clock``, an int64 per
    :data:`PHASE_PARTS` or None: the clock of :func:`phase_ms`). Returns
    (the first nonzero CUDA error, output)."""
    B, D = x_seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    dev, eb = x_seeds.device, _EBYTES[mode]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    w = _coop_operands(params, cfg, ws, mode)
    out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    packed = {}  # per head split; held by name until the launches are queued
    # every launch's plan before the first launch: a layout that does not
    # fit raises with nothing queued
    plans = [coop_plan(cfg, min(B - b0, _COOP_ROWS), n_sm, mode)
             for b0 in range(0, B, _COOP_ROWS)]
    for b0, plan in zip(range(0, B, _COOP_ROWS), plans):
        b = slice(b0, min(B, b0 + _COOP_ROWS))
        nb = b.stop - b0
        key = (plan["hs"], plan["P"])
        if key not in packed:
            packed[key] = pack_coop(w, cfg, plan["nu"], plan["G"], plan["P"], plan["hs"])
        q = packed[key]
        state = torch.zeros(lib.cvl_generate_cl_vae_coop_state_words(D, H, L, plan["nu"], eb),
                            dtype=torch.int32, device=dev)
        # the launch's songs: leading rows, contiguous views
        seeds_b, eps_b, u_b, encb_b, decb_b, out_b = (
            t[b] for t in (x_seeds, eps, u, w["encb"], w["decb"], out))
        err = lib.cvl_generate_cl_vae_coop(
            eb, ptr(seeds_b), ptr(eps_b), ptr(u_b), ptr(q["wke"]), ptr(q["wkd"]), ptr(q["wx"]),
            ptr(w.get("ske")), ptr(w.get("skd")), ptr(encb_b), ptr(decb_b), ptr(w["wz_t"]),
            ptr(w["bz"]), ptr(w["wkd_z"]), ptr(w.get("swx")), ptr(w["bx"]), ptr(out_b),
            ptr(state), ptr(clock), nb, nsteps, D, H, L, *flags, plan["nu"], plan["P"],
            plan["hs"], *(int(r) for r in plan["res"]),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            return err, out
    return 0, out


# the parts of a step of the cooperative kernel, in the order of its clock
# (each phase's work, then its wait at the grid barrier after it; rs and the
# codes are int8's alone)
PHASE_PARTS = ("encoder products", "encoder epilogue and z-head sums", "encoder wait", "z",
               "z wait", "decoder and maxima", "decoder wait", "rs and codes", "codes wait",
               "frame head products", "frame head epilogue", "frame wait")


def phase_ms(params, cfg, x_seeds, nsteps: int, eps, u, ws, use_z_prior: bool = False,
             mode: str = "int8") -> dict:
    """One launch of the cooperative kernel in ``mode`` (counted, as the
    wrapper counts it) on at most 64 songs on CUDA tensors, timed part by
    part on the card by block 0 (``%globaltimer``): ms of each of
    :data:`PHASE_PARTS` summed over the steps (a wait is the slowest block's
    lag and the grid barrier itself; under ``use_z_prior`` the first five
    are 0, and outside int8 rs and the codes)."""
    global LAUNCHES, COOP_LAUNCHES, INT8_LAUNCHES
    _resolve_mode(cfg, mode)
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    if x_seeds.shape[0] > _COOP_ROWS:
        raise ValueError(f"one launch takes at most {_COOP_ROWS} songs, got {x_seeds.shape[0]}")
    if not cfg.has_hidden:
        raise ValueError("the cooperative kernel needs hidden layers")
    dev = x_seeds.device
    lib = _kernels()
    with torch.cuda.device(dev):
        clock = torch.zeros(len(PHASE_PARTS), dtype=torch.int64, device=dev)
        err, _ = _launch_coop(lib, params, cfg, x_seeds, nsteps, eps, u, ws,
                              (int(cfg.use_x_prev), int(use_z_prior), 0), mode, clock)
    if err != 0:
        raise RuntimeError(f"generate_cl_vae_coop kernel launch failed in {mode}: CUDA error {err}")
    with _launch_lock:
        if mode == "int8":
            INT8_LAUNCHES += 1
        else:
            LAUNCHES += 1
            COOP_LAUNCHES += 1
    return dict(zip(PHASE_PARTS, (ns / 1e6 for ns in clock.cpu().tolist())))
