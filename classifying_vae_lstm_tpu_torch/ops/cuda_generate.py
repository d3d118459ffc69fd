"""Whole-generation cl_vrnn sampler: CUDA kernel wrapper and plain version.

Counterpart of ``classifying_vae_lstm_tpu/ops/pallas_generate.py``. The
kernels (``csrc/generate_cl_vrnn.cu``) run the entire autoregressive loop —
encoder cell, z heads, z draw, decoder cell, sigmoid frame head, Bernoulli
draw, feedback — in one cooperative launch whose blocks each own hidden
units of both cells (:func:`int8_grid`): ``generate_kernel`` with f32 or
bf16 weights (FFMA, or the bf16 tensor cores; :func:`pack_slices`,
:func:`pack_head`; the slices resident in shared memory where they fit),
``generate_int8_kernel`` with the five large weights as per-column int8
codes (the int8 tensor cores; :func:`pack_int8`). The sampler is a pure
function of its pre-drawn noise (``eps``
for z, ``u`` for the frames), so each kernel is held against
:func:`generate_cl_vrnn_batch_plain` on the card and the plain version
against the JAX package on the CPU, with the same noise.

The precision is the JAX package's (:func:`pick_mode`): the checkpoint's
numerics, and int8 where a bf16 checkpoint with ``lstm_backend == "pallas"``
falls in the JAX package's int8 band.

:func:`generate_cl_vrnn_batch_cuda` launches a kernel for CUDA tensors (or
raises) and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .lstm import _gates, bf16_operand

# launches since the counts were last set to 0: of the f32/bf16 kernel, and
# of the int8 kernel
LAUNCHES = 0
INT8_LAUNCHES = 0
_launch_lock = threading.Lock()

_SMEM_LIMIT = 232448      # dynamic shared memory one Hopper block can use
_H100_SMS = 132           # the grid fits() sizes the int8 kernel for
# the int8 kernel (csrc/generate_cl_vrnn.cu): a block owns at most
# _I8_MAX_UNITS hidden units (kMaxNT n8 tiles); its ring holds
# _I8_RING stages of _I8_CPS k32 chunks of 64 song rows and of the block's
# weights; a launch takes at most _I8_MAX_SONGS songs (c of both cells in
# shared memory), a call more in several launches
_I8_MAX_UNITS, _I8_RING, _I8_CPS, _I8_GROUP_ROWS, _I8_MAX_SONGS = 16, 4, 8, 64, 256
# the f32 / bf16 kernel: a unit group holds at most _G_MAX_UNITS hidden
# units (kGMaxNT n8 tiles), a block one group, or past 20 units a block on
# the card's SMs several (:func:`gen_grid`); a launch takes at most
# _G_MAX_SONGS songs (c of both cells in shared memory; fewer where a block
# owns several groups, :func:`launch_songs`), a call more in several
# launches; its ring holds _G_RING stages of _G_CPS 32-byte chunks of
# _G_PASS song rows
_G_MAX_UNITS, _G_MAX_SONGS, _G_PASS, _G_RING, _G_CPS = 20, 256, 64, 4, 8
_MODES = ("f32", "bf16", "int8")

# The JAX package's precision rule for this sampler (its ``_BUDGET`` and
# ``pick_mode``, ``pallas_generate.py:44,77-97``): the weight bytes of each
# mode against 28 MiB less 2.5 MiB. It is a size of the TPU kernel's VMEM,
# not of this card; the port copies it because it decides which songs a
# checkpoint gives.
_JAX_LIMIT = 28 * 1024 * 1024 - int(2.5 * 1024 * 1024)


def _jax_weight_bytes(D: int, H: int, L: int, mode: str) -> int:
    """The JAX package's ``_weight_bytes`` (``pallas_generate.py:56-74``):
    each weight at the type its kernel loads it in (the int8 mode keeps the
    z head bf16 and the decoder z rows f32, with five f32 scale vectors),
    the frame head lane-padded to a multiple of 128."""
    wb = {"f32": 4, "bf16": 2, "int8": 1}[mode]
    Dp = max(128, -(-D // 128) * 128)
    big = wb * (D * 4 * H + H * 4 * H + D * 4 * H + H * 4 * H + H * Dp)
    z_head = (2 if mode == "int8" else wb) * H * 128
    z_dec = (4 if mode == "int8" else wb) * L * 4 * H
    biases = 4 * (128 + Dp)
    scales = 4 * (4 * 4 * H + Dp) if mode == "int8" else 0
    return big + z_head + z_dec + biases + scales


def _jax_precision(cfg) -> str | None:
    """What the JAX package's ``pick_mode`` returns for ``cfg``: f32 or bf16
    (the checkpoint's numerics) while that mode's weights are under the
    limit, int8 past it for a bf16 checkpoint, else None (JAX then samples
    with its XLA scan)."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    ladder = ("bf16", "int8") if cfg.bf16_compute else ("f32",)
    return next((m for m in ladder if _jax_weight_bytes(D, H, L, m) < _JAX_LIMIT), None)


def pick_mode(cfg) -> str:
    """Weight precision, as the JAX package picks it: f32 unless the
    checkpoint computes its matmuls in bf16 (``cfg.bf16_compute``); int8
    where such a checkpoint selects the kernel path (``cfg.lstm_backend ==
    "pallas"``) and the JAX rule says int8 (at D=88, L=2: H = 1,240 …
    1,752); bf16 everywhere else, also where JAX falls back to its scan. The
    JAX package's device check is not copied."""
    if not cfg.bf16_compute:
        return "f32"
    if getattr(cfg, "lstm_backend", "xla") == "pallas" and _jax_precision(cfg) == "int8":
        return "int8"
    return "bf16"


def cdiv(a: int, b: int) -> int:
    """a / b rounded up."""
    return -(-a // b)


def int8_grid(H: int, n_sm: int) -> tuple[int, int]:
    """The int8 kernel's grid on a card of ``n_sm`` SMs: (nu, blocks), each
    block owning nu hidden units of both cells (nu even: two units, eight
    gate columns, to an n8 tile), cdiv(H, nu) <= n_sm blocks. At H=1,536
    on 132 SMs: 128 blocks of 12 units; at H=1,752: 126 of 14."""
    nu = 2 * cdiv(H, 2 * n_sm)
    return nu, cdiv(H, nu)


def _int8_smem(nu: int, B: int, L: int) -> int:
    """Shared memory of one int8 block owning nu units, for B songs and L
    latents: the ring (codes of 64 song rows and the block's weights,
    _I8_CPS k32 chunks a stage), c of both cells ([nu][B rounded to 16]
    floats each), the block's columns of the four scale vectors and of the
    decoder's z rows, and the z of 64 songs."""
    ring = _I8_RING * (_I8_CPS * _I8_GROUP_ROWS * 32 + _I8_CPS * (nu // 2) * 256)
    return ring + (2 * nu * (-(-B // 16) * 16) + (4 + L) * 4 * nu + _I8_GROUP_ROWS * L) * 4


def gen_grid(H: int, n_sm: int) -> tuple[int, int, int]:
    """The f32 / bf16 kernel's grid on a card of ``n_sm`` SMs: (nu, nv,
    blocks), each block owning nv groups of nu hidden units of both cells
    (nu even, at most _G_MAX_UNITS), each group a slice of its own. Where
    :func:`int8_grid` gives at most 20 units a block (H <= 2,640 on 132
    SMs) it is that grid with nv = 1; past it a block owns nv = cdiv(nu,
    20) groups of nu = 2 cdiv(H, 2 nv n_sm) units: at H=2,688, 112 blocks
    of 2 groups of 12; at H=4,096, 128 blocks of 2 groups of 16."""
    nu, G = int8_grid(H, n_sm)
    if nu <= _G_MAX_UNITS:
        return nu, 1, G
    nv = cdiv(nu, _G_MAX_UNITS)
    nu = 2 * cdiv(H, 2 * nv * n_sm)
    return nu, nv, cdiv(cdiv(H, nu), nv)


def round16(n: int) -> int:
    """n rounded up to a multiple of 16 (a k16 chunk, an m16 tile)."""
    return -(-n // 16) * 16


def slices_bytes(D: int, H: int, nu: int, use_x_prev: bool, wbytes: int) -> int:
    """Bytes of one block's two weight slices in the f32 / bf16 kernel
    (:func:`pack_slices`): the encoder's [round16(D) x rows | round16(H)
    recurrent rows] and the decoder's (x rows only with ``use_x_prev``),
    each row the block's 4 nu columns; rounded up to 16 bytes."""
    rows = 2 * round16(H) + round16(D) * (2 if use_x_prev else 1)
    return -(-rows * 4 * nu * wbytes // 16) * 16


def gen_smem(nu: int, B: int, L: int, resident: int = 0, nv: int = 1) -> int:
    """Shared memory of one f32 / bf16 block owning nv groups of nu units,
    for B songs and L latents: the resident slices (``resident`` bytes, 0
    where they stream), the cp.async ring (_G_RING stages of _G_CPS 32-byte
    chunks of 64 song rows, and of the slice where it streams; at least the
    bf16 warps' partial sums, 8 KB a pair of units), c of both cells ([nv][nu]
    [B rounded to 16] each), the groups' columns of the decoder's z rows and
    the z of 64 songs."""
    nt = nu // 2
    ring = max(_G_RING * (_G_CPS * _G_PASS * 32 + (0 if resident else _G_CPS * nt * 256)),
               8192 * nt)
    return resident + ring + (2 * nv * nu * round16(B) + 4 * nv * nu * L + _G_PASS * L) * 4


def launch_songs(nu: int, nv: int, L: int) -> int:
    """The most songs one launch of the f32 / bf16 kernel takes: _G_MAX_SONGS
    with one unit group a block; with several, the largest multiple of 16
    whose c of both cells fits beside the streamed ring (:func:`gen_smem`);
    0 where not even 16 songs fit (a call then raises)."""
    if nv == 1:
        return _G_MAX_SONGS
    return next((b for b in range(_G_MAX_SONGS, 0, -16)
                 if gen_smem(nu, b, L, 0, nv) <= _SMEM_LIMIT), 0)


def resident_bytes(D: int, H: int, L: int, nu: int, B: int, use_x_prev: bool, mode: str,
                   nv: int = 1) -> int:
    """The residency rule: with one unit group a block, the block's slices
    are copied into shared memory once per launch where they fit beside the
    state (:func:`gen_smem`); returns their bytes then, else 0 (they stream
    from L2, as they always do with several groups)."""
    if nv != 1:
        return 0
    res = slices_bytes(D, H, nu, use_x_prev, 2 if mode == "bf16" else 4)
    return res if gen_smem(nu, min(B, _G_MAX_SONGS), L, res) <= _SMEM_LIMIT else 0


def _smem_bytes(D: int, H: int, L: int, mode: str = "f32") -> int:
    if mode == "int8":
        return _int8_smem(int8_grid(H, _H100_SMS)[0], _I8_MAX_SONGS, L)
    nu, nv, _ = gen_grid(H, _H100_SMS)  # a launch of the most songs, on an H100's grid
    return gen_smem(nu, max(launch_songs(nu, nv, L), 16), L, 0, nv)


def smem_bytes(cfg, mode: str | None = None) -> int:
    """Shared memory of one block at a launch of the most songs on an
    H100's grid, the weights streamed (:func:`gen_smem`, at least 16 songs;
    in int8 mode :func:`_int8_smem`)."""
    return _smem_bytes(cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim,
                       mode or pick_mode(cfg))


def fits(cfg, mode: str | None = None) -> bool:
    """Does the kernel take the config on an H100's 132 SMs? In f32 / bf16
    at any width whose unit groups' c of 16 songs fits a block's shared
    memory beside the ring (:func:`gen_grid`, :func:`launch_songs`; past
    H ~ 80,000 at L=2); in int8 mode where the blocks cover the units with
    at most 16 a block and one block's state fits."""
    mode = mode or pick_mode(cfg)
    if mode == "int8" and int8_grid(cfg.intermediate_dim, _H100_SMS)[0] > _I8_MAX_UNITS:
        return False
    return smem_bytes(cfg, mode) <= _SMEM_LIMIT


def _resolve_mode(cfg, mode):
    mode = mode or pick_mode(cfg)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (f32, bf16 or int8)")
    return mode


def _quant_cols(w):
    """Per-output-column symmetric int8 quantization, the JAX package's
    ``_quant_cols`` (``pallas_generate.py:105-109``): ``s = max(max|w| over
    the rows / 127, 1e-12)``, ``q = round(w / s)`` (half to even). Returns
    (int8 codes [in, out], f32 scales [out]) with ``w ~= q * s``. Both
    quotients are true divisions by tensors, never products with a
    reciprocal."""
    m = w.abs().amax(dim=0)
    s = torch.clamp_min(m / torch.full_like(m, 127.0), 1e-12)
    return torch.round(w / s).to(torch.int8), s


def _pack(params, cfg, ws, D: int, mode: str) -> dict:
    """The kernels' operands: weights split by input rows (in the mode's
    type) and the per-song f32 folds of the w rows and biases. In int8 mode
    the five large weights are int8 codes with f32 scales (``s*``; those of
    the h operands divided by 127 first, ``s * (1 / 127)`` as JAX's
    ``qmm`` forms it), the z head bf16 and the decoder z rows f32."""
    L = cfg.latent_dim
    wt = torch.bfloat16 if mode == "bf16" else torch.float32
    enc, dec = params["encoder_h"], params["decoder_h"]
    n_xp = D if cfg.use_x_prev else 0
    cast = lambda w: w.to(wt).contiguous()
    w = {
        "wke_x": enc["kernel"][:D],
        "rke": enc["recurrent_kernel"],
        # w rows and bias folded per song: plain f32 products (TF32 is off)
        "encb": (torch.matmul(ws, enc["kernel"][D:]) + enc["bias"]).contiguous(),
        # heads transposed: one row per output column, read along k by a warp
        "wz_t": torch.cat([params["Z_mean"]["kernel"], params["Z_log_var"]["kernel"]], 1).T,
        "bz": torch.cat([params["Z_mean"]["bias"], params["Z_log_var"]["bias"]]).contiguous(),
        "wkd_x": dec["kernel"][:n_xp] if cfg.use_x_prev else None,
        "wkd_z": dec["kernel"][n_xp : n_xp + L],
        "rkd": dec["recurrent_kernel"],
        "decb": (torch.matmul(ws, dec["kernel"][n_xp + L :]) + dec["bias"]).contiguous(),
        "wx_t": params["X_decoded_mean"]["kernel"].T,
        "bx": params["X_decoded_mean"]["bias"].contiguous(),
    }
    if mode != "int8":
        for k in ("wke_x", "rke", "wz_t", "wkd_x", "wkd_z", "rkd", "wx_t"):
            w[k] = cast(w[k]) if w[k] is not None else None
        return w
    # 1/127 rounded to f32 before it multiplies, as JAX's weakly typed scalar
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=ws.device)
    for k, per_h in (("wke_x", False), ("rke", True), ("wkd_x", False), ("rkd", True)):
        if w[k] is not None:
            w[k], s = _quant_cols(w[k])
            w["s" + k] = s * inv127 if per_h else s
    q, s = _quant_cols(params["X_decoded_mean"]["kernel"])
    w["wx_t"], w["swx"] = q.T.contiguous(), s * inv127
    w["wz_t"] = w["wz_t"].to(torch.bfloat16).contiguous()
    w["wkd_z"] = w["wkd_z"].contiguous()
    return w


def _qmm(a_q, q64, scale):
    """JAX's ``qmm``: the integer product of the codes, cast to f32, times
    the scales. The product is taken in float64 (``q64``: the weight codes
    as float64), which holds every partial sum of int8 codes exactly (|sum|
    <= K * 127^2 < 2^53), so the one f32 rounding is the cast's, as in
    JAX's int32 -> f32."""
    return (a_q.double() @ q64).float() * scale


def _z_head(h, wz_t):
    """The int8 mode's bf16 z head, ``bf16(h) @ wz_t.T``: each product of two
    bf16 values is exact and the sum is taken in float64, then rounded to f32
    once, so that the kernels' z heads (which sum in double too) give the
    same z in any order. An f32 sum in another order may differ by an ulp,
    which h * 127 (or h_d / rs) can turn into another code."""
    return (bf16_operand(h).double() @ wz_t.double().T).float()


def _codes64(w: dict) -> dict:
    """The int8 codes of ``w`` as float64 (taken once per call)."""
    return {k: (v.double() if v is not None and v.dtype == torch.int8 else v)
            for k, v in w.items()}


def _step_int8(w, cfg, x_in, h_e, c_e, h_d, c_d, eps_t):
    """One step of the JAX int8 kernel (``pallas_generate.py:211-280``),
    f32 additions in its order; ``w`` from :func:`_codes64`."""
    H, L = cfg.intermediate_dim, cfg.latent_dim
    x_q = torch.trunc(x_in)  # JAX's astype(int8); binary frames are exact
    h_q = torch.round(h_e * 127.0)
    z_e = _qmm(x_q, w["wke_x"], w["swke_x"]) + w["encb"] + _qmm(h_q, w["rke"], w["srke"])
    h_e, c_e = _gates(z_e, c_e, H)
    zmv = _z_head(h_e, w["wz_t"]) + w["bz"]
    z = zmv[:, :L] + torch.exp(zmv[:, L:] / 2) * eps_t
    z_d = w["decb"] + _qmm(torch.round(h_d * 127.0), w["rkd"], w["srkd"])
    for l in range(L):
        z_d = z_d + z[:, l : l + 1] * w["wkd_z"][l]
    if cfg.use_x_prev:
        z_d = z_d + _qmm(x_q, w["wkd_x"], w["swkd_x"])
    h_d, c_d = _gates(z_d, c_d, H)
    xm = torch.sigmoid(_qmm(torch.round(h_d * 127.0), w["wx_t"].T, w["swx"]) + w["bx"])
    return h_e, c_e, h_d, c_d, xm


def generate_cl_vrnn_batch_plain(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                                 return_probs: bool = False, mode: str | None = None):
    """The kernel's function step by step in torch ops (its plain version).

    x_seeds [B, Tseed, D]; eps [B, total, L]; u [B, total, D]; ws [B, K];
    returns [B, nsteps, D] post-seed frames (probabilities with
    ``return_probs``). In bf16 mode the weights and the x/h operands are
    rounded to bf16 and multiplied in f32 — ``a.bfloat16().float() @
    w.bfloat16().float()`` — since a CPU bf16 matmul would round its output
    to bf16, which the JAX ``preferred_element_type=f32`` product does not.
    In int8 mode x (binary) and ``h = round(h * 127)`` are the codes that
    multiply the int8 weights, each product exact (:func:`_qmm`).
    """
    mode = _resolve_mode(cfg, mode)
    B, Tseed, D = x_seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    w = _pack(params, cfg, ws, D, mode)
    if mode == "int8":
        f = _codes64(w)
    else:
        f = {k: (v.float() if v is not None else None) for k, v in w.items()}
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    h_e = c_e = h_d = c_d = x_seeds.new_zeros((B, H))
    x_prev = x_seeds.new_zeros((B, D))
    outs = []
    for t in range(Tseed + nsteps):
        x_in = x_seeds[:, t] if t < Tseed else x_prev
        if mode == "int8":
            h_e, c_e, h_d, c_d, xm = _step_int8(f, cfg, x_in, h_e, c_e, h_d, c_d, eps[:, t])
        else:
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


def _pack_cells(q, H: int, nu: int):
    """One cell weight's int8 codes [K, 4H] (gate-ordered columns) -> the
    int8 kernel's [G, KC, NT, 64] int32 words: G = cdiv(H, nu) blocks, KC =
    cdiv(K, 32) chunks of k (zero rows pad K), NT = nu / 2 n8 tiles of the
    block's columns, each tile two units' four gates (column c of tile n:
    unit u0 + 2n + c // 4, gate c % 4; zero columns past H). In a chunk the
    32 words are the B fragments of `mma.sync.m16n8k32` lane by lane: lane
    4g + t holds column g, codes of k = 8t .. 8t + 3 (register 0) and 8t + 4
    .. 8t + 7 (register 1), byte i of a word the i-th of its four k; the
    kernel's A fragments take the same k from the codes of x and h."""
    K = q.shape[0]
    KC, G, NT = -(-K // 32), -(-H // nu), nu // 2
    qp = q.new_zeros((KC * 32, 4 * H + 1))  # the last column: zeros, for units past H
    qp[:K, :4 * H] = q
    u = torch.arange(G * nu, device=q.device).view(G, NT, 2, 1)
    gate = torch.arange(4, device=q.device).view(1, 1, 1, 4)
    col = torch.where(u < H, gate * H + u, 4 * H)  # [G, NT, 2 units, 4 gates]
    w = qp[:, col.reshape(-1)].view(KC, 4, 2, 4, G, NT, 8)  # k = 32 kc + 8 t + 4 r + i
    w = w.permute(4, 0, 5, 6, 1, 2, 3).contiguous()  # [G, KC, NT, g, t, r, i]
    return w.view(torch.int32).view(G, KC, NT, 64)


def _pack_head(q):
    """The frame head's int8 codes [H, D] -> [NTx, KC, 64] int32 words: NTx
    = cdiv(D, 8) tiles of 8 pitches, each chunk's B fragments as in
    :func:`_pack_cells` (zero rows and columns pad H and D)."""
    H, D = q.shape
    KC, NTx = -(-H // 32), -(-D // 8)
    qp = q.new_zeros((KC * 32, NTx * 8))
    qp[:H, :D] = q
    w = qp.view(KC, 4, 2, 4, NTx, 8).permute(4, 0, 5, 1, 2, 3).contiguous()
    return w.view(torch.int32).view(NTx, KC, 64)


def pack_int8(w: dict, cfg, nu: int) -> dict:
    """The int8 kernel's weights from :func:`_pack`'s codes: per block the
    encoder's x rows then its recurrent kernel (``enc``), the decoder's
    x_prev rows (with ``use_x_prev``) then its recurrent kernel (``dec``),
    chunk after chunk, and the frame head (``head``)."""
    H = cfg.intermediate_dim
    enc = torch.cat([_pack_cells(w["wke_x"], H, nu), _pack_cells(w["rke"], H, nu)], 1)
    parts = ([_pack_cells(w["wkd_x"], H, nu)] if cfg.use_x_prev else []) + \
        [_pack_cells(w["rkd"], H, nu)]
    return {"enc": enc.contiguous(), "dec": torch.cat(parts, 1).contiguous(),
            "head": _pack_head(w["wx_t"].T)}


def _slice_cols(H: int, nu: int, device=None):
    """[G, 4 nu] columns of a gate-ordered [K, 4H] weight that each block of
    the f32 / bf16 kernel owns: local column 4j + g is unit u0 + j, gate g
    (g*H + u); 4H, a zero column, past H."""
    G = -(-H // nu)
    u = torch.arange(G * nu, device=device).view(G, nu, 1)
    gate = torch.arange(4, device=device).view(1, 1, 4)
    return torch.where(u < H, gate * H + u, 4 * H).view(G, 4 * nu)


def pack_slices(w_x, rk, H: int, nu: int, D: int, bf16: bool):
    """One cell's weights for the f32 / bf16 kernel, each block's slice
    contiguous: the rows are w_x's ([D, 4H], zero rows to round16(D); none
    for None) then rk's ([H, 4H], zero rows to round16(H)), the columns the
    block's :func:`_slice_cols`. f32: ``[G, 4 nu, K]``, column by column
    (a lane's 4 k of a column are one 16-byte read). bf16:
    ``[G, K/16, nu/2, 32, 4]``, the B fragments of ``mma.sync.m16n8k16``
    chunk by chunk and n8 tile by tile: lane 4g + t holds local column 8n +
    g at k = 16 kc + 4t .. 4t + 3 (its registers b0 = k, k + 1 and b1 =
    k + 2, k + 3), the k the kernel's A fragments take from h and x."""
    parts = ([(w_x, round16(D))] if w_x is not None else []) + [(rk, round16(H))]
    K = sum(k for _, k in parts)
    w = rk.new_zeros((K, 4 * H + 1))  # the last column: zeros, for units past H
    k0 = 0
    for m, k in parts:
        w[k0:k0 + m.shape[0], :4 * H] = m
        k0 += k
    cols = _slice_cols(H, nu, rk.device)
    G = cols.shape[0]
    sel = w[:, cols.reshape(-1)].view(K, G, 4 * nu)
    if not bf16:
        return sel.permute(1, 2, 0).contiguous()
    v = sel.view(K // 16, 4, 4, G, nu // 2, 8)  # k = 16 kc + 4 t + i, column 8 n + g
    return v.permute(3, 0, 4, 5, 1, 2).contiguous().view(G, K // 16, nu // 2, 32, 4)


def pack_head(wx_t, bf16: bool):
    """The frame head ``wx_t [D, H]`` for the f32 / bf16 kernel. f32: ``[8
    NTx, round16(H)]`` (NTx = cdiv(D, 8); zero rows and columns pad it).
    bf16: ``[NTx, round16(H)/16, 32, 4]``, the B fragments as in
    :func:`pack_slices`, pitch 8n + g for lane 4g + t."""
    D, H = wx_t.shape
    Kh, ntx = round16(H), -(-D // 8)
    if not bf16:
        out = wx_t.new_zeros((8 * ntx, Kh))
        out[:D, :H] = wx_t
        return out
    w = wx_t.new_zeros((Kh, 8 * ntx))
    w[:H, :D] = wx_t.T
    return w.view(Kh // 16, 4, 4, ntx, 8).permute(3, 0, 4, 1, 2).contiguous().view(
        ntx, Kh // 16, 32, 4)


_lib_lock = threading.Lock()
_lib = None


def _kernels():
    """The built library, its entry points' ctypes signatures set and its
    shared-memory layouts checked against :func:`_smem_bytes`."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _build.load("generate_cl_vrnn")
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.cvl_generate_cl_vrnn_smem_bytes
            fn.argtypes, fn.restype = [I] * 9, LL
            i8 = lib.cvl_generate_cl_vrnn_int8_smem_bytes
            i8.argtypes, i8.restype = [I] * 3, LL
            lib.cvl_generate_cl_vrnn_int8_state_words.argtypes = [I] * 4
            lib.cvl_generate_cl_vrnn_int8_state_words.restype = LL
            lib.cvl_generate_cl_vrnn_state_bytes.argtypes = [I] * 5
            lib.cvl_generate_cl_vrnn_state_bytes.restype = LL
            for nu, B, D, H, L, xp, b, nv in ((2, 64, 88, 256, 8, 1, 0, 1),
                                              (8, 256, 88, 1024, 2, 1, 1, 1),
                                              (2, 1, 13, 7, 3, 0, 1, 1),
                                              (16, 100, 88, 2048, 2, 0, 0, 1),
                                              (16, 256, 88, 4096, 2, 1, 1, 2),
                                              (12, 48, 13, 2688, 5, 0, 0, 3)):
                for res in (0, 1) if nv == 1 else (0,):
                    want = gen_smem(nu, B, L, slices_bytes(D, H, nu, xp, 2 if b else 4) * res,
                                    nv)
                    if fn(nu, B, D, H, L, xp, b, res, nv) != want:
                        raise RuntimeError("shared-memory layout of csrc/generate_cl_vrnn.cu "
                                           f"differs from gen_smem at nu={nu}, B={B}, H={H}")
            for nu, B, L in ((2, 1, 3), (12, 64, 2), (14, 100, 2), (16, 256, 16)):
                if i8(nu, B, L) != _int8_smem(nu, B, L):
                    raise RuntimeError("shared-memory layout of the int8 kernel differs from "
                                       f"_int8_smem at nu={nu}, B={B}, L={L}")
            lib.cvl_generate_cl_vrnn.argtypes = [I] + [P] * 15 + [I] * 11 + [P]
            lib.cvl_generate_cl_vrnn_int8.argtypes = [P] * 20 + [I] * 9 + [P]
            lib.cvl_generate_cl_vrnn.restype = lib.cvl_generate_cl_vrnn_int8.restype = I
            _lib = lib
        return _lib


def _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode=None):
    """Raise on anything the kernel of ``mode`` does not take."""
    if x_seeds.dim() != 3:
        raise ValueError(f"x_seeds must be [B, Tseed, D], got {tuple(x_seeds.shape)}")
    B, Tseed, D = x_seeds.shape
    H, L, K = cfg.intermediate_dim, cfg.latent_dim, cfg.n_classes
    total = Tseed + nsteps
    if nsteps < 1 or Tseed < 1 or B < 1:
        raise ValueError(f"need B, Tseed, nsteps >= 1 (got {B}, {Tseed}, {nsteps})")
    if D != cfg.original_dim:
        raise ValueError(f"seed width {D} != original_dim {cfg.original_dim}")
    if not fits(cfg, mode):
        raise ValueError(f"the state of one block at the fewest songs a launch takes needs "
                         f"{smem_bytes(cfg, mode)} B of shared memory, past the limit of "
                         f"{_SMEM_LIMIT} B: hidden {H}, latent {L}")
    dev = x_seeds.device
    if mode == "int8":
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        nu = int8_grid(H, n_sm)[0]
        if nu > _I8_MAX_UNITS or _int8_smem(nu, min(B, _I8_MAX_SONGS), L) > _SMEM_LIMIT:
            raise ValueError(f"hidden {H} needs {nu} units a block on {n_sm} SMs; the int8 "
                             f"kernel takes at most {_I8_MAX_UNITS}")
    elif dev.type == "cuda":
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        nu, nv, _ = gen_grid(H, n_sm)
        if launch_songs(nu, nv, L) == 0:
            raise ValueError(f"hidden {H} needs {nv} groups of {nu} units a block on {n_sm} "
                             f"SMs, whose c of 16 songs needs {gen_smem(nu, 16, L, 0, nv)} B "
                             f"of shared memory, past the limit of {_SMEM_LIMIT} B")
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


def _launch_int8(lib, w, cfg, x_seeds, eps, u, out, return_probs, stream, clock=None):
    """The int8 kernel on :func:`_pack`'s operands: the weights packed per
    block (:func:`pack_int8`), then one cooperative launch per
    _I8_MAX_SONGS songs, each with its zeroed global state (``clock``, 10
    int64 or None: the clock of :func:`phase_ms`). Returns the first
    nonzero CUDA error."""
    B, Tseed, D = x_seeds.shape
    H, L, total = cfg.intermediate_dim, cfg.latent_dim, eps.shape[1]
    dev = x_seeds.device
    nu = int8_grid(H, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    q = pack_int8(w, cfg, nu)  # held by name until the launches are queued
    ptr = lambda t: None if t is None else t.data_ptr()
    for b0 in range(0, B, _I8_MAX_SONGS):
        b = slice(b0, min(B, b0 + _I8_MAX_SONGS))
        nb = b.stop - b0
        state = torch.zeros(lib.cvl_generate_cl_vrnn_int8_state_words(nb, D, H, L),
                            dtype=torch.int32, device=dev)
        rows = [t[b] for t in (x_seeds, eps, u)]  # leading rows: contiguous views
        err = lib.cvl_generate_cl_vrnn_int8(
            *(t.data_ptr() for t in rows), ptr(q["enc"]), ptr(q["dec"]), ptr(q["head"]),
            ptr(w["swke_x"]), ptr(w["srke"]), ptr(w["encb"][b]), ptr(w["wz_t"]), ptr(w["bz"]),
            ptr(w.get("swkd_x")), ptr(w["wkd_z"]), ptr(w["srkd"]), ptr(w["decb"][b]),
            ptr(w["swx"]), ptr(w["bx"]), out[b].data_ptr(), state.data_ptr(), ptr(clock), nb,
            Tseed, total, D, H, L, int(cfg.use_x_prev), int(return_probs), nu, stream)
        if err != 0:
            return err
    return 0


def _launch_gen(lib, w, cfg, x_seeds, eps, u, out, return_probs, stream, mode, clock=None):
    """The f32 / bf16 kernel on :func:`_pack`'s operands: the slices packed
    per unit group (:func:`pack_slices`, :func:`pack_head`), then one
    cooperative launch per :func:`launch_songs` songs, each with its zeroed
    global state and the slices resident where :func:`resident_bytes` says
    they fit (``clock``, 10 int64 or None: the clock of :func:`phase_ms`).
    Returns the first nonzero CUDA error."""
    B, Tseed, D = x_seeds.shape
    H, L, total = cfg.intermediate_dim, cfg.latent_dim, eps.shape[1]
    dev, bf16 = x_seeds.device, mode == "bf16"
    nu, nv, _ = gen_grid(H, torch.cuda.get_device_properties(dev).multi_processor_count)
    per = launch_songs(nu, nv, L)
    # held by name until the launches are queued
    enc = pack_slices(w["wke_x"], w["rke"], H, nu, D, bf16)
    dec = pack_slices(w["wkd_x"], w["rkd"], H, nu, D, bf16)
    head = pack_head(w["wx_t"], bf16)
    wkd_z = w["wkd_z"].float().contiguous()  # the z rows widened: z stays f32
    for b0 in range(0, B, per):
        b = slice(b0, min(B, b0 + per))
        nb = b.stop - b0
        res = resident_bytes(D, H, L, nu, nb, cfg.use_x_prev, mode, nv)
        state = torch.zeros(lib.cvl_generate_cl_vrnn_state_bytes(nb, D, H, L, int(bf16)),
                            dtype=torch.uint8, device=dev)
        rows = [t[b] for t in (x_seeds, eps, u)]  # leading rows: contiguous views
        encb, decb = w["encb"][b], w["decb"][b]
        err = lib.cvl_generate_cl_vrnn(
            int(bf16), *(t.data_ptr() for t in rows), enc.data_ptr(), dec.data_ptr(),
            head.data_ptr(), encb.data_ptr(), w["wz_t"].data_ptr(), w["bz"].data_ptr(),
            wkd_z.data_ptr(), decb.data_ptr(), w["bx"].data_ptr(), out[b].data_ptr(),
            state.data_ptr(), None if clock is None else clock.data_ptr(), nb, Tseed, total, D, H,
            L, int(cfg.use_x_prev), int(return_probs), nu, nv, int(res > 0), stream)
        if err != 0:
            return err
    return 0


# the parts of a step of either cooperative kernel, in the order of its
# clock (each phase's work, then its wait at the grid barrier after it)
PHASE_PARTS = ("encoder products", "encoder epilogue", "encoder wait", "z heads", "z wait",
               "decoder products", "decoder epilogue", "decoder wait", "frame head", "frame wait")


def phase_ms(params, cfg, x_seeds, nsteps: int, eps, u, ws, mode: str) -> dict:
    """One launch of ``mode``'s kernel (counted, as the wrapper counts it)
    on the songs one launch takes (256, or :func:`launch_songs`) on CUDA
    tensors, timed part by part on the card by
    block 0 (``%globaltimer``): ms of each of :data:`PHASE_PARTS` summed
    over the steps (a wait is the slowest block's lag and the barrier
    itself)."""
    global LAUNCHES, INT8_LAUNCHES
    mode = _resolve_mode(cfg, mode)
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    B, Tseed, D = x_seeds.shape
    dev = x_seeds.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nu, nv, _ = gen_grid(cfg.intermediate_dim, n_sm)
    most = _I8_MAX_SONGS if mode == "int8" else launch_songs(nu, nv, cfg.latent_dim)
    if B > most:
        raise ValueError(f"one launch takes at most {most} songs, got {B}")
    lib = _kernels()
    with torch.cuda.device(dev):
        w = _pack(params, cfg, ws, D, mode)
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        clock = torch.zeros(len(PHASE_PARTS), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "int8":
            err = _launch_int8(lib, w, cfg, x_seeds, eps, u, out, False, stream, clock)
        else:
            err = _launch_gen(lib, w, cfg, x_seeds, eps, u, out, False, stream, mode, clock)
    if err != 0:
        raise RuntimeError(f"generate_cl_vrnn ({mode}) kernel launch failed: CUDA error {err}")
    with _launch_lock:
        if mode == "int8":
            INT8_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return dict(zip(PHASE_PARTS, (ns / 1e6 for ns in clock.cpu().tolist())))


def generate_cl_vrnn_batch_cuda(params, cfg, x_seeds, nsteps: int, eps, u, ws,
                                return_probs: bool = False, mode: str | None = None):
    """Kernel counterpart of ``generate_cl_vrnn_batch_pallas`` (same signature).

    x_seeds [B, Tseed, D]; eps [B, total, L]; u [B, total, D]; ws [B, K];
    returns [B, nsteps, D]. CUDA tensors launch a kernel on the current
    stream (or raise: there is no fallback): ``generate_kernel`` in f32 and
    bf16 mode (at any width, :func:`gen_grid`), ``generate_int8_kernel`` in
    int8 mode (each one cooperative launch per 256 songs, fewer where
    :func:`launch_songs` says so, counted as one call; a grid that cannot be
    co-resident raises); CPU tensors take
    :func:`generate_cl_vrnn_batch_plain`. ``mode`` is ``"f32"``, ``"bf16"``
    or ``"int8"`` (default :func:`pick_mode`).
    """
    global LAUNCHES, INT8_LAUNCHES
    mode = _resolve_mode(cfg, mode)
    if x_seeds.device.type == "cpu":
        return generate_cl_vrnn_batch_plain(params, cfg, x_seeds, nsteps, eps, u, ws,
                                            return_probs=return_probs, mode=mode)
    if x_seeds.device.type != "cuda":
        raise ValueError(f"unsupported device {x_seeds.device}")
    _check(params, cfg, x_seeds, nsteps, eps, u, ws, mode)
    B, Tseed, D = x_seeds.shape
    dev = x_seeds.device
    lib = _kernels()
    with torch.cuda.device(dev):
        w = _pack(params, cfg, ws, D, mode)
        out = torch.empty((B, nsteps, D), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "int8":
            err = _launch_int8(lib, w, cfg, x_seeds, eps, u, out, return_probs, stream)
        else:
            err = _launch_gen(lib, w, cfg, x_seeds, eps, u, out, return_probs, stream, mode)
    kernel = "generate_cl_vrnn_int8" if mode == "int8" else "generate_cl_vrnn"
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    with _launch_lock:
        if mode == "int8":
            INT8_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return out
