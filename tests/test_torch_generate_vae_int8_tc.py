"""The int8 cl_vae generation kernel's layouts and sum order, on the CPU.

``csrc/generate_cl_vae.cu`` ``generate_vae_coop_kernel<signed char>`` runs only on the
card; what surrounds it is Python that these tests reach: the grid
(:func:`coop_grid`: which block owns which hidden units), the frame head's
split (:func:`head_split`: which block owns which pitch tiles for which
songs), the packing of each block's slices in the order the
``mma.sync.m16n8k32`` B fragments load them (:func:`pack_coop`), and the
residency rule (:func:`coop_residency`). The packed slices are unpacked here
by an independent reading of the layout and must give back ``_quant_cols``'
codes; the kernel's tile sums, emulated in int64 from the fragments its
lanes load (the PTX ISA's m16n8k32 layout), must equal ``_qmm`` bit for bit;
and a plain-torch emulation of a step's cross-block order (the z heads
summed over each block's units in double, the blocks' sums added lane by
lane and by a butterfly, the maxima of h_d over the blocks, the int32
products) must equal ``_plain_int8``: probabilities within 1e-6 and frames
equal. No generation runs here at the band's widths (H = 4,160 ... 7,808).
"""

import dataclasses

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

L, K = 16, 13
BAND = (4160, 5120, 6144, 7808)


def _cfg(D, H, L_=L, use_x_prev=False):
    return tvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L_,
                       intermediate_class_dim=32, n_classes=K, use_x_prev=use_x_prev,
                       bf16_compute=True, gen_backend="pallas")


def _params(D, H, L_, use_x_prev, seed=0):
    """Seeded glorot-scale weights (the frame bias -2: sparse frames)."""
    rng = np.random.default_rng(seed)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    n_xp = D if use_x_prev else 0
    zeros = lambda n: np.zeros(n, np.float32)
    raw = {"h_w": {"kernel": glorot(D, 32), "bias": zeros(32)},
           "w_mean": {"kernel": glorot(32, K - 1), "bias": zeros(K - 1)},
           "w_log_var": {"kernel": glorot(32, K - 1), "bias": zeros(K - 1)},
           "h": {"kernel": glorot(D + K, H), "bias": rng.normal(0, 0.1, H).astype(np.float32)},
           "z_mean": {"kernel": glorot(H, L_), "bias": zeros(L_)},
           "z_log_var": {"kernel": glorot(H, L_), "bias": zeros(L_)},
           "decoder_h": {"kernel": glorot(K + n_xp + L_, H),
                         "bias": rng.normal(0, 0.1, H).astype(np.float32)},
           "x_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)}}
    return params_from_numpy(raw, "cpu")


def _bytes(words):
    """int32 words [..., n] -> their bytes [..., n, 4] as int64 (byte i of a
    word is the i-th in memory: little-endian)."""
    w = np.ascontiguousarray(words.numpy() if torch.is_tensor(words) else words)
    return w.view(np.int8).reshape(w.shape + (4,)).astype(np.int64)


def _unpack_units(packed, K_, H, nu):
    """[G, KC, NT, 64] words -> the [K_, H] codes they hold, read as the
    kernel's lanes read them: word 2 lane + r of a tile's chunk is register r
    of lane 4g + t, codes of k = 32 kc + 8t + 4r + i (byte i), column g of
    tile n of block b: unit b nu + 8n + g. Every code past K_ or H is 0, and
    every code is packed exactly once."""
    G, KC, NT, _ = packed.shape
    b = _bytes(packed).reshape(G, KC, NT, 8, 4, 2, 4)  # [blk, kc, n, g, t, r, i]
    blk, kc, n, g, t, r, i = np.indices(b.shape, sparse=True)
    k, unit = 32 * kc + 8 * t + 4 * r + i, blk * nu + 8 * n + g
    inside = np.broadcast_to((k < K_) & (unit < H), b.shape)
    assert not b[~inside].any(), "padding holds nonzero codes"
    kk, uu = np.broadcast_to(k, b.shape)[inside], np.broadcast_to(unit, b.shape)[inside]
    out = np.zeros((K_, H), np.int64)
    out[kk, uu] = b[inside]
    hits = np.zeros((K_, H), np.int64)
    np.add.at(hits, (kk, uu), 1)
    assert (hits == 1).all(), "a code is packed twice or not at all"
    return out


def _unpack_head(packed, H, D, hs):
    """[G, KC, P, 64] words -> the [H, D] frame head, read per song group:
    slot j of block b is pitch tile P (b // hs) + j, its column g pitch 8
    tile + g. Within each song group every pitch is owned by exactly one
    block; slots past the last tile are zero."""
    G, KC, P, _ = packed.shape
    b = _bytes(packed).reshape(G, KC, P, 8, 4, 2, 4)  # [blk, kc, j, g, t, r, i]
    blk, kc, j, g, t, r, i = np.indices(b.shape, sparse=True)
    k, d = 32 * kc + 8 * t + 4 * r + i, 8 * ((blk // hs) * P + j) + g
    inside = (k < H) & (d < D)
    got = []
    for sg in range(hs):
        mine = np.broadcast_to(inside & (blk % hs == sg), b.shape)
        assert not b[np.broadcast_to(~inside, b.shape)].any(), "padding holds nonzero codes"
        kk, dd = np.broadcast_to(k, b.shape)[mine], np.broadcast_to(d, b.shape)[mine]
        out = np.zeros((H, D), np.int64)
        out[kk, dd] = b[mine]
        hits = np.zeros((H, D), np.int64)
        np.add.at(hits, (kk, dd), 1)
        assert (hits == 1).all(), f"song group {sg}: a pitch is owned twice or not at all"
        got.append(out)
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    return got[0]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("H", [64, 262, 320, *BAND])
def test_every_unit_and_pitch_is_owned_once(H, n_sm):
    """``coop_grid``: nu a multiple of 8, at most n_sm blocks, each hidden
    unit in exactly one block (a weight whose column u holds the id of u,
    read back block by block); ``head_split``: for launches of 1 and 64
    songs, each pitch of the frame head in exactly one block of each song
    group, and the song groups cover the m16 tiles once."""
    D = 1024 if H > 1000 else 64
    nu, G = cgv.coop_grid(H, n_sm)
    assert nu % 8 == 0 and G <= n_sm and G == -(-H // nu) and (G - 1) * nu < H
    ids = torch.arange(H, dtype=torch.int64)
    cols = np.zeros((G, nu), np.int64)
    for shift in (0, 8):  # H distinct ids need more than int8: one byte at a time
        q = ((ids >> shift) & 0xFF).to(torch.uint8).view(torch.int8).expand(1, -1).contiguous()
        b = _bytes(cgv.pack_units(q, nu)).reshape(G, 1, nu // 8, 8, 4, 2, 4)
        cols += (b[:, 0, :, :, 0, 0, 0] & 0xFF).reshape(G, nu) << shift  # k = 0: lane 4g, byte 0
    for blk in range(G):
        u = blk * nu + np.arange(nu)
        np.testing.assert_array_equal(cols[blk], np.where(u < H, u, 0))
    for B in (1, 5, 16, 17, 64):
        hs, P = cgv.head_split(D, G, B)
        assert hs == (2 if B > 16 else 1) and P <= cgv._COOP_MAX_NT * 4
        assert -(-(-(-D // 8)) // P) * hs <= G  # the pitch groups fit the grid
        mt = -(-B // 16)
        mtg = -(-mt // hs)
        runs = [range(sg * mtg, min(mt, (sg + 1) * mtg)) for sg in range(hs)]
        assert sorted(m for r in runs for m in r) == list(range(mt))


@pytest.mark.parametrize("use_x_prev", [False, True])
@pytest.mark.parametrize("D,H", [(64, 320), (1024, 4160)])
def test_packed_slices_unpack_to_the_quantized_codes(D, H, use_x_prev):
    """Each block's units of the encoder's and the decoder's x rows and its
    pitch tiles of the frame head give back ``_quant_cols``' codes, with
    zeros wherever K, H or D is padded, for both head splits."""
    cfg = _cfg(D, H, use_x_prev=use_x_prev)
    ws = torch.eye(K)[torch.arange(3) % K]
    w = cgv._pack_int8(_params(D, H, L, use_x_prev), cfg, ws)
    nu, G = cgv.coop_grid(H, 132)
    for B in (1, 64):
        hs, P = cgv.head_split(D, G, B)
        q = cgv.pack_coop(w, cfg, nu, G, P, hs)
        assert q["wke"].shape == (G, -(-D // 32), nu // 8, 64)
        assert q["wx"].shape == (G, -(-H // 32), P, 64)
        as64 = lambda t: t.numpy().astype(np.int64)
        np.testing.assert_array_equal(_unpack_units(q["wke"], D, H, nu), as64(w["wke"]))
        if use_x_prev:
            np.testing.assert_array_equal(_unpack_units(q["wkd"], D, H, nu), as64(w["wkd_x"]))
        else:
            assert q["wkd"] is None
        np.testing.assert_array_equal(_unpack_head(q["wx"], H, D, hs), as64(w["wx"]))


def _a_tiles(codes, kc):
    """The mma-view A tiles [rows / 16, 16, 32] of chunk kc of a codes buffer
    [rows, KC * 8] words, from the registers the kernel's lanes load: lane
    4g + t takes words 2t and 2t + 1 of rows g and g + 8 as a0 = (g, 2t), a1
    = (g + 8, 2t), a2 = (g, 2t + 1), a3 = (g + 8, 2t + 1); the m16n8k32 A
    layout reads a0 as row g, k 4t .. 4t + 3, a1 as row g + 8, the same k,
    a2 and a3 as k 16 + 4t .. 16 + 4t + 3."""
    b = _bytes(codes[:, 8 * kc:8 * kc + 8])  # [rows, 8, 4]
    rows = b.shape[0]
    tiles = np.zeros((rows // 16, 16, 32), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        regs = [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)]
        for reg, (row, word) in enumerate(regs):
            k0 = 4 * t + (16 if reg >= 2 else 0)
            tiles[:, row, k0:k0 + 4] = b.reshape(rows // 16, 16, 8, 4)[:, row, word]
    return tiles


def _b_tiles(packed, kc):
    """The mma-view B tiles [G, NT, 32, 8] of chunk kc of a packed slice:
    lane 4g + t's register 0 is column g, k 4t .. 4t + 3, register 1 column
    g, k 16 + 4t .. 16 + 4t + 3 (the m16n8k32 B layout)."""
    G, _, NT, _ = packed.shape
    b = _bytes(packed[:, kc]).reshape(G, NT, 8, 4, 2, 4)  # [G, n, g, t, r, i]
    return b.transpose(0, 1, 4, 3, 5, 2).reshape(G, NT, 32, 8)  # k = 16 r + 4 t + i


def _codes_buffer(a_q, KC):
    """The kernel's codes buffer of an operand: [64 rows, KC * 8] words,
    zero past its rows and columns."""
    buf = np.zeros((cgv._COOP_ROWS, KC * 32), np.int8)
    buf[:a_q.shape[0], :a_q.shape[1]] = a_q.numpy().astype(np.int8)
    return buf.view(np.int32)


@pytest.mark.parametrize("B", [1, 20])
def test_tile_sums_from_the_fragments_equal_qmm(B):
    """The encoder's product (binary x codes) and the frame head's (codes of
    h_d in 0 .. 127) as the kernel forms them: per block, song tile and n8
    tile, the 16 x 8 x 32 tile sums chunk after chunk in int64 from the
    fragments its lanes load (the warps split the chunks; int sums allow any
    order). Mapped back to units and pitches, each equals the integer
    product, and its dequantized value ``_qmm`` bit for bit."""
    D, H = 64, 320
    cfg = _cfg(D, H)
    w = cgv._pack_int8(_params(D, H, L, False, seed=1), cfg, torch.eye(K)[torch.arange(3) % K])
    nu, G = cgv.coop_grid(H, 132)
    hs, P = cgv.head_split(D, G, B)
    q = cgv.pack_coop(w, cfg, nu, G, P, hs)
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32))
    hd = torch.from_numpy(np.maximum(rng.standard_normal((B, H)), 0).astype(np.float32))
    rs = torch.clamp_min(hd.amax(1, keepdim=True), 1e-12) / 127.0
    h_q = torch.round(hd / rs)
    mt = -(-B // 16)
    # the encoder: every block's units, all song tiles
    words = _codes_buffer(torch.trunc(x), -(-D // 32))
    acc = np.zeros((cgv._COOP_ROWS // 16, G, nu // 8, 16, 8), np.int64)
    for kc in range(-(-D // 32)):
        acc += np.einsum("mrk,gnkc->mgnrc", _a_tiles(words, kc), _b_tiles(q["wke"], kc))
    got = acc.transpose(0, 3, 1, 2, 4).reshape(cgv._COOP_ROWS, G * nu)[:, :H]
    want = torch.trunc(x).numpy().astype(np.int64) @ w["wke"].numpy().astype(np.int64)
    np.testing.assert_array_equal(got[:B], want)
    assert not got[B:].any()
    assert torch.equal(torch.from_numpy(got[:B].astype(np.float32)) * w["ske"],
                       cgv._qmm(torch.trunc(x), w["wke"].double(), w["ske"]))
    # the frame head: each block's song group and pitch tiles
    words = _codes_buffer(h_q, -(-H // 32))
    head = np.zeros((cgv._COOP_ROWS, -(-D // 8) * 8), np.int64)
    mtg = -(-mt // hs)
    a_t = [_a_tiles(words, kc) for kc in range(-(-H // 32))]
    b_t = [_b_tiles(q["wx"], kc) for kc in range(-(-H // 32))]
    for blk in range(G):
        pg, sg = blk // hs, blk % hs
        tiles = range(sg * mtg, min(mt, (sg + 1) * mtg))
        for j in range(P):
            tile = pg * P + j
            if tile >= -(-D // 8):
                continue
            for m in tiles:
                s = np.zeros((16, 8), np.int64)
                for a, bt in zip(a_t, b_t):
                    s += a[m] @ bt[blk, j]
                head[16 * m:16 * m + 16, 8 * tile:8 * tile + 8] = s
    want = h_q.numpy().astype(np.int64) @ w["wx"].numpy().astype(np.int64)
    np.testing.assert_array_equal(head[:B, :D], want)
    assert torch.equal(torch.from_numpy(head[:B, :D].astype(np.float32)) * w["swx"],
                       cgv._qmm(h_q, w["wx"].double(), w["swx"]))


def _emulate(params, cfg, seeds, nsteps, eps, u, ws, use_z_prior, return_probs, n_sm=132):
    """The int8 kernel's step in plain torch on its layouts and its
    cross-block order: the weights read back from the packed slices; the z
    heads summed in double over each block's units in order, lane l adding
    the blocks l, l + 32, ... in order, a butterfly (xor 16, 8, 4, 2, 1)
    adding the lanes (lane 0's value), rounded to f32 once; h_d's largest
    value over each block's units, then over the blocks; the int32 products
    (exact in any order); the f32 operations in the JAX kernel's order."""
    D, H, L_ = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    B = seeds.shape[0]
    w = cgv._pack_int8(params, cfg, ws)
    plan = cgv.coop_plan(cfg, B, n_sm)
    nu, G = plan["nu"], plan["G"]
    q = cgv.pack_coop(w, cfg, nu, G, plan["P"], plan["hs"])
    i64 = lambda a: torch.from_numpy(a)
    wke = i64(_unpack_units(q["wke"], D, H, nu))
    wkd = i64(_unpack_units(q["wkd"], D, H, nu)) if cfg.use_x_prev else None
    wx = i64(_unpack_head(q["wx"], H, D, plan["hs"]))
    wz = w["wz_t"].double()  # [2L, H], bf16 values
    x_prev = x_lag = torch.trunc(seeds).long()
    outs = []
    for t in range(nsteps):
        if use_z_prior:
            z = eps[:, t]
        else:
            h_e = torch.relu((x_prev @ wke).float() * w["ske"] + w["encb"])
            h_e = h_e.bfloat16().double()
            part = torch.zeros(G, B, 2 * L_, dtype=torch.float64)
            for blk in range(G):
                for j in range(blk * nu, min(H, (blk + 1) * nu)):
                    part[blk] = part[blk] + h_e[:, j:j + 1] * wz[:, j]
            lanes = torch.zeros(32, B, 2 * L_, dtype=torch.float64)
            for blk in range(G):
                lanes[blk % 32] = lanes[blk % 32] + part[blk]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[torch.arange(32) ^ off]
            zmv = lanes[0].float()
            scale = torch.exp((zmv[:, L_:] + w["bz"][L_:]) / 2)
            z = (zmv[:, :L_] + w["bz"][:L_]) + scale * eps[:, t]
        z_d = w["decb"]
        for l in range(L_):
            z_d = z_d + z[:, l:l + 1] * w["wkd_z"][l]
        if cfg.use_x_prev:
            z_d = z_d + (x_lag @ wkd).float() * w["skd"]
        h_d = torch.relu(z_d)
        blk_max = torch.stack([h_d[:, blk * nu:(blk + 1) * nu].amax(1) for blk in range(G)])
        rs = torch.clamp_min(blk_max.amax(0), 1e-12)[:, None] / 127.0
        codes = torch.round(h_d / rs).long()
        xm = torch.sigmoid(((codes @ wx).float() * w["swx"]) * rs + w["bx"])
        x_t = (u[:, t] < xm).float()
        x_lag, x_prev = x_prev, x_t.long()
        outs.append(xm if return_probs else x_t)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("use_z_prior", [False, True])
@pytest.mark.parametrize("use_x_prev", [False, True])
def test_emulated_kernel_order_equals_plain_int8(use_x_prev, use_z_prior):
    """D=64, H=320 (40 blocks of 8 units), L=4, B=5 songs x 12 steps:
    probabilities with u = 1 within 1e-6 of ``_plain_int8``, and the frames
    drawn with seeded u equal."""
    D, H, L_, B, nsteps = 64, 320, 4, 5, 12
    cfg = _cfg(D, H, L_, use_x_prev)
    params = _params(D, H, L_, use_x_prev, seed=3)
    rng = np.random.default_rng(4)
    seeds = torch.from_numpy((rng.random((B, D)) < 0.2).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((B, nsteps, L_)).astype(np.float32))
    u = torch.from_numpy(rng.random((B, nsteps, D)).astype(np.float32))
    ws = torch.eye(K)[torch.arange(B) % K]
    run = lambda f, uu, rp: f(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior, rp)
    plain = lambda *a: cgv._plain_int8(*a)
    p_em, p_pl = run(_emulate, torch.ones_like(u), True), run(plain, torch.ones_like(u), True)
    torch.testing.assert_close(p_em, p_pl, rtol=0, atol=1e-6)
    f_em, f_pl = run(_emulate, u, False), run(plain, u, False)
    assert torch.equal(f_em, f_pl) and 0 < f_pl.mean().item() < 1


def test_residency_rule_across_the_band():
    """Every H that the JAX package samples in int8 at D=1,024, L=16 takes
    the int8 kernel on an H100's grid, with and without x_prev, for one song
    and for 64: its layout the first of (both resident, the x rows' slices
    resident, neither) that fits 227 KB; at H=5,120 without x_prev every
    slice stays resident for 64 songs."""
    band = [H for H in range(4000, 8200, 32) if cgv._jax_precision(_cfg(1024, H)) == "int8"]
    assert band[0] <= 4160 and band[-1] >= 7808
    for H in band:
        for use_x_prev in (False, True):
            cfg = _cfg(1024, H, use_x_prev=use_x_prev)
            assert cgv.pick_mode(cfg) == "int8", H
            assert cgv.kernel_for(cfg) == "generate_cl_vae_int8"
            for B in (1, 64):
                plan = cgv.coop_plan(cfg, B, 132)
                smem = lambda res: cgv._coop_smem(1024, H, L, plan["nu"], plan["P"], use_x_prev,
                                                  *res)
                assert smem(plan["res"]) <= cgv._SMEM_LIMIT
                order = [(True, True), (True, False), (False, False)]
                assert all(smem(r) > cgv._SMEM_LIMIT for r in order[:order.index(plan["res"])])
    assert cgv.coop_plan(_cfg(1024, 5120), 64, 132)["res"] == (True, True)
    # a config no layout fits is refused, not sampled another way
    huge = dataclasses.replace(_cfg(1024, 5120), latent_dim=600)
    with pytest.raises(ValueError, match="does not take"):
        cgv.coop_plan(huge, 64, 132)
