"""The cooperative cl_vae generation kernel in f32 and bf16: layouts, sum
order and routing, on the CPU.

``csrc/generate_cl_vae.cu`` ``generate_vae_coop_kernel`` takes the configs
with hidden layers whose weights a cluster's shared memory does not hold
(``kernel_for``),
in f32 (FFMA) and bf16 (``mma.sync.m16n8k16`` on the tensor cores), with the
int8 kernel's grid (:func:`coop_grid`), frame-head split
(:func:`head_split`) and packing (:func:`pack_coop`: a tile's chunk holds
its 8 columns one after the other, each column's 32 bytes of k in order).
It runs only on the card; what surrounds it is Python that these tests
reach. The packed slices are unpacked here by an independent reading of the
layout (the lanes' loads) and must give back ``_pack``'s bf16 and f32
operands; the bf16 tile sums built from the fragments the lanes load (the
PTX ISA's m16n8k16 layout) must equal an f32 product of the same bf16
values summed chunk by chunk in the kernel's order, and the f32 FFMA tiles
likewise; a plain-torch emulation of a step's cross-block order (the z
heads summed over each block's units in double, the blocks' sums added lane
by lane and by a butterfly, rounded to f32 once) must match
``generate_cl_vae_batch_plain``: probabilities with u = 1 within 1e-5 in
f32 (the bound of ``chip_smoke.py`` phase 17) and, in bf16, within that
phase's max 2e-2 / mean 2e-3. No generation runs here at the wide widths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

K = 13


def _cfg(D, H, L, use_x_prev=False, bf16=True):
    return tvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                       intermediate_class_dim=32, n_classes=K, use_x_prev=use_x_prev,
                       bf16_compute=bf16)


def _params(D, H, L, use_x_prev, seed=0):
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
           "z_mean": {"kernel": glorot(H, L), "bias": zeros(L)},
           "z_log_var": {"kernel": glorot(H, L), "bias": zeros(L)},
           "decoder_h": {"kernel": glorot(K + n_xp + L, H),
                         "bias": rng.normal(0, 0.1, H).astype(np.float32)},
           "x_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -2.0, np.float32)}}
    return params_from_numpy(raw, "cpu")


def _values(words, mode):
    """int32 words [..., n] -> the bf16 or f32 values they hold, as float64
    [..., n * per word] (little-endian: element i of a word is the i-th in
    memory)."""
    w = words.contiguous()
    v = w.view(torch.bfloat16) if mode == "bf16" else w.view(torch.float32)
    return v.double()


def _unpack_units(packed, K_, H, nu, mode):
    """[G, KC, NT, 64] words -> the [K_, H] weight they hold, read as the
    kernel's lanes read them. bf16: lane 4g + t's two words of a tile's
    chunk (words 2 lane, 2 lane + 1) hold k = 16 kc + 4t .. 4t + 3 of column
    g; f32: lane (g, t) reads columns 2t and 2t + 1, eight k each (words
    16t .. 16t + 15), so column c of the tile is words 8c .. 8c + 7 and k =
    8 kc + i. Column g of tile n of block b is unit b nu + 8n + g. Every value
    past K_ or H is 0 and every value is packed once."""
    G, KC, NT, _ = packed.shape
    vals = _values(packed, mode).numpy()  # [G, KC, NT, 64 * per word]
    if mode == "bf16":  # [blk, kc, n, g, t, i]: column g, k 16 kc + 4t + i
        v = vals.reshape(G, KC, NT, 8, 4, 4)
        blk, kc, n, g, t, i = np.indices(v.shape, sparse=True)
        k, col = 16 * kc + 4 * t + i, g
    else:  # [blk, kc, n, t, e, i]: column 2t + e, k 8 kc + i
        v = vals.reshape(G, KC, NT, 4, 2, 8)
        blk, kc, n, t, e, i = np.indices(v.shape, sparse=True)
        k, col = 8 * kc + i, 2 * t + e
    unit = blk * nu + 8 * n + col
    inside = np.broadcast_to((k < K_) & (unit < H), v.shape)
    assert not v[~inside].any(), "padding holds a nonzero value"
    kk, uu = np.broadcast_to(k, v.shape)[inside], np.broadcast_to(unit, v.shape)[inside]
    out = np.zeros((K_, H))
    out[kk, uu] = v[inside]
    hits = np.zeros((K_, H), np.int64)
    np.add.at(hits, (kk, uu), 1)
    assert (hits == 1).all(), "a value is packed twice or not at all"
    return torch.from_numpy(out)


def _unpack_head(packed, H, D, hs, mode):
    """[G, KC, P, 64] words -> the [H, D] frame head, per song group: slot j
    of block b is pitch tile P (b // hs) + j; within each song group every
    pitch is owned by exactly one block."""
    G, KC, P, _ = packed.shape
    got = []
    for sg in range(hs):
        mine = [b for b in range(G) if b % hs == sg]
        # block b's slots j hold pitch tile P (b // hs) + j: as units of a
        # [H, tiles] weight whose "block" b // hs owns P tiles (nu = 8 P)
        sub = packed[mine]
        full = _unpack_units(sub, H, len(mine) * 8 * P, 8 * P, mode)
        assert not full[:, D:].any()
        got.append(full[:, :D])
    for other in got[1:]:
        torch.testing.assert_close(other, got[0], rtol=0, atol=0)
    return got[0]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("H", [256, 512, 1024, 5120])
def test_every_unit_and_pitch_is_owned_once(H, n_sm):
    """The f32 / bf16 launches take the int8 kernel's grid and frame-head
    split: each unit in one block (a weight whose column u holds u, read back
    block by block from the packed bf16 and f32 slices), and for 1, 17 and 64
    songs each pitch tile in one block of each song group, the song groups
    covering the m16 tiles once."""
    D = 1024 if H >= 1024 else 88
    nu, G = cgv.coop_grid(H, n_sm)
    assert nu % 8 == 0 and G <= n_sm and G == -(-H // nu) and (G - 1) * nu < H
    ids = torch.arange(H, dtype=torch.float32)[None]  # exact in bf16 below 256 only: f32
    cols = _values(cgv.pack_units(ids.contiguous(), nu), "f32")  # [G, 1, NT, 64]
    for blk in range(G):
        for n in range(nu // 8):
            u = blk * nu + 8 * n + np.arange(8)
            np.testing.assert_array_equal(cols[blk, 0, n].view(8, 8)[:, 0].numpy(),
                                          np.where(u < H, u, 0))
    for B in (1, 17, 64):
        hs, P = cgv.head_split(D, G, B)
        assert hs == (2 if B > 16 else 1)
        assert -(-(-(-D // 8)) // P) * hs <= G
        mt = -(-B // 16)
        mtg = -(-mt // hs)
        runs = [range(sg * mtg, min(mt, (sg + 1) * mtg)) for sg in range(hs)]
        assert sorted(m for r in runs for m in r) == list(range(mt))


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("D,H,use_x_prev", [(88, 256, True), (40, 72, False)])
def test_packed_slices_unpack_to_the_operands(D, H, use_x_prev, mode):
    """Each block's units of the encoder's and the decoder's x rows and its
    pitch tiles of the frame head give back ``_pack``'s operands in the
    mode's type, zero wherever D, H or K is padded, for both head splits."""
    cfg = _cfg(D, H, 4, use_x_prev, bf16=mode == "bf16")
    w = cgv._pack(_params(D, H, 4, use_x_prev), cfg, torch.eye(K)[:3], mode)
    nu, G = cgv.coop_grid(H, 132)
    per = 32 // (2 if mode == "bf16" else 4)
    for B in (1, 64):
        hs, P = cgv.head_split(D, G, B)
        q = cgv.pack_coop(w, cfg, nu, G, P, hs)
        assert q["wke"].shape == (G, -(-D // per), nu // 8, 64)
        assert q["wx"].shape == (G, -(-H // per), P, 64)
        torch.testing.assert_close(_unpack_units(q["wke"], D, H, nu, mode), w["wke"].double(),
                                   rtol=0, atol=0)
        if use_x_prev:
            torch.testing.assert_close(_unpack_units(q["wkd"], D, H, nu, mode),
                                       w["wkd_x"].double(), rtol=0, atol=0)
        else:
            assert q["wkd"] is None
        torch.testing.assert_close(_unpack_head(q["wx"], H, D, hs, mode), w["wx"].double(),
                                   rtol=0, atol=0)


def _operand_buffer(a, mode):
    """The kernel's operand buffer of a [rows, K] operand: 64 rows of KC *
    8 words, zero past its rows and columns."""
    per = 32 // (2 if mode == "bf16" else 4)
    kc = -(-a.shape[1] // per)
    buf = torch.zeros(cgv._COOP_ROWS, kc * per,
                      dtype=torch.bfloat16 if mode == "bf16" else torch.float32)
    buf[:a.shape[0], :a.shape[1]] = a
    return buf.view(torch.int32)


def _bf16_tile_sums(abuf, packed, kc_count):
    """The tile sums of the bf16 product from the registers the lanes load,
    [64 / 16, G, NT, 16, 8]: lane 4g + t loads bytes 8t .. 8t + 7 of rows g
    and g + 8 of a chunk as a0 = (g, lo.x), a1 = (g + 8, hi.x), a2 = (g,
    lo.y), a3 = (g + 8, hi.y), and of column g of each tile as b0, b1. The
    m16n8k16 layout reads a0 as row g, k 2t, 2t + 1, a1 row g + 8, a2 and a3
    k 2t + 8, 2t + 9; b0 as k 2t, 2t + 1 of column g, b1 k 2t + 8, 2t + 9.
    Each chunk's 16-k product is summed in float64 (exact for bf16
    products) and rounded to f32, the chunks added in order in f32."""
    av = _values(abuf, "bf16")  # [64, KC * 16]
    bv = _values(packed, "bf16")  # [G, KC, NT, 128]
    G, _, NT, _ = packed.shape
    acc = torch.zeros(4, G, NT, 16, 8, dtype=torch.float32)
    for kc in range(kc_count):
        A = torch.zeros(4, 16, 16, dtype=torch.float64)
        Bm = torch.zeros(G, NT, 16, 8, dtype=torch.float64)
        chunk = av[:, 16 * kc:16 * kc + 16].reshape(4, 16, 16)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            lo, hi = chunk[:, g, 4 * t:4 * t + 4], chunk[:, g + 8, 4 * t:4 * t + 4]
            A[:, g, 2 * t:2 * t + 2], A[:, g + 8, 2 * t:2 * t + 2] = lo[:, :2], hi[:, :2]
            A[:, g, 2 * t + 8:2 * t + 10], A[:, g + 8, 2 * t + 8:2 * t + 10] = lo[:, 2:], hi[:, 2:]
            b = bv[:, kc, :, 4 * lane:4 * lane + 4]  # [G, NT, 4]
            Bm[:, :, 2 * t:2 * t + 2, g], Bm[:, :, 2 * t + 8:2 * t + 10, g] = b[..., :2], b[..., 2:]
        acc = acc + torch.einsum("mrk,gnkc->mgnrc", A, Bm).float()
    return acc


def _f32_tile_sums(abuf, packed, kc_count):
    """The f32 FFMA tiles from the values each lane reads: lane (g, t) rows
    g and g + 8 of a chunk (8 k), columns 2t and 2t + 1 of each tile (words
    16t .. 16t + 15), summed over k in order in f32, chunk after chunk."""
    av = _values(abuf, "f32").float()  # [64, KC * 8]
    bv = _values(packed, "f32").float()  # [G, KC, NT, 64]
    G, _, NT, _ = packed.shape
    acc = torch.zeros(4, G, NT, 16, 8)
    for kc in range(kc_count):
        a = av[:, 8 * kc:8 * kc + 8].reshape(4, 16, 8)
        for t in range(4):
            cols = bv[:, kc, :, 16 * t:16 * t + 16].reshape(G, NT, 2, 8)  # [.., col 2t + e, k]
            for k in range(8):
                prod = a[:, None, None, :, k, None] * cols[None, :, :, None, :, k]
                acc[..., 2 * t:2 * t + 2] = acc[..., 2 * t:2 * t + 2] + prod
    return acc


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_tile_sums_from_the_lanes_equal_the_product(mode):
    """The encoder's product (binary x) and the frame head's (h_d >= 0) as
    the kernel forms them, per block, song tile and n8 tile: mapped back to
    units and pitches, each equals an f32 product of the same operand values
    (bf16-rounded in bf16) within 1e-6 of its scale; only the order of the
    f32 sums differs."""
    D, H, B = 88, 256, 20
    cfg = _cfg(D, H, 4, bf16=mode == "bf16")
    w = cgv._pack(_params(D, H, 4, False, seed=1), cfg, torch.eye(K)[:3], mode)
    nu, G = cgv.coop_grid(H, 132)
    hs, P = cgv.head_split(D, G, B)
    q = cgv.pack_coop(w, cfg, nu, G, P, hs)
    rng = np.random.default_rng(2)
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    x = torch.from_numpy((rng.random((B, D)) < 0.3).astype(np.float32))
    hd = op(torch.from_numpy(np.maximum(rng.standard_normal((B, H)), 0).astype(np.float32)))
    sums = _bf16_tile_sums if mode == "bf16" else _f32_tile_sums
    per = 16 if mode == "bf16" else 8
    # the encoder: every block's units, all song tiles
    acc = sums(_operand_buffer(op(x), mode), q["wke"], -(-D // per))
    got = acc.permute(0, 3, 1, 2, 4).reshape(64, G * nu)[:B, :H]
    want = (op(x).double() @ w["wke"].double()).float()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())
    # the frame head: each block's song group and pitch tiles
    acc = sums(_operand_buffer(hd, mode), q["wx"], -(-H // per))  # [4, G, P, 16, 8]
    mt, ntx = -(-B // 16), -(-D // 8)
    mtg = -(-mt // hs)
    head = torch.zeros(64, ntx * 8)
    for blk in range(G):
        pg, sg = blk // hs, blk % hs
        for j in range(P):
            tile = pg * P + j
            for m in range(sg * mtg, min(mt, (sg + 1) * mtg)):
                if tile < ntx:
                    head[16 * m:16 * m + 16, 8 * tile:8 * tile + 8] = acc[m, blk, j]
    want = (hd.double() @ w["wx"].double()).float()
    torch.testing.assert_close(head[:B, :D], want, rtol=0, atol=1e-6 * want.abs().max().item())


def _emulate(params, cfg, seeds, nsteps, eps, u, ws, use_z_prior, return_probs, mode,
             n_sm=132):
    """The cooperative kernel's step in plain torch on its packed layouts and
    its cross-block order: the weights read back from the packed slices; the
    z heads summed in double over each block's units in order, lane l adding
    the blocks l, l + 32, ... in order, a butterfly (xor 16, 8, 4, 2, 1)
    adding the lanes (lane 0's value), rounded to f32 once; h_e, h_d and the
    frames rounded as operands of the mode; the decoder's f32 terms in the
    plain version's order."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    B = seeds.shape[0]
    w = cgv._pack(params, cfg, ws, mode)
    plan = cgv.coop_plan(cfg, B, n_sm, mode)
    nu, G = plan["nu"], plan["G"]
    q = cgv.pack_coop(w, cfg, nu, G, plan["P"], plan["hs"])
    wke = _unpack_units(q["wke"], D, H, nu, mode).float()
    wkd = _unpack_units(q["wkd"], D, H, nu, mode).float() if cfg.use_x_prev else None
    wx = _unpack_head(q["wx"], H, D, plan["hs"], mode).float()
    wz = w["wz_t"].double()
    op = (lambda a: a.bfloat16().float()) if mode == "bf16" else (lambda a: a)
    x_prev = x_lag = op(seeds)
    outs = []
    for t in range(nsteps):
        if use_z_prior:
            z = eps[:, t]
        else:
            h_e = op(torch.relu(x_prev @ wke + w["encb"])).double()
            part = torch.zeros(G, B, 2 * L, dtype=torch.float64)
            for blk in range(G):
                for j in range(blk * nu, min(H, (blk + 1) * nu)):
                    part[blk] = part[blk] + h_e[:, j:j + 1] * wz[:, j]
            lanes = torch.zeros(32, B, 2 * L, dtype=torch.float64)
            for blk in range(G):
                lanes[blk % 32] = lanes[blk % 32] + part[blk]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[torch.arange(32) ^ off]
            zmv = lanes[0].float()
            z = (zmv[:, :L] + w["bz"][:L]) + torch.exp((zmv[:, L:] + w["bz"][L:]) / 2) * eps[:, t]
        z_d = w["decb"]
        for l in range(L):
            z_d = z_d + z[:, l:l + 1] * w["wkd_z"][l]
        if cfg.use_x_prev:
            z_d = z_d + x_lag @ wkd
        h_d = op(torch.relu(z_d))
        xm = 1 / (1 + torch.exp(-(h_d @ wx + w["bx"])))
        x_t = (u[:, t] < xm).float()
        x_lag, x_prev = x_prev, x_t
        outs.append(xm if return_probs else x_t)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("use_z_prior", [False, True])
@pytest.mark.parametrize("mode,D,H,use_x_prev", [("f32", 88, 256, True), ("bf16", 88, 512, True),
                                                 ("bf16", 64, 320, False)])
def test_emulated_kernel_order_matches_the_plain_version(mode, D, H, use_x_prev, use_z_prior):
    """5 songs x 6 steps, L=4: probabilities with u = 1 within 1e-5 of
    ``generate_cl_vae_batch_plain`` in f32, within max 2e-2 / mean 2e-3 in
    bf16 (phase 17's bounds: the same rounding points, f32 sums in another
    order), and the frames drawn with seeded u equal in f32."""
    L, B, nsteps = 4, 5, 6
    cfg = _cfg(D, H, L, use_x_prev, bf16=mode == "bf16")
    params = _params(D, H, L, use_x_prev, seed=3)
    rng = np.random.default_rng(4)
    seeds = torch.from_numpy((rng.random((B, D)) < 0.2).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((B, nsteps, L)).astype(np.float32))
    u = torch.from_numpy(rng.random((B, nsteps, D)).astype(np.float32))
    ws = torch.eye(K)[torch.arange(B) % K]
    em = lambda uu, rp: _emulate(params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior, rp, mode)
    pl = lambda uu, rp: cgv.generate_cl_vae_batch_plain(params, cfg, seeds, nsteps, eps, uu, ws,
                                                        use_z_prior, rp, mode=mode)
    d = (em(torch.ones_like(u), True) - pl(torch.ones_like(u), True)).abs()
    if mode == "f32":
        assert d.max() <= 1e-5, d.max()
        f_em, f_pl = em(u, False), pl(u, False)
        assert torch.equal(f_em, f_pl) and 0 < f_pl.mean().item() < 1
    else:
        assert d.max() <= 2e-2 and d.mean() <= 2e-3, (d.max(), d.mean())


def test_routing_rule():
    """``kernel_for``: int8 configs take the cooperative kernel on int8
    codes; f32 / bf16 configs take the cluster kernel wherever its weights
    fit 8 blocks (:func:`cluster_plan`), with or without hidden layers, and
    the other configs with hidden layers the cooperative kernel. Every f32 /
    bf16 config with hidden layers the cooperative kernel takes has a layout
    on an H100's grid, for 1 and 64 songs, at the widths the port samples
    (D=88 and the seq-concat D=1,024, with and without x_prev)."""
    for D, H, mode in ((88, 256, "f32"), (88, 512, "f32"), (88, 1024, "f32"), (88, 512, "bf16"),
                       (88, 1024, "bf16"), (1024, 1024, "bf16"), (1024, 5120, "bf16"),
                       (1024, 5120, "f32"), (1024, 7808, "bf16"), (88, 2048, "f32"),
                       (88, 4096, "bf16")):
        for use_x_prev in (False, True):
            cfg = _cfg(D, H, 16 if D == 1024 else 4, use_x_prev, bf16=mode == "bf16")
            assert cgv.pick_mode(cfg) == mode
            if cgv.fits(cfg):  # the weights fit a cluster's shared memory
                assert cgv.kernel_for(cfg) == "generate_cl_vae_cluster", (D, H, mode)
                assert D == 88 and H <= 2048
                continue
            assert cgv.kernel_for(cfg) == "generate_cl_vae_coop", (D, H, mode)
            for B in (1, 64):
                plan = cgv.coop_plan(cfg, B, 132, mode)
                eb = 2 if mode == "bf16" else 4
                assert cgv._coop_smem(D, H, cfg.latent_dim, plan["nu"], plan["P"], use_x_prev,
                                      *plan["res"], eb) <= cgv._SMEM_LIMIT
    # the seq-concat H=5,120 checkpoint: the x rows' slices resident in bf16
    # for 64 songs without x_prev, the head's tiles streamed
    assert cgv.coop_plan(_cfg(1024, 5120, 16), 64, 132, "bf16")["res"] == (True, False)
    assert cgv.coop_plan(_cfg(1024, 5120, 16, True), 64, 132, "bf16")["res"] == (False, False)
    narrow = _cfg(88, 88, 4, True, bf16=False)  # jsball_vae's width
    assert cgv.kernel_for(narrow) == "generate_cl_vae_cluster"
    assert cgv.kernel_for(dataclasses.replace(narrow, intermediate_dim=0)) == \
        "generate_cl_vae_cluster"
    int8 = dataclasses.replace(_cfg(1024, 5120, 16), gen_backend="pallas")
    assert cgv.pick_mode(int8) == "int8" and cgv.kernel_for(int8) == "generate_cl_vae_int8"


@pytest.mark.parametrize("D,H,use_x_prev,mode,L_max", [
    (1024, 5120, False, "bf16", 105), (1024, 5120, True, "f32", 105),
    (88, 512, True, "f32", 366), (1024, 7808, True, "bf16", 52)])
def test_coop_latent_width_limit(D, H, use_x_prev, mode, L_max):
    """The latent width past which the cooperative kernel's streamed layout
    does not fit one block (the z heads' columns in double, the decoder's z
    rows and the songs' z stay in shared memory), as ``kernel_for``'s
    docstring states it: ``coop_plan`` takes L_max for 1 and 64 songs on an
    H100's 132 SMs, and raises at L_max + 1, before any launch (the wrapper
    plans every launch of a call first)."""
    for B in (1, 64):
        cfg = _cfg(D, H, L_max, use_x_prev, bf16=mode == "bf16")
        assert cgv.kernel_for(cfg) == "generate_cl_vae_coop"
        assert cgv.coop_plan(cfg, B, 132, mode)["res"] == (False, False)
        with pytest.raises(ValueError, match="does not take"):
            cgv.coop_plan(dataclasses.replace(cfg, latent_dim=L_max + 1), B, 132, mode)
