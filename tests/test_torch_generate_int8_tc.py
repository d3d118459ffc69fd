"""The int8 cl_vrnn generation kernel's layouts, on the CPU.

``csrc/generate_cl_vrnn.cu`` ``generate_int8_kernel`` runs only on the card;
what surrounds it is Python that these tests reach: the grid
(:func:`int8_grid`: which block owns which hidden units), the packing of each
block's weight slice in the order the ``mma.sync.m16n8k32`` B fragments load
it (:func:`pack_int8`), and the shared-memory rule (:func:`fits`). The
packed slices are unpacked here by an independent reading of the layout and
must give back ``_quant_cols``' codes; and the kernel's tile sums, emulated
in int64 from the fragments its lanes load (the PTX ISA's m16n8k32 layout),
must equal ``_qmm``: int sums are exact, so the emulation is bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

D, L, K = 88, 2, 13
BAND = (64, 1240, 1536, 1752)


def _cfg(H, use_x_prev=True):
    return tcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=2,
                      n_classes=K, use_x_prev=use_x_prev, bf16_compute=True,
                      lstm_backend="pallas")


def _codes(H, use_x_prev, seed=0):
    """``_pack``'s int8 operands of seeded glorot-scale weights."""
    rng = np.random.default_rng(seed)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    n_xp = D if use_x_prev else 0
    raw = {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "decoder_h": {"kernel": glorot(n_xp + L + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.zeros(D, np.float32)},
    }
    ws = torch.eye(K)[torch.arange(3) % K]
    cfg = _cfg(H, use_x_prev)
    return cfg, cg._pack(params_from_numpy(raw, "cpu"), cfg, ws, D, "int8")


def _bytes(words):
    """int32 words [..., n] -> their bytes [..., n, 4] as int64 (byte i of a
    word is the i-th in memory: little-endian)."""
    w = np.ascontiguousarray(words.numpy() if torch.is_tensor(words) else words)
    return w.view(np.int8).reshape(w.shape + (4,)).astype(np.int64)


def _unpack_cells(packed, K_, H, nu):
    """[G, KC, NT, 64] words -> the [K_, 4H] codes they hold, read from the
    layout as the kernel's lanes read it: word 2 lane + r of a tile chunk is
    register r of lane 4g + t, codes of k = 32 kc + 8t + 4r + i (byte i),
    column g of the tile: unit u0 + 2n + g // 4, gate g % 4. Every code past
    K_ or H must be 0."""
    G, KC, NT, _ = packed.shape
    b = _bytes(packed).reshape(G, KC, NT, 8, 4, 2, 4)  # [G, kc, n, g, t, r, i]
    gi, kc, n, g, t, r, i = np.indices(b.shape, sparse=True)
    k = 32 * kc + 8 * t + 4 * r + i
    unit = gi * nu + 2 * n + g // 4
    col = (g % 4) * H + unit
    inside = (k < K_) & (unit < H)
    out = np.zeros((K_, 4 * H), np.int64)
    kk, cc, vals = (np.broadcast_to(a, b.shape)[inside] for a in (k, col, b))
    out[kk, cc] = vals
    assert not b[~np.broadcast_to(inside, b.shape)].any(), "padding holds nonzero codes"
    hits = np.zeros((K_, 4 * H), np.int64)
    np.add.at(hits, (kk, cc), 1)
    assert (hits == 1).all(), "a code is packed twice or not at all"
    return out


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("H", [64, 262, 1240, 1536, 1752])
def test_every_unit_is_owned_once_with_its_four_gates(H, n_sm):
    """``int8_grid``: nu even, at most 16, at most n_sm blocks, each hidden
    unit in exactly one block; the packing puts all four gate columns of a
    unit in its owner's slice (a weight whose column c holds c + 1, read
    back block by block)."""
    nu, G = cg.int8_grid(H, n_sm)
    assert nu % 2 == 0 and nu <= cg._I8_MAX_UNITS and G <= n_sm
    owner = np.arange(H) // nu
    assert G == owner.max() + 1 and np.bincount(owner, minlength=G).max() <= nu
    # column ids as codes: 4H distinct values need more than int8, so pack
    # each byte of the id separately and join them
    ids = torch.arange(4 * H, dtype=torch.int64) + 1
    cols = np.zeros((G, nu, 4), np.int64)
    for shift in (0, 8):
        q = ((ids >> shift) & 0xFF).to(torch.uint8).view(torch.int8).expand(1, -1).contiguous()
        b = _bytes(cg._pack_cells(q, H, nu)).reshape(G, 1, nu // 2, 8, 4, 2, 4)
        byte = b[:, 0, :, :, 0, 0, 0] & 0xFF  # k = 0: lane 4g, register 0, byte 0
        cols += byte.reshape(G, nu // 2, 2, 4).reshape(G, nu, 4) << shift
    for blk in range(G):
        for j in range(nu):
            u = blk * nu + j
            want = [g * H + u + 1 for g in range(4)] if u < H else [0] * 4
            assert cols[blk, j].tolist() == want, (blk, j)


@pytest.mark.parametrize("use_x_prev", [True, False])
@pytest.mark.parametrize("H", BAND)
def test_packed_slices_unpack_to_the_quantized_codes(H, use_x_prev):
    """Each cell's packed slices (x rows, then the recurrent kernel, chunk
    after chunk) and the frame head give back ``_quant_cols``' codes, with
    zeros wherever K, H or D is padded."""
    cfg, w = _codes(H, use_x_prev)
    nu = cg.int8_grid(H, cg._H100_SMS)[0]
    q = cg.pack_int8(w, cfg, nu)
    kcx, kch = -(-D // 32), -(-H // 32)
    assert q["enc"].shape == (-(-H // nu), kcx + kch, nu // 2, 64)
    assert q["dec"].shape[1] == (kcx if use_x_prev else 0) + kch
    as64 = lambda t: t.numpy().astype(np.int64)
    np.testing.assert_array_equal(_unpack_cells(q["enc"][:, :kcx], D, H, nu), as64(w["wke_x"]))
    np.testing.assert_array_equal(_unpack_cells(q["enc"][:, kcx:], H, H, nu), as64(w["rke"]))
    dec_h = q["dec"][:, kcx:] if use_x_prev else q["dec"]
    np.testing.assert_array_equal(_unpack_cells(dec_h, H, H, nu), as64(w["rkd"]))
    if use_x_prev:
        np.testing.assert_array_equal(_unpack_cells(q["dec"][:, :kcx], D, H, nu),
                                      as64(w["wkd_x"]))
    # the frame head: [NTx, KC, 64], column g of tile n is pitch 8n + g
    head = _bytes(q["head"]).reshape(-(-D // 8), kch, 8, 4, 2, 4)  # [n, kc, g, t, r, i]
    n, kc, g, t, r, i = np.indices(head.shape, sparse=True)
    k, d = 32 * kc + 8 * t + 4 * r + i, 8 * n + g
    inside = np.broadcast_to((k < H) & (d < D), head.shape)
    got = np.zeros((H, D), np.int64)
    got[np.broadcast_to(k, head.shape)[inside], np.broadcast_to(d, head.shape)[inside]] = \
        head[inside]
    np.testing.assert_array_equal(got, as64(w["wx_t"]).T)
    assert not head[~inside].any()


def _a_tiles(codes, kc):
    """The mma-view A tiles [Bp / 16, 16, 32] of chunk kc of a codes buffer
    [Bp, KC * 8] words, from the registers the kernel's lanes load: lane
    4g + t takes words 2t and 2t + 1 of rows g and g + 8 as a0 = (g, 2t), a1
    = (g + 8, 2t), a2 = (g, 2t + 1), a3 = (g + 8, 2t + 1); the m16n8k32 A
    layout reads a0 as row g, k 4t .. 4t + 3, a1 as row g + 8, the same k,
    a2 and a3 as k 16 + 4t .. 16 + 4t + 3."""
    b = _bytes(codes[:, 8 * kc:8 * kc + 8])  # [Bp, 8, 4]
    Bp = b.shape[0]
    tiles = np.zeros((Bp // 16, 16, 32), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        regs = [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)]
        for reg, (row, word) in enumerate(regs):
            k0 = 4 * t + (16 if reg >= 2 else 0)
            tiles[:, row, k0:k0 + 4] = b.reshape(Bp // 16, 16, 8, 4)[:, row, word]
    return tiles


def _b_tiles(packed, kc):
    """The mma-view B tiles [G, NT, 32, 8] of chunk kc of a packed slice:
    lane 4g + t's register 0 is column g, k 4t .. 4t + 3, register 1 column
    g, k 16 + 4t .. 16 + 4t + 3 (the m16n8k32 B layout)."""
    G, _, NT, _ = packed.shape
    b = _bytes(packed[:, kc]).reshape(G, NT, 8, 4, 2, 4)  # [G, n, g, t, r, i]
    return b.transpose(0, 1, 4, 3, 5, 2).reshape(G, NT, 32, 8)  # k = 16 r + 4 t + i


@pytest.mark.parametrize("B", [1, 20])
@pytest.mark.parametrize("H", [64, 1536])
def test_tile_sums_in_block_order_equal_qmm(H, B):
    """The encoder's two products as the kernel forms them: for each block,
    song tile and n8 tile, the 16 x 8 x 32 tile sums chunk after chunk, in
    int64, from the fragments its lanes load (x codes binary, h codes
    round(h * 127)); the kernel's warps split the chunks and add their
    partial sums, which int sums allow in any order. Mapped back to the gate
    columns, each product equals the integer product, and its dequantized
    value ``_qmm`` bit for bit."""
    cfg, w = _codes(H, True, seed=1)
    nu = cg.int8_grid(H, cg._H100_SMS)[0]
    q = cg.pack_int8(w, cfg, nu)
    G, _, NT, _ = q["enc"].shape
    rng = np.random.default_rng(2)
    x = (rng.random((B, D)) < 0.3).astype(np.float32)
    h = np.tanh(rng.standard_normal((B, H))).astype(np.float32)
    h_q = torch.round(torch.from_numpy(h) * 127.0)
    Bp = -(-B // 16) * 16
    kcx = -(-D // 32)
    for a_q, weight, scale, chunks in (
            (torch.trunc(torch.from_numpy(x)), w["wke_x"], w["swke_x"], range(kcx)),
            (h_q, w["rke"], w["srke"], range(kcx, q["enc"].shape[1]))):
        KC = len(chunks)
        buf = np.zeros((Bp, KC * 32), np.int8)  # the kernel's codes buffer, zero rows past B
        buf[:B, :a_q.shape[1]] = a_q.numpy().astype(np.int8)
        words = buf.view(np.int32)
        acc = np.zeros((Bp // 16, G, NT, 16, 8), np.int64)
        for j, kc in enumerate(chunks):  # the kernel's chunk order
            A, Bt = _a_tiles(words, j), _b_tiles(q["enc"], kc)
            acc += np.einsum("mrk,gnkc->mgnrc", A, Bt)
        # tile column c of block g, tile n: unit g nu + 2n + c // 4, gate c % 4
        got = np.zeros((Bp, 4 * H), np.int64)
        for blk in range(G):
            for n in range(NT):
                for c in range(8):
                    u = blk * nu + 2 * n + c // 4
                    if u < H:
                        got[:, (c % 4) * H + u] = acc[:, blk, n, :, c].reshape(Bp)
        want = a_q.numpy().astype(np.int64) @ weight.numpy().astype(np.int64)
        np.testing.assert_array_equal(got[:B], want)
        assert not got[B:].any()
        deq = torch.from_numpy(got[:B].astype(np.float32)) * scale
        ref = cg._qmm(a_q, weight.double(), scale)
        assert torch.equal(deq, ref)


def test_fits_every_width_of_the_band():
    """Every H that the JAX package samples in int8 at D=88, L=2 fits the
    kernel on an H100's grid (at most 16 units a block, the shared memory of
    a 256-song launch), so no checkpoint of the band is refused; forced
    int8 takes H up to 16 units x 132 blocks = 2,112."""
    band = [H for H in range(1000, 2000, 8) if cg._jax_precision(_cfg(H)) == "int8"]
    assert band[0] <= 1240 and band[-1] >= 1752
    for H in band:
        cfg = _cfg(H)
        assert cg.pick_mode(cfg) == "int8" and cg.fits(cfg) and cg.fits(cfg, "int8"), H
        assert cg.smem_bytes(cfg) == cg._int8_smem(cg.int8_grid(H, 132)[0], cg._I8_MAX_SONGS, L)
        assert cg.smem_bytes(cfg) <= cg._SMEM_LIMIT
    wide = dataclasses.replace(_cfg(1536), intermediate_dim=2112)
    assert cg.fits(wide, "int8") and not cg.fits(dataclasses.replace(wide, intermediate_dim=2114),
                                                 "int8")
