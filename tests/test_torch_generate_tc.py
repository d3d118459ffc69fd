"""The redesigned f32 / bf16 cl_vrnn generation kernel's layouts and order,
on the CPU.

``csrc/generate_cl_vrnn.cu`` ``generate_kernel`` runs only on the card;
what surrounds it is Python that these tests reach: the grid (``int8_grid``,
shared with the int8 kernel: which block owns which hidden units, all four
gates of each), the packing of each block's weight slices (``pack_slices``:
column by column in f32, in the order of the ``mma.sync.m16n8k16`` B fragments in
bf16; ``pack_head``), and the shared-memory rule (``gen_smem``,
``resident_bytes``, ``fits``). The packed slices are unpacked here by an
independent reading of the layout and must give back ``_pack``'s weights.
``_emulated`` is the kernel's step in torch on the packed operands, in its
order: per block the slice's columns; bf16 sums split over the warps of a
16-song tile by the k16 chunks of each ring stage and added in warp order,
f32 sums split over lanes by 4-k group; the z heads on h (bf16 in the bf16 mode) with z kept
f32 and entering the decoder as L rank-1 terms; the frame head's k16 chunks
split over 16 warps. It is held against ``generate_cl_vrnn_batch_plain`` and
the JAX package's ``generate_cl_vrnn_batch_pallas`` (interpret mode).

Tolerances: f32 probabilities rtol 1e-5 / atol 1e-6 and frames equal (the
same f32 products summed in another order); bf16 probabilities with u = 1
(every fed-back frame 0, so feedback cannot amplify a difference) within
atol 2e-3, as ``tests/test_torch_generate.py`` holds the plain version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.ops import pallas_generate
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.ops.lstm import _gates, bf16_operand
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

WIDTHS = (8, 40, 256, 512, 1024, 1536, 2048, 2300)


def _setup(B=8, Tseed=5, nsteps=9, H=40, D=12, L=3, K=3, use_x_prev=True, seed=0,
           bf16=False):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=4,
                      n_classes=K, use_x_prev=use_x_prev, bf16_compute=bf16)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    total = Tseed + nsteps
    a = {"seeds": (rng.random((B, Tseed, D)) < 0.3).astype(np.float32),
         "eps": rng.standard_normal((B, total, L)).astype(np.float32),
         "u": rng.random((B, total, D)).astype(np.float32),
         "ws": np.eye(K, dtype=np.float32)[np.arange(B) % K]}
    return jcfg, params, tcl.Config(**dataclasses.asdict(jcfg)), a, nsteps


def _unslice(sl, bf16):
    """A cell's packed slices [G, ...] -> [K, G, 4 nu], read from the
    layout's definition: f32 column by column; bf16 lane 4g + t of chunk
    kc, tile n holds column 8n + g at k = 16 kc + 4t + i."""
    if not bf16:
        return sl.permute(2, 0, 1)
    G, KC, NT = sl.shape[:3]
    out = torch.zeros((KC * 16, G, 8 * NT), dtype=sl.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            out[t * 4 + i::16][:, :, g::8] = sl[:, :, :, lane, i].permute(1, 0, 2)
    return out


def _emulated(params, cfg, seeds, nsteps, eps, u, ws, mode, return_probs, n_sm=132):
    """The kernel's function on ``pack_slices`` / ``pack_head``'s operands,
    in its order (module note)."""
    bf16 = mode == "bf16"
    B, Tseed, D = seeds.shape
    H, L = cfg.intermediate_dim, cfg.latent_dim
    w = cg._pack(params, cfg, ws, D, mode)
    nu = cg.gen_grid(H, n_sm)[0]  # a unit group's units (a block's, where it owns one)
    cols = cg._slice_cols(H, nu)                       # [G, 4 nu]
    keep = (cols < 4 * H).reshape(-1)
    Kx, Kh, Bp = cg.round16(D), cg.round16(H), cg.round16(B)
    rnd = bf16_operand if bf16 else (lambda a: a)

    def cell_w(w_x, rk):
        sl = _unslice(cg.pack_slices(w_x, rk, H, nu, D, bf16), bf16).float()
        return sl.reshape(sl.shape[0], -1)            # [K, G * 4 nu]: the blocks' columns

    enc_w, dec_w = cell_w(w["wke_x"], w["rke"]), cell_w(w["wkd_x"], w["rkd"])

    def products(a, wk):  # [Bp, K] x [K, G*4nu] in the kernel's order -> [B, 4H]
        K = a.shape[1]
        if bf16:  # chunk q of a ring stage (8 k16 chunks) to warp q % nks of a 16-song
            # tile, the warps' sums added in warp order
            nks, out = 16 // min(4, Bp // 16), 0
            for kq in range(nks):
                idx = torch.cat([torch.arange(c * 16, c * 16 + 16) for c in range(K // 16)
                                 if c % 8 % nks == kq] or [torch.zeros(0, dtype=torch.long)])
                out = out + a[:, idx] @ wk[idx]
        else:  # 4-k groups dealt to S lanes, added by the butterfly (here: in lane order)
            items = min(64, Bp) // 4 * nu  # the first pass's items
            S = 1
            while S < 16 and 2 * S * items <= 512:
                S *= 2
            out = 0
            for ks in range(S):
                idx = torch.cat([torch.arange(4 * k4, 4 * k4 + 4) for k4 in range(ks, K // 4, S)]
                                or [torch.zeros(0, dtype=torch.long)])
                out = out + a[:, idx] @ wk[idx]
        full = torch.zeros((Bp, 4 * H + 1))
        full[:, cols.reshape(-1)[keep]] = out[:, keep]
        return full[:B, :4 * H]

    head = cg.pack_head(w["wx_t"], bf16).float()
    if bf16:
        NTx, KCh = head.shape[:2]
        wx = torch.zeros((KCh * 16, NTx * 8))
        for lane in range(32):
            g, t = divmod(lane, 4)
            for i in range(4):
                wx[t * 4 + i::16, g::8] = head[:, :, lane, i].T
    else:
        wx = head.T                                    # [Kh, 8 NTx]
    wz_t, wkd_z = w["wz_t"].float(), w["wkd_z"].float()
    x = torch.zeros((Bp, Kx))
    he, hd = torch.zeros((Bp, Kh)), torch.zeros((Bp, Kh))
    c_e, c_d = torch.zeros((B, H)), torch.zeros((B, H))
    x[:B, :D] = rnd(seeds[:, 0])
    outs = []
    for t in range(Tseed + nsteps):
        z_e = w["encb"] + products(torch.cat([x, he], 1), enc_w)
        h, c_e = _gates(z_e, c_e, H)
        he = torch.zeros((Bp, Kh))
        he[:B, :H] = rnd(h)
        zmv = he[:B, :H] @ wz_t.T                      # the z heads on h as an operand
        z = (zmv[:, :L] + w["bz"][:L]) + torch.exp((zmv[:, L:] + w["bz"][L:]) / 2) * eps[:, t]
        a_d = torch.cat([x, hd], 1) if cfg.use_x_prev else hd
        z_d = w["decb"] + products(a_d, dec_w)
        for l in range(L):                             # z stays f32: L rank-1 terms
            z_d = z_d + z[:, l:l + 1] * wkd_z[l]
        h, c_d = _gates(z_d, c_d, H)
        hd = torch.zeros((Bp, Kh))
        hd[:B, :H] = rnd(h)
        logit = 0
        for warp in range(16):                         # k16 chunks over 16 warps, in order
            idx = torch.cat([torch.arange(c * 16, c * 16 + 16) for c in range(warp, Kh // 16, 16)]
                            or [torch.zeros(0, dtype=torch.long)])
            logit = logit + hd[:B, idx] @ wx[idx, :D]
        xm = 1 / (1 + torch.exp(-(logit + w["bx"])))
        xt = (u[:, t] < xm).float()
        x = torch.zeros((Bp, Kx))
        x[:B, :D] = rnd(seeds[:, t + 1]) if t + 1 < Tseed else xt
        if t >= Tseed:
            outs.append(xm if return_probs else xt)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("H", WIDTHS)
def test_every_unit_is_owned_once_with_its_four_gates(H, n_sm):
    """``int8_grid`` and ``_slice_cols``: nu even and at most 20, at most
    n_sm blocks, and every column g*H + u (u < H) in exactly one block's
    slice, at local column 4j + g of the block owning unit u."""
    nu, G = cg.int8_grid(H, n_sm)
    assert nu % 2 == 0 and G <= n_sm and (G - 1) * nu < H <= G * nu
    assert nu <= cg._G_MAX_UNITS or n_sm < 132  # an H100 covers every width with <= 20
    cols = cg._slice_cols(H, nu)
    assert cols.shape == (G, 4 * nu)
    seen = {}
    for b in range(G):
        for lc in range(4 * nu):
            c = int(cols[b, lc])
            if c == 4 * H:
                assert b * nu + lc // 4 >= H
                continue
            g, u = divmod(c, H)
            assert (u, g) == (b * nu + lc // 4, lc % 4)
            seen[c] = seen.get(c, 0) + 1
    assert sorted(seen) == list(range(4 * H)) and set(seen.values()) == {1}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H,D,use_x_prev", [(40, 12, True), (20, 88, False), (256, 88, True),
                                            (70, 5, True)])
def test_packed_slices_unpack_to_the_weights(H, D, use_x_prev, bf16):
    """Each block's slices read back element by element from the layout's
    definition give ``_pack``'s weights: rows [x rows | recurrent rows]
    each zero-padded to a multiple of 16, the block's columns, zeros past H;
    the frame head likewise."""
    jcfg, params, tcfg, a, _ = _setup(H=H, D=D, use_x_prev=use_x_prev, bf16=bf16)
    mode = "bf16" if bf16 else "f32"
    w = cg._pack(params_from_numpy(params, "cpu"), tcfg, torch.from_numpy(a["ws"]), D, mode)
    nu = cg.int8_grid(H, 132)[0]
    Kx, Kh = cg.round16(D), cg.round16(H)
    for w_x, rk in ((w["wke_x"], w["rke"]), (w["wkd_x"], w["rkd"])):
        sl = cg.pack_slices(w_x, rk, H, nu, D, bf16)
        assert sl.dtype == rk.dtype and sl.is_contiguous()
        kx = Kx if w_x is not None else 0
        assert sl.numel() == sl.shape[0] * (kx + Kh) * 4 * nu
        got = _unslice(sl, bf16)
        for b in range(sl.shape[0]):
            for lc in range(4 * nu):
                u, g = b * nu + lc // 4, lc % 4
                col = got[:, b, lc]
                if u >= H:
                    assert not col.any()
                    continue
                if w_x is not None:
                    assert torch.equal(col[:D], w_x[:, g * H + u]) and not col[D:Kx].any()
                assert torch.equal(col[kx:kx + H], rk[:, g * H + u]) and not col[kx + H:].any()
    head = cg.pack_head(w["wx_t"], bf16)
    if bf16:
        assert head.shape == (-(-D // 8), Kh // 16, 32, 4)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for n in range(head.shape[0]):
                for i in range(4):
                    for kc in range(Kh // 16):
                        k, d = 16 * kc + 4 * t + i, 8 * n + g
                        want = w["wx_t"][d, k] if d < D and k < H else 0
                        assert float(head[n, kc, lane, i]) == float(want)
    else:
        assert head.shape == (-(-D // 8) * 8, Kh)
        assert torch.equal(head[:D, :H], w["wx_t"]) and not head[D:].any()
        assert not head[:, H:].any()


def test_residency_and_width_rule():
    """Weights resident in shared memory where they fit: jsball_vrnn4 f32
    (H=256, L=8: 23 KB a block), bf16 H=512 and 1,024 (D=88, L=2) at every
    serving bucket; the slices stream from L2 at bf16 H=1,536 and 2,048.
    Every H the first kernel took (one block's 4-song state in shared
    memory, up to H ~ 2,230) still fits, the JAX auto bf16 checkpoints at
    H=1,024 and 2,048 included; so does H=4,096 (blocks of two unit groups,
    ``gen_grid``), and only a width whose groups' c of 16 songs passes a
    block's shared memory does not."""
    for B in (1, 4, 16, 64, 256):
        assert cg.resident_bytes(88, 256, 8, 2, B, True, "f32") == 22528
        assert cg.resident_bytes(88, 512, 2, 4, B, True, "bf16") == 38912
        assert cg.resident_bytes(88, 1024, 2, 8, B, True, "bf16") == 143360
        for H in (1536, 2048):
            nu = cg.int8_grid(H, 132)[0]
            assert cg.resident_bytes(88, H, 2, nu, B, True, "bf16") == 0
            assert cg.gen_smem(nu, B, 2) <= cg._SMEM_LIMIT
    assert cg.slices_bytes(88, 1536, 12, True, 2) == 313344  # ~313 KB: streamed
    old_smem = lambda D, H, L: ((D + 6 * H + L) * 4 + 4 * 4 * 256) * 4  # the 4-song kernel
    for L, D in ((8, 88), (2, 88), (3, 12)):
        widest = max(H for H in range(1, 3000) if old_smem(D, H, L) <= cg._SMEM_LIMIT)
        for H in (1, 64, 256, 1024, 2048, widest):
            for bf16 in (False, True):
                cfg = tcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                                 bf16_compute=bf16)
                assert cg.fits(cfg, "bf16" if bf16 else "f32"), (D, H, L)
    assert cg.fits(tcl.Config(intermediate_dim=4096))
    assert not cg.fits(tcl.Config(intermediate_dim=100_000))


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [dict(), dict(B=1, H=8, use_x_prev=False),
                                   dict(B=20, H=70, D=88, L=2, seed=1),
                                   dict(B=5, H=24, n_sm=3), dict(B=5, H=48, n_sm=2)])
def test_emulated_kernel_matches_plain(mode, shape):
    """The kernel's order on the packed operands against
    ``generate_cl_vrnn_batch_plain``: f32 frames equal and probabilities
    within 1e-5; bf16 probabilities with u = 1 within 2e-3. ``n_sm=3``
    gives blocks of many units (nu = 8 at H=24); ``n_sm=2`` blocks of two
    unit groups of 12 (24 units a block at H=48, past 20)."""
    n_sm = shape.pop("n_sm", 132)
    bf16 = mode == "bf16"
    jcfg, params, tcfg, a, nsteps = _setup(bf16=bf16, **shape)
    tp = params_from_numpy(params, "cpu")
    t = lambda k: torch.from_numpy(a[k])
    u = torch.ones_like(t("u")) if bf16 else t("u")
    args = (tp, tcfg, t("seeds"), nsteps, t("eps"), u, t("ws"))
    probs = _emulated(*args, mode, True, n_sm)
    want = cg.generate_cl_vrnn_batch_plain(*args, return_probs=True, mode=mode)
    torch.testing.assert_close(probs, want, **(dict(rtol=0, atol=2e-3) if bf16 else
                                               dict(rtol=1e-5, atol=1e-6)))
    if not bf16:
        torch.testing.assert_close(_emulated(*args, mode, False, n_sm),
                                   cg.generate_cl_vrnn_batch_plain(*args, mode=mode),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_emulated_kernel_matches_jax_pallas(mode):
    """The kernel's order against the JAX package's
    ``generate_cl_vrnn_batch_pallas`` in interpret mode, same weights and
    noise."""
    bf16 = mode == "bf16"
    jcfg, params, tcfg, a, nsteps = _setup(B=6, H=32, seed=2, bf16=bf16)
    u = np.ones_like(a["u"]) if bf16 else a["u"]
    ref = np.asarray(pallas_generate.generate_cl_vrnn_batch_pallas(
        params, jcfg, a["seeds"], nsteps, a["eps"], u, a["ws"], return_probs=True, mode=mode))
    t = torch.from_numpy
    got = _emulated(params_from_numpy(params, "cpu"), tcfg, t(a["seeds"]), nsteps, t(a["eps"]),
                    t(u), t(a["ws"]), mode, True)
    np.testing.assert_allclose(got.numpy(), ref, **(dict(rtol=0, atol=2e-3) if bf16 else
                                                    dict(rtol=1e-5, atol=1e-6)))
