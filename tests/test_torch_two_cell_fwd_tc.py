"""The redesigned two-cell forward's layouts and sum order, on the CPU.

``csrc/two_cell.cu`` runs only on the card; what surrounds it is Python that
these tests reach: the operands ``fwd_operands`` lays out (Wᵀ with its rows
gate-interleaved, the x rows padded to whole 16-byte chunks, the h operands
double-buffered with op(h0) in buffer 0), the column tiles of a step's
product (``fwd_tiles``: which tile owns which units) and the shared-memory
rule (``fits``: no width limit). ``_tiled_forward`` is the kernel's
arithmetic in torch, in its order: launch t = encoder step t and decoder
step t - 1, each a product [x[t] | h] @ [W ; Rk] whose K is split at a whole
32-chunk into two halves added rank 0 then rank 1, the z heads as
per-column-tile partial sums added in tile order one launch later, z = b +
z @ Kz (L rank-1 f32 terms) + the product, the gates on the interleaved
columns. It is held against ``two_cell_fwd_plain`` and the JAX package's
``_fwd_call`` (interpret mode), f32 and bf16.

Tolerances: f32 outputs rtol 1e-5 / atol 1e-6 (the same f32 products summed
in another order); in the bf16 mode the f32 outputs rtol 1e-4 / atol 1e-5
and the bf16 streams (ze, zd, hpe, he, hpd) within one bf16 step, as
``tests/test_torch_two_cell.py`` holds the plain version (an f32 sum taken
in another order may land on the other side of a bf16 rounding boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.ops import pallas_two_cell as jtc
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import two_cell as ttc
from classifying_vae_lstm_tpu_torch.ops.lstm import _gates, bf16_operand
from classifying_vae_lstm_tpu_torch.ops.lstm_seq import interleave_gates
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

FWD = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-4, atol=1e-5)
BF = jnp.bfloat16
NAMES = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
STREAMS = {"ze", "zd", "hpe", "he", "hpd"}


def _setup(B=12, T=5, D=16, H=24, L=2, K=3, use_x_prev=True, seed=0, bf16=False):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    xp = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    W = np.array(jax.nn.softmax(rng.standard_normal((B, K)).astype(np.float32)))
    eps = rng.standard_normal((B, T, L)).astype(np.float32)
    tcfg = tcl.Config(**dataclasses.asdict(jcfg))
    t = torch.from_numpy
    ins = ttc.pack_inputs(params_from_numpy(params, "cpu"), tcfg, t(x), t(xp), t(W), t(eps),
                          compute_dtype=torch.bfloat16 if bf16 else None)
    return jcfg, params, (x, xp, W, eps), ins


def _tiled_forward(xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, h0e, c0e, h0d, c0d):
    """``csrc/two_cell.cu``'s forward in torch, on ``fwd_operands``'
    layouts and in the kernel's order (module note); signature and results
    of ``two_cell_fwd_plain``."""
    bf16 = xe.dtype == torch.bfloat16
    op = ttc.fwd_operands(xe, xd, we, rke, wdx, rkd, kz, h0e, h0d)
    T, B, _ = xe.shape
    H, L = rke.shape[0], kz.shape[0]
    Hp, H4, kU = op["hbe"].shape[-1], 4 * H, (128 if bf16 else 32) // 4
    f = lambda a: a.float()
    rnd = bf16_operand if bf16 else (lambda a: a)
    xe_r, xd_r = (op[k].view(T, B, -1) for k in ("xe", "xd"))
    gi = interleave_gates  # a bias at the tile's interleaved columns

    def product(x, wt, h, rkt):  # [x | h] @ [W ; Rk]: rank 0's half of K, then rank 1's
        a, w = torch.cat([f(x), f(h)], 1), torch.cat([f(wt), f(rkt)], 1)
        K = a.shape[1]
        kh = min(-(-(K // 2) // 32) * 32, K)  # the cluster's K split, in whole 32-chunks
        return a[:, :kh] @ w[:, :kh].T + a[:, kh:] @ w[:, kh:].T

    def cell(zint, c_prev):
        z = zint.view(B, H, 4).transpose(1, 2).reshape(B, H4)  # back to [i | f | c | o]
        h, c = _gates(z, c_prev, H)
        return z, h, c

    ntn = ttc.fwd_tiles(H, bf16)
    hbe, hbd = op["hbe"][0], op["hbd"][0]
    c_e, c_d = c0e, c0d
    outs = {n: [None] * T for n in NAMES}
    zpart = None
    for t in range(T + 1):
        if t > 0:  # decoder step s = t - 1 on the partials of launch t - 1
            s = t - 1
            zm, zv = bz[:L].clone() * 0, bz[L:].clone() * 0
            for n in range(ntn):
                zm, zv = zm + zpart[n][:, :L], zv + zpart[n][:, L:]
            zm, zv = zm + bz[:L], zv + bz[L:]
            z = rnd(zm + torch.exp(zv / 2) * eps[s])
            zint = gi(bd).expand(B, H4)
            for l in range(L):
                zint = zint + z[:, l:l + 1] * f(op["kz"][l])
            zd, h, c = cell(zint + product(xd_r[s], op["wdxt"], hbd, op["rkdt"]), c_d)
            for n, v in zip(("zargs", "zd", "hpd", "cpd", "cd", "hd"),
                            (torch.cat([zm, zv], -1), zd, hbd[:, :H], c_d, c, h)):
                outs[n][s] = v
            hbd = torch.nn.functional.pad(rnd(h), (0, Hp - H)).to(xe.dtype)
            c_d = c
        if t < T:
            ze, h, c = cell(gi(be) + product(xe_r[t], op["wet"], hbe, op["rket"]), c_e)
            hq = rnd(h)
            for n, v in zip(("ze", "hpe", "cpe", "ce", "he"), (ze, hbe[:, :H], c_e, c, hq)):
                outs[n][t] = v
            zpart = [hq[:, n * kU:(n + 1) * kU] @ f(wz[n * kU:(n + 1) * kU]) for n in range(ntn)]
            hbe = torch.nn.functional.pad(hq, (0, Hp - H)).to(xe.dtype)
            c_e = c
    res = [torch.stack(outs[n]) for n in NAMES]
    if bf16:
        res = [r.bfloat16() if n in STREAMS else r for n, r in zip(NAMES, res)]
    return tuple(res)


def _bf16_steps(got, ref) -> int:
    """The largest distance, in bf16 steps, between two bf16-valued arrays."""
    def order(a):
        a = torch.as_tensor(np.array(a, np.float32))
        assert torch.equal(a, a.bfloat16().float()), "not bf16-representable"
        bits = a.bfloat16().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((order(got) - order(ref)).abs().max())


def _assert_outputs(got, ref, bf16, label):
    for name, g, r in zip(NAMES, got, ref):
        r = torch.as_tensor(np.array(r, np.float32)) if not torch.is_tensor(r) else r.float()
        assert tuple(g.shape) == tuple(r.shape), (label, name)
        if bf16 and name in STREAMS:
            assert g.dtype == torch.bfloat16, (label, name)
            assert _bf16_steps(g.float(), r) <= 1, (label, name)
        else:
            assert g.dtype == torch.float32, (label, name)
            torch.testing.assert_close(g, r, msg=f"{label}: {name}", **(BF16 if bf16 else FWD))


@pytest.mark.parametrize("H", [4, 20, 24, 40, 256, 300, 512, 1000])
@pytest.mark.parametrize("bf16", [False, True])
def test_column_tiles_own_every_unit_once_with_its_four_gates(H, bf16):
    """The tiles of a step's product cover the 4H interleaved columns: tile
    n owns units n BN/4 .. with all four gates (columns 4u .. 4u + 3 of
    ``gate_rows_t``), every unit exactly once; B is cut into whole row tiles
    with a ragged last one at any B."""
    BN = 128 if bf16 else 32
    ntn = ttc.fwd_tiles(H, bf16)
    owner = {}
    for n in range(ntn):
        for c in range(n * BN, min((n + 1) * BN, 4 * H)):
            u, g = divmod(c, 4)
            owner.setdefault(u, set()).add((n, g))
    assert sorted(owner) == list(range(H))
    assert all(len({n for n, _ in v}) == 1 and {g for _, g in v} == {0, 1, 2, 3}
               for v in owner.values())
    assert (ntn - 1) * BN < 4 * H <= ntn * BN
    BM = 64 if bf16 else 32
    for B in (1, 7, 200, 1024, 1025):
        rows = [r for m in range(-(-B // BM)) for r in range(m * BM, min((m + 1) * BM, B))]
        assert rows == list(range(B))


@pytest.mark.parametrize("H,IN", [(24, 19), (20, 101), (8, 8), (33, 1)])
def test_operands_unpack_to_the_weights(H, IN):
    """``fwd_operands`` read back by an independent reading of the layout:
    row 4u + g of Wᵀ is column g*H + u of W, K zero-padded to round8; Kz
    interleaved likewise; x rows padded with zeros; buffer 0
    of the h operands holds op(h0), the rest zeros."""
    rng = np.random.default_rng(H)
    T, B, L = 3, 5, 2
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    xe, xd, we, wdx = r(T, B, IN), r(T, B, IN + 3), r(IN, 4 * H), r(IN + 3, 4 * H)
    rke, rkd, kz = r(H, 4 * H), r(H, 4 * H), r(L, 4 * H)
    h0e, h0d = r(B, H), r(B, H)
    for bf16 in (False, True):
        cast = (lambda a: a.bfloat16()) if bf16 else (lambda a: a)
        op = ttc.fwd_operands(cast(xe), cast(xd), cast(we), cast(rke), cast(wdx), cast(rkd),
                              cast(kz), h0e, h0d)
        Hp = -(-H // 8) * 8
        for key, w, width in (("wet", we, -(-IN // 8) * 8), ("wdxt", wdx, -(-(IN + 3) // 8) * 8),
                              ("rket", rke, Hp), ("rkdt", rkd, Hp)):
            got = op[key]
            assert tuple(got.shape) == (4 * H, width) and got.dtype == cast(w).dtype, key
            for u in range(H):
                for g in range(4):
                    assert torch.equal(got[4 * u + g, :w.shape[0]], cast(w)[:, g * H + u]), key
            assert not got[:, w.shape[0]:].any(), key
        for u in range(H):
            for g in range(4):
                assert torch.equal(op["kz"][:, 4 * u + g], cast(kz)[:, g * H + u])
        for key, x in (("xe", xe), ("xd", xd)):
            assert op[key].shape == (T * B, -(-x.shape[-1] // 8) * 8)
            assert torch.equal(op[key][:, :x.shape[-1]], cast(x).reshape(T * B, -1))
            assert not op[key][:, x.shape[-1]:].any()
        for key, h0 in (("hbe", h0e), ("hbd", h0d)):
            hb = op[key]
            assert hb.shape == (2, B, Hp) and hb.dtype == cast(xe).dtype
            assert torch.equal(hb[0, :, :H].float(), cast(h0).float())
            assert not hb[0, :, H:].any() and not hb[1].any()


def test_no_width_limit():
    """The forward's state lives in global memory: a step block's shared
    memory depends on L alone, and every hidden width fits (the old
    4-row-tile kernel stopped near H = 2,200); the f32 route is taken at
    every H its gate takes."""
    mk = lambda **kw: tcl.Config(**{**dict(original_dim=88, intermediate_dim=256,
                                           latent_dim=8, n_classes=13, use_x_prev=True,
                                           lstm_backend="pallas"), **kw})
    for H in (88, 256, 512, 1024, 2048, 4096, 8192, 16384):
        for bf16 in (False, True):
            assert ttc.fits(mk(intermediate_dim=H, bf16_compute=bf16))
        assert ttc.should_use(mk(intermediate_dim=H))
    for L in (1, 2, 8):
        assert ttc.fwd_smem_bytes(L, True) == 46080  # the mainloop's ring
    for L in (1, 2, 8, 64):
        assert ttc.fwd_smem_bytes(L, False) == 27648
    assert ttc.fwd_smem_bytes(64, True) == (64 * 132 + 32 * 32 + 224 * 64) * 4
    assert ttc.fwd_smem_bytes(400, False) == (32 * 36 + 16 * 8 + 64 * 400) * 4


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [dict(), dict(B=11, H=40, L=3), dict(B=9, H=20, D=88, K=13,
                                                                          use_x_prev=False),
                                   dict(B=3, T=1, H=70, L=4)])
def test_tiled_forward_matches_plain(bf16, shape):
    """The kernel's order against ``two_cell_fwd_plain`` on the same
    operands, f32 and bf16, at ragged widths (H not a multiple of 8, more
    than one 32-chunk of K to split, an input width of 101)."""
    _, _, _, ins = _setup(bf16=bf16, seed=3, **shape)
    _assert_outputs(_tiled_forward(*ins), ttc.two_cell_fwd_plain(*ins), bf16, "plain")


@pytest.mark.parametrize("bf16", [False, True])
def test_tiled_forward_matches_jax_fwd_call(bf16):
    """The kernel's order against the JAX package's ``_fwd_call`` (interpret
    mode on the CPU) fed the operands ``two_cell_sequence`` gives it
    (lane-padded, sliced back here)."""
    B, T, H, L = 8, 5, 24, 2
    _, _, _, ins = _setup(B=B, T=T, H=H, L=L, seed=7, bf16=bf16)
    (xe, xd, eps_t, we, be, rke, wdx, bd, rkd, kz, wz, bz, *h0) = ins
    LP, INp = jtc.LP, 128
    j = lambda a: jnp.asarray(a.float().numpy(), BF if a.dtype == torch.bfloat16 else jnp.float32)
    padr = lambda a, n: jnp.pad(j(a), ((0, n - a.shape[0]), (0, 0)))
    padl = lambda a, n: jnp.pad(j(a), [(0, 0)] * (a.dim() - 1) + [(0, n - a.shape[-1])])
    halves = lambda a: jnp.concatenate([padl(a[..., :L], LP), padl(a[..., L:], LP)], -1)
    jins = (padl(xe, INp), padl(xd, INp), padl(eps_t, LP), padr(we, INp), j(be)[None],
            j(rke), padr(wdx, INp), j(bd)[None], j(rkd), padr(kz, LP), halves(wz),
            halves(bz)[None], *(j(h) for h in h0))
    ref = list(jtc._fwd_call(*jins))
    ref[1] = jnp.concatenate([ref[1][..., :L], ref[1][..., LP:LP + L]], -1)
    _assert_outputs(_tiled_forward(*ins), [np.asarray(jnp.asarray(r, jnp.float32)) for r in ref],
                    bf16, "jax _fwd_call")


@pytest.mark.parametrize("bf16", [False, True])
def test_tiled_route_matches_jax(monkeypatch, bf16):
    """The model's entry with the kernel's order in place of the plain
    forward, against the JAX package's ``two_cell_sequence`` (its Pallas
    kernels in interpret mode): hd, Z_mean, Z_log_var and Z."""
    monkeypatch.setattr(ttc, "two_cell_fwd_plain", _tiled_forward)
    jcfg, params, (x, xp, W, eps), _ = _setup(B=10, H=32, seed=5, bf16=bf16)
    t = torch.from_numpy
    got = ttc.two_cell_sequence(params_from_numpy(params, "cpu"), tcl.Config(
        **dataclasses.asdict(jcfg)), t(x), t(xp), t(W), t(eps),
        compute_dtype=torch.bfloat16 if bf16 else None)
    ref = jtc.two_cell_sequence(params, jcfg, x, xp, W, eps,
                                compute_dtype=jnp.bfloat16 if bf16 else None)
    for name, g, r in zip(("hd", "Z_mean", "Z_log_var", "Z"), got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r, np.float32), err_msg=name,
                                   **(BF16 if bf16 else FWD))
