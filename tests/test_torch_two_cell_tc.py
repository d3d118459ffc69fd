"""The layout of the redesigned two-cell backward (``csrc/two_cell_tc.cu``),
on the CPU.

The CUDA backward walks time in reverse with, per step, one product launch
over the whole batch (both cells as two jobs of one grid, tiles of BM rows x
BN units whose K is split between the two blocks of a cluster, each of
which then takes half the tile's rows; the decoder's gate gradients in the
epilogue) and one z hand-off
launch (4 rows a block: dz_d @ Kzᵀ with the columns split between 8 warps,
each warp's lane sums added in a fixed butterfly and the warps in order,
the z-sample backward, dza @ Wzᵀ and the encoder's gates). dx
comes after the walk, one product over all T*B rows per cell; the weight
gradients are products over all rows; the bias sums are partial sums per
(step, half tile), the half's rows added warp by warp (rows w, w+4, ...)
and the four warps in order, then summed over the partials in order. Here that
arithmetic is written out in plain PyTorch on the same tiles and indices
(:func:`_tiled_backward`), at the real tile sizes (f32 32 x 32, bf16 64 x
128) and at small ones (4 x 8) so that a small batch and width cut into
several ragged tiles, with the odd input width 101, and held against
``two_cell_bwd_plain`` (the function the kernels are held against on the
card) and, through the autograd route, against the JAX package's
``two_cell_sequence`` gradients (its Pallas kernels in interpret mode). The
CUDA kernels themselves run only on the card (``chip_smoke.py`` phases 5
and 23, ``tests/test_torch_cuda.py``).

Tolerances. The walk's recurrent products are the plain version's own
products, sliced into tiles (the split of K is an order of the sum, which
the card holds); dz_d @ Kzᵀ is summed as the hand-off sums it. dx
and the weight
gradients sum over all T*B rows at once where the plain version sums step
by step, and the bias sums add their rows in another order: f32 within
rtol 1e-5 / atol 1e-6; in the bf16 mode the bf16 outputs (dx, the six weight
gradients, rounded once) within one bf16 step and the f32 ones within rtol
1e-5 / atol 1e-6. Against JAX the bounds of ``tests/test_torch_two_cell.py``:
gradients rtol 2e-4 / atol 1e-5 in f32; in bf16 the bf16-valued gradients
within one bf16 step, the others rtol 1e-4 / atol 1e-5.
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
from classifying_vae_lstm_tpu_torch.ops.lstm import _gate_grads, bf16_operand
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

SUMS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
BF16 = dict(rtol=1e-4, atol=1e-5)
HANDOFF_ROWS = 4  # kHandoffRows
TILES = {"f32": (32, 32), "bf16": (64, 128)}  # (kFM, kFN), (kBM, kBN)
NAMES = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
         "dwz", "dbe", "dbd", "dbz")
BF16_OUT = {"dxe", "dxd", "drke", "drkd", "dwe", "dwdx", "dkz", "dwz"}


def _in_order(rows):
    """Rows added one after another, in order (one thread's sum)."""
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    return acc


def _tile_bias_sum(dz):
    """A half tile's bias partial sum: warp w adds rows w, w + 4, ... in
    order, then the four warps' sums are added in order."""
    warps = [_in_order(dz[w::4]) if len(dz[w::4]) else torch.zeros_like(dz[0])
             for w in range(4)]
    return ((warps[0] + warps[1]) + warps[2]) + warps[3]


def _handoff_dot(a, b):
    """sum_j a[j] b[j] as the hand-off block takes it: warp w of 8 the
    columns [w per, (w + 1) per), lane l of them l, l + 32, ... in order, a
    butterfly (xor 16, 8, 4, 2, 1) adds the lanes' sums (lane 0's value),
    then the warps' sums are added in order."""
    n = a.shape[0]
    per = -(-n // 8)
    total = torch.zeros(())
    for w in range(8):
        prod = (a * b)[w * per:(w + 1) * per]
        prod = torch.nn.functional.pad(prod, (0, -prod.shape[0] % 32)).reshape(-1, 32)
        lanes = _in_order(prod)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ off]
        total = total + lanes[0]
    return total


def _tiled_backward(ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dzargs,
                    we, rke, wdx, rkd, kz, wz, tile=None):
    """The redesigned backward's arithmetic on its tiles and indices, with
    the signature and results of ``two_cell_bwd_plain``. ``tile`` = (BM, BN)
    of the walk's product (default: the kernels' own for the mode)."""
    T, B, H4 = ze.shape
    H, L = H4 // 4, kz.shape[0]
    bf16 = ze.dtype == torch.bfloat16
    op = bf16_operand if bf16 else (lambda a: a)
    BM, BN = tile or TILES["bf16" if bf16 else "f32"]
    (ze, zd, hpe, he, hpd, xe, xd, we, rke, wdx, rkd, kz, wz) = (
        a.float() for a in (ze, zd, hpe, he, hpd, xe, xd, we, rke, wdx, rkd, kz, wz))
    nM, nR = -(-B // BM), -(-B // HANDOFF_ROWS)
    dzd, dze = torch.zeros(T, B, H4), torch.zeros(T, B, H4)  # the stored operand (rounded)
    dza, zs = torch.zeros(T, B, 2 * L), torch.zeros(T, B, L)
    part_d, part_e = torch.zeros(T * 2 * nM, H4), torch.zeros(T * nR, H4)
    dc_d, dc_e = torch.zeros(B, H), torch.zeros(B, H)
    gate_cols = lambda u0, u1: torch.cat([torch.arange(g * H + u0, g * H + u1) for g in range(4)])
    for t in range(T - 1, -2, -1):
        # (a) one launch, two jobs: rows of dz(t+1) times Rk [H, 4H] read as
        # Rkᵀ; the encoder's job stores its product, the next dh carry
        last = t + 1 == T
        acc_d = torch.zeros(B, H) if last else dzd[t + 1] @ rkd.T
        dh_e = torch.zeros(B, H) if last else dze[t + 1] @ rke.T
        if t < 0:
            dh0d, dh0e = acc_d, dh_e
            break
        # each tile's two blocks (the halves of K) take half its rows each
        for mt, half in ((mt, half) for mt in range(nM) for half in (0, 1)):
            r0 = mt * BM + half * (BM // 2)
            r1 = min(B, r0 + BM // 2)
            if r0 >= B:
                continue
            for u0 in range(0, H, BN):
                u1 = min(H, u0 + BN)
                cols = gate_cols(u0, u1)
                dz, dc_d[r0:r1, u0:u1] = _gate_grads(
                    zd[t, r0:r1][:, cols], cd[t, r0:r1, u0:u1], cpd[t, r0:r1, u0:u1],
                    acc_d[r0:r1, u0:u1] + dhd[t, r0:r1, u0:u1], dc_d[r0:r1, u0:u1])
                dzd[t, r0:r1, cols] = op(dz)
                part_d[(t * nM + mt) * 2 + half, cols] = _tile_bias_sum(dz)
        # (b) the hand-off, HANDOFF_ROWS rows a block
        for g in range(nR):
            s0, s1 = g * HANDOFF_ROWS, min(B, (g + 1) * HANDOFF_ROWS)
            for s in range(s0, s1):
                dzz = torch.stack([_handoff_dot(dzd[t, s], kz[l]) for l in range(L)])
                sig = torch.exp(zargs[t, s, L:] / 2)
                dza[t, s] = torch.cat([dzz + dzargs[t, s, :L],
                                       dzz * eps[t, s] * sig * 0.5 + dzargs[t, s, L:]])
                zs[t, s] = zargs[t, s, :L] + sig * eps[t, s]
            rows = slice(s0, s1)
            dhez = op(dza[t, rows]) @ wz.T
            dz, dc_e[rows] = _gate_grads(ze[t, rows], ce[t, rows], cpe[t, rows],
                                         dh_e[rows] + dhez, dc_e[rows])
            dze[t, rows] = op(dz)
            part_e[t * nR + g] = _in_order(dz)
    # after the walk: dx and the weight gradients over all T*B rows
    R = T * B
    flat = lambda a: a.reshape(R, a.shape[-1])
    dxe, dxd = (flat(dze) @ we.T).reshape(T, B, -1), (flat(dzd) @ wdx.T).reshape(T, B, -1)
    drke, dwe = flat(hpe).T @ flat(dze), flat(xe).T @ flat(dze)
    drkd, dwdx = flat(hpd).T @ flat(dzd), flat(xd).T @ flat(dzd)
    dkz, dwz = flat(op(zs)).T @ flat(dzd), flat(he).T @ flat(op(dza))
    dbe, dbd, dbz = _in_order(part_e), _in_order(part_d), _in_order(flat(dza))
    if bf16:
        dxe, dxd, drke, drkd, dwe, dwdx, dkz, dwz = (
            a.bfloat16() for a in (dxe, dxd, drke, drkd, dwe, dwdx, dkz, dwz))
    return (dxe, dxd, dh0e, dc_e, dh0d, dc_d, drke, drkd, dwe, dwdx, dkz, dwz, dbe, dbd, dbz)


def _bf16_steps(got, ref) -> int:
    """The largest distance, in bf16 steps, between two bf16 tensors."""
    order = lambda a: (lambda b: torch.where(b < 0, -(b & 0x7FFF), b))(
        a.view(torch.int16).to(torch.int32))
    return int((order(got) - order(ref)).abs().max())


def _residuals(B, T=4, INe=101, INd=101, H=20, L=3, bf16=False, seed=0):
    """The backward's inputs from a run of the plain forward on seeded
    inputs (the residual streams the forward writes), with seeded
    cotangents."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    ins = [f(T, B, INe), f(T, B, INd), f(T, B, L), f(INe, 4 * H, scale=0.2), f(4 * H, scale=0.3),
           f(H, 4 * H, scale=0.3), f(INd, 4 * H, scale=0.2), f(4 * H, scale=0.3),
           f(H, 4 * H, scale=0.3), f(L, 4 * H, scale=0.3), f(H, 2 * L, scale=0.3),
           f(2 * L, scale=0.3), f(B, H, scale=0.5), f(B, H, scale=0.5), f(B, H, scale=0.5),
           f(B, H, scale=0.5)]
    if bf16:
        for i in (0, 1, 3, 5, 6, 8, 9, 10):  # xe, xd, we, rke, wdx, rkd, kz, wz
            ins[i] = ins[i].bfloat16()
    (xe, xd, eps, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    (hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd) = ttc.two_cell_fwd_plain(*ins)
    dhd, dza = f(*hd.shape, scale=0.5), f(*zargs.shape, scale=0.5)
    return (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps, zargs, xe, xd, dhd, dza,
            we, rke, wdx, rkd, kz, wz)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("tile", ["kernel", "small"])
@pytest.mark.parametrize("B", [11, 8])
def test_tiled_backward_matches_plain(mode, tile, B):
    """The tiles, the hoisted dx, the weight-gradient products over all rows
    and the partial bias sums, against the step-by-step plain backward:
    every output agrees to the order of its sums."""
    res = _residuals(B, bf16=mode == "bf16", seed=B)
    got = _tiled_backward(*res, tile=(4, 8) if tile == "small" else None)
    want = ttc.two_cell_bwd_plain(*res)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if mode == "bf16" and name in BF16_OUT:
            assert _bf16_steps(g, w) <= 1, name
        else:
            torch.testing.assert_close(g, w, msg=name, **SUMS)


def test_tiles_cover_every_row_and_unit_once():
    """Ragged tiles (B=11 rows in tiles of 4, H=20 units in tiles of 8) give
    every output but the decoder's bias sum bit for bit as the kernel's own
    tiles (one tile here), in both modes: each dz entry is written once, by
    the same arithmetic; dbd, whose partial sums follow the row tiles,
    agrees to the order of its sums."""
    for bf16 in (False, True):
        res = _residuals(11, bf16=bf16, seed=3)
        small = _tiled_backward(*res, tile=(4, 8))
        whole = _tiled_backward(*res)
        for name, a, b in zip(NAMES, small, whole):
            if name == "dbd":
                torch.testing.assert_close(a, b, msg=name, **SUMS)
            else:
                assert torch.equal(a, b), name


def _setup(B=11, T=4, D=88, H=24, L=2, K=13, seed=0):
    """JAX-initialised weights and seeded inputs at the real input width
    (D + K = 101 for the encoder and, with x_prev, the decoder)."""
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=True)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    xp = (rng.random((B, T, D)) < 0.2).astype(np.float32)
    W = np.array(jax.nn.softmax(rng.standard_normal((B, K)).astype(np.float32)))
    eps = rng.standard_normal((B, T, L)).astype(np.float32)
    return jcfg, tcl.Config(**dataclasses.asdict(jcfg)), params, x, xp, W, eps


def _loss(hd, zm, zlv, z, lib):
    return (lib.sum(hd ** 2) + lib.sum(lib.sin(zm)) + lib.sum(zlv ** 2)
            + lib.sum(z * lib.cos(z)))


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_tiled_route_matches_jax(monkeypatch, mode):
    """The autograd route with the tiled backward in place of the plain one
    (what the card runs) against ``jax.grad`` of the JAX package's kernel
    path, every gradient of the core's parameters and of x, x_prev and W,
    at a ragged batch and the input width 101."""
    monkeypatch.setattr(ttc, "two_cell_bwd_plain", _tiled_backward)
    bf16 = mode == "bf16"
    jcfg, tcfg, params, x, xp, W, eps = _setup(seed=2)
    tparams = params_from_numpy(params, "cpu")
    for cell in tparams.values():
        for v in cell.values():
            v.requires_grad_(True)
    t = lambda a: torch.from_numpy(a).requires_grad_(True)
    tx, txp, tW = t(x), t(xp), t(W)
    dtype = torch.bfloat16 if bf16 else None
    out = ttc.two_cell_sequence(tparams, tcfg, tx, txp, tW, torch.from_numpy(eps),
                                compute_dtype=dtype)
    _loss(*out, torch).backward()
    cdt = jnp.bfloat16 if bf16 else None
    ref = jax.grad(lambda p, x, xp, W: _loss(
        *jtc.two_cell_sequence(p, jcfg, x, xp, W, eps, compute_dtype=cdt), jnp),
        argnums=(0, 1, 2, 3))(params, x, xp, W)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    pairs = [(f"{n}/{leaf}", tparams[n][leaf].grad, r)
             for n in ("encoder_h", "decoder_h", "Z_mean", "Z_log_var")
             for leaf, r in ref[0][n].items()]
    pairs += [("x", tx.grad, ref[1]), ("x_prev", txp.grad, ref[2]), ("W", tW.grad, ref[3])]
    for name, g, r in pairs:
        r = torch.from_numpy(np.array(f32(r)))
        if bf16 and not name.endswith("bias") and name != "W":
            assert torch.equal(g, g.bfloat16().float()), f"{name} not bf16-valued"
            assert _bf16_steps(g.bfloat16(), r.bfloat16()) <= 1, name
        else:
            torch.testing.assert_close(g, r, msg=name, **(BF16 if bf16 else GRAD))
