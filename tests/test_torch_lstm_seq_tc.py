"""The layouts of the bf16 tensor-core route of the whole-sequence LSTM, on
the CPU.

``csrc/lstm_seq_tc.cu`` takes its operands in layouts that
``ops/lstm_seq.py`` builds in plain PyTorch: x and W with K padded by zeros
to a multiple of 8 (``tc_fwd_operands``), W and Rk with the four gates of
each unit side by side (``interleave_gates``), the h operand in a
double buffer with zero pad columns (``tc_h_operand``) and the walk's right
operand ``[Rkᵀ | 0 | Wᵀ | 0]`` (``tc_walk_weights``). Here each kernel's
arithmetic is written on those layouts, step by step as the kernels compute
it (the products of the permuted and padded operands, then the gates read
through the inverse permutation), and held against the plain versions the
kernels are held against on the card, and, through
``lstm_sequence(backend="pallas", compute_dtype=bf16)``, against the JAX
package's Pallas kernels in interpret mode at the (T, T, T) and (T, F, F)
rungs. The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the forwards and the walk equal the plain versions exactly (the
same f32 products of the same bf16 values; a column permutation and zero
padding do not change any sum); dRk, dW and db, which the route sums over
all T*B rows at once where the plain version sums step by step, within
rtol 1e-6 / atol 1e-6 (the full rung's dRk, rounded once to bf16 after its
sum, within one bf16 step); against JAX the forward within 1e-5 absolute and the gradients within
1e-2 relative Frobenius (the bounds ``tests/test_torch_lstm_seq.py`` holds
the bf16 walks to against interpret-mode JAX), and the whole route equal to
the plain route's (gradients rtol 1e-4 / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu_torch.ops import lstm as tlstm
from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
from classifying_vae_lstm_tpu_torch.ops.lstm import _gate_grads, _gates
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

EXACT = dict(rtol=0, atol=0)
SUMS = dict(rtol=1e-6, atol=1e-6)
BF16_STEP = dict(rtol=2 ** -7, atol=1e-6)  # one bf16 rounding step (8 bits)
FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(H, IN) for H in (8, 88) for IN in (0, 13, 88)]
bf = torch.bfloat16


def deinterleave_gates(z):
    """The inverse of ``interleave_gates`` on the last dimension: the
    gate-ordered layout the kernels write z (and xz) back at."""
    H = z.shape[-1] // 4
    return z.reshape(*z.shape[:-1], H, 4).transpose(-1, -2).reshape(z.shape)


def _inputs(H, IN, B=5, T=4, seed=0):
    """Time-major bf16 x [T, B, max(IN, 1)], f32 W, b, bf16 Rk, f32 h0, c0
    (IN = 0 stands for the unfused route, whose xz is given in)."""
    rng = np.random.default_rng(seed + H + IN)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    IN = max(IN, 1)
    return (f(T, B, IN).to(bf), f(IN, 4 * H, scale=0.3), f(4 * H, scale=0.3),
            f(H, 4 * H, scale=0.3).to(bf), f(B, H, scale=0.5), f(B, H, scale=0.5))


def _tc_steps(xz, rk, h0, c0):
    """``lstm_tc_step_kernel`` on its layouts: per step the product of the
    double-buffered bf16 h operand and the gate-interleaved Rk (K padded to
    Hp), added to xz through the inverse permutation, then the gates."""
    T, B, H4 = xz.shape
    H = H4 // 4
    Hp = ls.round8(H)
    rk_il = torch.nn.functional.pad(ls.interleave_gates(rk).float(), (0, 0, 0, Hp - H))
    hb = ls.tc_h_operand(h0, Hp)
    c = c0
    outs = [[] for _ in range(5)]
    for t in range(T):
        hp, cp = hb[t % 2].clone(), c
        z = xz[t].float() + deinterleave_gates(hp.float() @ rk_il)
        h, c = _gates(z, c, H)
        hb[(t + 1) % 2, :, :H] = h
        for acc, v in zip(outs, (h, c, z.to(bf), hp[:, :H], cp)):
            acc.append(v)
    return tuple(torch.stack(o) for o in outs)


def _tc_proj(x, w, b):
    """``lstm_tc_proj_kernel``: the padded, gate-interleaved product, then b
    read at the original layout and the sum rounded, stored at the original
    layout."""
    T, B, _ = x.shape
    xp, wp = ls.tc_fwd_operands(x, w)
    acc = deinterleave_gates(xp.float() @ wp.float())
    return (acc + b).to(bf).reshape(T, B, -1)


def tc_train_fwd(x, w, b, rk, h0, c0):
    return _tc_steps(_tc_proj(x, w, b), rk, h0, c0)


def tc_fwd(x, w, b, rk, h0, c0):
    return tc_train_fwd(x, w, b, rk, h0, c0)[:2]


def tc_xz_train_fwd(xz, rk, h0, c0):
    return _tc_steps(xz, rk, h0, c0)[:3]


def tc_xz_fwd(xz, rk, h0, c0):
    return _tc_steps(xz, rk, h0, c0)[:2]


def _tc_walk(z, c_prev, c, dh_seq, dc_seq, rk_t, w_t=None):
    """``cvl_lstm_tc_walk``: per step in reverse the gate gradients, then
    bf16(dz) times the padded ``[Rkᵀ | 0 | Wᵀ | 0]``; columns < H are the
    dh carry, columns Hp .. Hp+IN dx (rounded as stored). Returns (f32 dz,
    bf16 dz, dx or None, dh0, dc0)."""
    T, B, H4 = z.shape
    H = H4 // 4
    wt, xs = ls.tc_walk_weights(rk_t, w_t)
    wt = wt.float()
    dh = torch.zeros(B, H)
    dc = torch.zeros(B, H)
    dz32, dzb, dx = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        dz, dc = _gate_grads(z[t].float(), c[t], c_prev[t], dh + dh_seq[t], dc + dc_seq[t])
        dz32[t], dzb[t] = dz, dz.to(bf)
        out = dzb[t].float() @ wt
        dh = out[:, :H]
        if w_t is not None:
            dx[t] = out[:, xs:xs + w_t.shape[1]].to(bf)
    return (torch.stack(dz32), torch.stack(dzb),
            torch.stack(dx) if w_t is not None else None, dh, dc)


def _rows_product(a, dzb):
    """``lstm_tc_drk_kernel``: aᵀ bf16(dz) over all T*B rows, f32 sums."""
    R = a.shape[0] * a.shape[1]
    return a.reshape(R, -1).float().T @ dzb.reshape(R, -1).float()


def tc_walk(z, c_prev, c, dh_seq, dc_seq, rk_t):
    _, dzb, _, dh0, dc0 = _tc_walk(z, c_prev, c, dh_seq, dc_seq, rk_t)
    return dzb, dh0, dc0


def tc_walk_drk(z, c_prev, c, h_prev, dh_seq, dc_seq, rk_t):
    dzb, dh0, dc0 = tc_walk(z, c_prev, c, dh_seq, dc_seq, rk_t)
    return dzb, dh0, dc0, _rows_product(h_prev, dzb)


def tc_bwd(z, c_prev, c, h_prev, x, dh_seq, dc_seq, rk_t, w_t):
    """The full rung: the walk with dx, dRk (rounded once), and the dW / db
    pass of ``wgrad_kernel`` (dW from bf16(dz) in f32, db from the f32 dz)."""
    dz32, dzb, dx, dh0, dc0 = _tc_walk(z, c_prev, c, dh_seq, dc_seq, rk_t, w_t.to(bf))
    R = z.shape[0] * z.shape[1]
    return (dx, dh0, dc0, _rows_product(h_prev, dzb).to(bf), _rows_product(x, dzb),
            dz32.reshape(R, -1).sum(0))


def _assert(got, want, names, tol):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), err_msg=name, **tol)


def test_interleave_gates_is_a_permutation_with_its_inverse():
    """Unit u's gates (i, f, c, o) land on columns 4u .. 4u+3, exactly, for
    a matrix and a bias; the inverse restores the original layout."""
    for H in (8, 88):
        w = torch.arange(3 * 4 * H, dtype=torch.float32).reshape(3, 4 * H)
        il = ls.interleave_gates(w)
        for u in (0, H // 2, H - 1):
            for g in range(4):
                assert torch.equal(il[:, 4 * u + g], w[:, g * H + u])
        assert torch.equal(deinterleave_gates(il), w)
        assert torch.equal(ls.interleave_gates(w[0]), il[0])
        z = torch.randn(2, 3, 4 * H)
        assert torch.equal(deinterleave_gates(ls.interleave_gates(z)), z)


@pytest.mark.parametrize("H,IN", SHAPES)
def test_padded_operands(H, IN):
    """K is padded with zeros to a multiple of 8 (x and W, the h buffer, the
    walk's Rkᵀ | Wᵀ), and the padding holds zeros only."""
    x, w, _, rk, h0, _ = _inputs(H, IN)
    T, B, INx = x.shape
    INp, Hp = ls.round8(INx), ls.round8(H)
    xp, wp = ls.tc_fwd_operands(x, w)
    assert xp.shape == (T * B, INp) and wp.shape == (INp, 4 * H)
    assert xp.dtype == wp.dtype == bf and xp.is_contiguous() and wp.is_contiguous()
    assert torch.equal(xp[:, :INx], x.reshape(T * B, INx)) and not xp[:, INx:].any()
    assert torch.equal(wp[:INx], ls.interleave_gates(w.to(bf))) and not wp[INx:].any()
    hb = ls.tc_h_operand(h0, Hp)
    assert hb.shape == (2, B, Hp) and torch.equal(hb[0, :, :H], h0.to(bf))
    assert not hb[0, :, H:].any() and not hb[1].any()
    rk_t, w_t = rk.T.contiguous(), w.T.contiguous().to(bf)
    wt, xs = ls.tc_walk_weights(rk_t, w_t)
    assert xs == Hp and wt.shape == (4 * H, Hp + INp) and wt.dtype == bf
    assert torch.equal(wt[:, :H], rk_t) and torch.equal(wt[:, Hp:Hp + INx], w_t)
    assert not wt[:, H:Hp].any() and not wt[:, Hp + INx:].any()
    walk_wt, _ = ls.tc_walk_weights(rk_t)
    assert walk_wt.shape == (4 * H, Hp) and torch.equal(walk_wt[:, :H], rk_t)


@pytest.mark.parametrize("H,IN", SHAPES)
def test_layout_forwards_equal_the_plain_versions(H, IN):
    """The route's forwards on the permuted and padded layouts, undone,
    equal ``lstm_seq_train_fwd_plain`` / ``lstm_seq_fwd_plain`` (IN > 0) or
    the unfused ``lstm_seq_xz_*_plain`` (IN = 0) exactly."""
    x, w, b, rk, h0, c0 = _inputs(H, IN)
    if IN:
        _assert(tc_train_fwd(x, w, b, rk, h0, c0), ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0),
                ("h", "c", "z", "h_prev", "c_prev"), EXACT)
        _assert(tc_fwd(x, w, b, rk, h0, c0), ls.lstm_seq_fwd_plain(x, w, b, rk, h0, c0),
                ("h", "c"), EXACT)
    else:
        xz = (0.5 * torch.randn(x.shape[0], x.shape[1], 4 * H,
                                generator=torch.Generator().manual_seed(H))).to(bf)
        _assert(tc_xz_train_fwd(xz, rk, h0, c0), ls.lstm_seq_xz_train_fwd_plain(xz, rk, h0, c0),
                ("h", "c", "z"), EXACT)
        _assert(tc_xz_fwd(xz, rk, h0, c0), ls.lstm_seq_xz_fwd_plain(xz, rk, h0, c0),
                ("h", "c"), EXACT)


def _residuals(H, IN, seed=1):
    x, w, b, rk, h0, c0 = _inputs(H, IN)
    h, c, z, hp, cp = ls.lstm_seq_train_fwd_plain(x, w, b, rk, h0, c0)
    rng = np.random.default_rng(seed)
    dh = torch.from_numpy(rng.standard_normal(tuple(h.shape)).astype(np.float32))
    dc = torch.from_numpy((0.5 * rng.standard_normal(tuple(c.shape))).astype(np.float32))
    return x, w, rk, z, cp, c, hp, dh, dc


@pytest.mark.parametrize("H,IN", SHAPES)
def test_layout_walks_equal_the_plain_versions(H, IN):
    """The walks on the padded ``Rkᵀ`` equal ``lstm_seq_walk_plain`` exactly
    (dz, dh0, dc0) and ``lstm_seq_walk_drk_plain``'s dRk within SUMS; the
    full rung's walk (IN > 0) gives ``lstm_seq_bwd_plain``'s dx, dh0 and dc0
    exactly, and its dRk, dW and db within SUMS."""
    x, w, rk, z, cp, c, hp, dh, dc = _residuals(H, IN)
    rk_t = rk.T.contiguous()
    want = ls.lstm_seq_walk_drk_plain(z, cp, c, hp, dh, dc, rk_t)
    _assert(tc_walk(z, cp, c, dh, dc, rk_t), ls.lstm_seq_walk_plain(z, cp, c, dh, dc, rk_t),
            ("dz", "dh0", "dc0"), EXACT)
    got = tc_walk_drk(z, cp, c, hp, dh, dc, rk_t)
    _assert(got[:3], want[:3], ("dz", "dh0", "dc0"), EXACT)
    _assert(got[3:], want[3:], ("drk",), SUMS)
    if IN:
        res = (z, cp, c, hp, x, dh, dc, rk_t, w.T.contiguous())
        got, want = tc_bwd(*res), ls.lstm_seq_bwd_plain(*res)
        _assert(got[:3], want[:3], ("dx", "dh0", "dc0"), EXACT)
        _assert(got[3:4], want[3:4], ("drk",), BF16_STEP)
        _assert(got[4:], want[4:], ("dw", "db"), SUMS)


def _route(p, x, h0, c0, fusion):
    """h_seq, h_T, c_T and the six gradients of the port's
    ``lstm_sequence(backend="pallas", compute_dtype=bf16)`` on the CPU."""
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0, backend="pallas",
                                         compute_dtype=torch.bfloat16, fusion=fusion)
    _loss(th, thT, tcT, torch).backward()
    grads = {**{k: v.grad.numpy() for k, v in tp.items()}, "x": tx.grad.numpy(),
             "h0": th0.grad.numpy(), "c0": tc0.grad.numpy()}
    return [a.detach().numpy() for a in (th, thT, tcT)], grads


def _loss(h, hT, cT, lib):
    return lib.sum(h ** 2 * lib.cos(lib.arange(h.shape[-1]))) + lib.sum(cT * hT)


@pytest.mark.parametrize("fusion", [(True, True, True), (True, False, False)],
                         ids=["TTT", "TFF"])
def test_layout_route_matches_jax(monkeypatch, fusion):
    """``lstm_sequence(backend="pallas", compute_dtype=bf16)`` with each
    plain version replaced by its layout twin above, at the rung JAX
    ``auto`` writes below (T, T, T) and above (T, F, F) the drk ceiling,
    H=88, IN=88 (the corpus width), B=6, T=4: h_seq, h_T, c_T and the six
    gradients equal the plain route's within GRAD, and match the JAX
    package's ``lstm_sequence(backend="pallas", compute_dtype=bf16)`` (its
    Pallas kernels in interpret mode): forward within FWD, gradients within
    1e-2 relative Frobenius. At this width a few bf16 dz land on the other
    neighbour in JAX's fused walk and move their rows' earlier steps (up to
    3e-4 relative Frobenius, the plain route's own gap), the bound
    ``tests/test_torch_lstm_seq.py`` holds the walks to."""
    H, IN, B, T = 88, 88, 6, 4
    rng = np.random.default_rng(7 + fusion[1])
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    p = {"kernel": f(IN, 4 * H, scale=0.2), "recurrent_kernel": f(H, 4 * H, scale=0.2),
         "bias": f(4 * H, scale=0.3)}
    x, h0, c0 = f(B, T, IN), f(B, H, scale=0.5), f(B, H, scale=0.5)

    def jax_loss(p, x, h0, c0):
        h, (hT, cT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas",
                                          compute_dtype=jnp.bfloat16, fusion=fusion)
        return _loss(h, hT, cT, jnp), (h, hT, cT)

    (_, jout), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(p, x, h0, c0)
    jgrads = {**jg[0], "x": jg[1], "h0": jg[2], "c0": jg[3]}
    plain_out, plain_grads = _route(p, x, h0, c0, fusion)
    for name, fn in (("lstm_seq_fwd_plain", tc_fwd), ("lstm_seq_train_fwd_plain", tc_train_fwd),
                     ("lstm_seq_bwd_plain", tc_bwd), ("lstm_seq_walk_plain", tc_walk),
                     ("lstm_seq_walk_drk_plain", tc_walk_drk)):
        monkeypatch.setattr(ls, name, fn)
    out, grads = _route(p, x, h0, c0, fusion)
    for name, got, plain, ref in zip(("h_seq", "h_T", "c_T"), out, plain_out, jout):
        np.testing.assert_allclose(got, plain, err_msg=name, **EXACT)
        np.testing.assert_allclose(got, np.asarray(ref), err_msg=name, **FWD)
    for k, g in grads.items():
        np.testing.assert_allclose(g, plain_grads[k], err_msg=k, **GRAD)
        r = np.asarray(jgrads[k])
        assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r), k
