"""The port's whole-sequence LSTM (plain versions) vs the JAX package.

``ops/lstm_seq.py`` holds the plain forward, training forward and backward
that the CUDA kernels of ``csrc/lstm_seq.cu`` are held against on the card;
here, on the CPU, the port's ``lstm_sequence(backend="pallas")`` (the
plain versions behind its ``torch.autograd.Function``) is held against the
JAX package's ``lstm_sequence(backend="pallas")`` (its Pallas kernels in
interpret mode, as ``tests/test_pallas_lstm.py`` runs them), and each plain
kernel function against the JAX core it replaces, with the JAX lane padding
sliced off. Same NumPy inputs on both sides: an input width (12) that is not
a multiple of 128, nonzero h0/c0, and a loss with a cotangent on c_T.

Tolerances: forward values within 1e-5 absolute (the same f32 products,
summed in another order); gradients rtol 1e-4 / atol 1e-5 (BPTT compounds
the reordering; the bound of ``test_fused_bwd_full_matches_xla``).

The bf16 stream mode (``compute_dtype=bfloat16``) is held to the same
bounds: both sides round the same values at the same places and sum the
bf16-valued products in f32, so they part only where an f32 sum taken in
another order lands on the other side of a bf16 rounding boundary.

Every other fusion rung (proj, drk, full) that ``resolve_fusion`` returns is
held against its own JAX rung, in f32 and bf16, to the same bounds: in bf16
the rungs round at different points (db sums the rounded dz stream at the
non-full rungs, dW is rounded at the unfused ones), gaps of 3e-4 to 3.4e-3
between rungs, so no rung stands in for another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu.ops import pallas_lstm as jpl
from classifying_vae_lstm_tpu_torch.ops import lstm as tlstm
from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
IN, H = 12, 16


def _problem(B, T, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    p = {"kernel": f(IN, 4 * H, scale=0.3), "recurrent_kernel": f(H, 4 * H, scale=0.3),
         "bias": f(4 * H, scale=0.3)}
    return p, f(B, T, IN), f(B, H, scale=0.5), f(B, H, scale=0.5)


def _loss(h, hT, cT, lib):
    """``test_fused_bwd_full_matches_xla``'s loss: every step's h, and both
    final states (a cotangent on c_T)."""
    return lib.sum(h ** 2 * lib.cos(lib.arange(h.shape[-1]))) + lib.sum(cT * hT)


CASES = [(B, T) for T in (1, 5) for B in (3, 8)]


@pytest.mark.parametrize("B,T", CASES)
def test_lstm_sequence_matches_jax(B, T):
    """Forward h_seq, h_T, c_T and the gradients of x, kernel, bias,
    recurrent_kernel, h0 and c0."""
    p, x, h0, c0 = _problem(B, T, seed=B + T)
    jh, (jhT, jcT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas")
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0, backend="pallas")
    for name, got, ref in (("h_seq", th, jh), ("h_T", thT, jhT), ("c_T", tcT, jcT)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=name, **FWD)
    _loss(th, thT, tcT, torch).backward()

    def loss(p, x, h0, c0):
        h, (hT, cT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas")
        return _loss(h, hT, cT, jnp)

    gp, gx, gh0, gc0 = jax.grad(loss, argnums=(0, 1, 2, 3))(p, x, h0, c0)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), err_msg=k, **GRAD)
    for name, got, ref in (("x", tx, gx), ("h0", th0, gh0), ("c0", tc0, gc0)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), err_msg=name, **GRAD)


@pytest.mark.parametrize("B,T", [(3, 5), (8, 1)])
def test_bf16_lstm_sequence_matches_jax(B, T):
    """The bf16 stream mode: forward h_seq, h_T, c_T and the six gradients
    against JAX's ``lstm_sequence(backend="pallas",
    compute_dtype=jnp.bfloat16)``. The gradients of x and the recurrent
    kernel are bf16-valued (cast outside the core), the kernel's is not
    (W enters the core in f32)."""
    p, x, h0, c0 = _problem(B, T, seed=20 + B + T)
    bf = jnp.bfloat16
    jh, (jhT, jcT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas", compute_dtype=bf)
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0, backend="pallas",
                                         compute_dtype=torch.bfloat16)
    for name, got, ref in (("h_seq", th, jh), ("h_T", thT, jhT), ("c_T", tcT, jcT)):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=name, **FWD)
    _loss(th, thT, tcT, torch).backward()

    def loss(p, x, h0, c0):
        h, (hT, cT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas", compute_dtype=bf)
        return _loss(h, hT, cT, jnp)

    gp, gx, gh0, gc0 = jax.grad(loss, argnums=(0, 1, 2, 3))(p, x, h0, c0)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), err_msg=k, **GRAD)
    for name, got, ref in (("x", tx, gx), ("h0", th0, gh0), ("c0", tc0, gc0)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), err_msg=name, **GRAD)
    representable = lambda g: torch.equal(g, g.bfloat16().float())
    assert representable(tp["recurrent_kernel"].grad) and representable(tx.grad)
    assert not representable(tp["kernel"].grad) and not representable(tp["bias"].grad)


def _jax_inputs(p, x, h0, c0):
    """The lane-padded operands ``lstm_sequence_pallas`` hands its cores."""
    INp = 128
    x_t = np.pad(np.swapaxes(x, 0, 1), ((0, 0), (0, 0), (0, INp - IN)))
    w = np.pad(p["kernel"], ((0, INp - IN), (0, 0)))
    return x_t, w, p["bias"].reshape(1, -1), p["recurrent_kernel"], h0, c0


@pytest.mark.parametrize("B", [3, 8])
def test_plain_kernel_functions_match_the_jax_cores(B):
    """``lstm_seq_fwd_plain`` / ``lstm_seq_train_fwd_plain`` /
    ``lstm_seq_bwd_plain`` against ``_forward_kernel_call_fp`` /
    ``_forward_train_call_fp`` / ``_backward_call_full``."""
    T = 5
    p, x, h0, c0 = _problem(B, T, seed=11)
    jins = _jax_inputs(p, x, h0, c0)
    t = torch.from_numpy
    tins = (t(np.ascontiguousarray(np.swapaxes(x, 0, 1))), t(p["kernel"]), t(p["bias"]),
            t(p["recurrent_kernel"]), t(h0), t(c0))

    ref = jpl._forward_kernel_call_fp(*jins)
    for name, got, r in zip(("h", "c"), ls.lstm_seq_fwd_plain(*tins), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), err_msg=name, **FWD)
    ref = jpl._forward_train_call_fp(*jins)
    got = ls.lstm_seq_train_fwd_plain(*tins)
    for name, g, r in zip(("h", "c", "z", "h_prev", "c_prev"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **FWD)

    h, c, z, hp, cp = (np.array(r) for r in ref)  # writable copies for torch
    rng = np.random.default_rng(12)
    dh = rng.standard_normal(h.shape).astype(np.float32)
    dc = (0.5 * rng.standard_normal(c.shape)).astype(np.float32)
    rk_t, w_t = p["recurrent_kernel"].T, jins[1].T
    jout = jpl._backward_call_full(z, cp, c, hp, jins[0], dh, dc, rk_t, w_t)
    tout = ls.lstm_seq_bwd_plain(t(z), t(cp), t(c), t(hp), tins[0], t(dh), t(dc),
                                 t(np.ascontiguousarray(rk_t)),
                                 t(np.ascontiguousarray(w_t[:, :IN])))
    jdx, jdh0, jdc0, jdrk, jdw, jdb = (np.asarray(r) for r in jout)
    for name, g, r in (("dx", tout[0], jdx[..., :IN]), ("dh0", tout[1], jdh0),
                       ("dc0", tout[2], jdc0), ("drk", tout[3], jdrk),
                       ("dw", tout[4], jdw[:IN]), ("db", tout[5], jdb[0])):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **GRAD)


def test_bf16_plain_kernel_functions_match_the_jax_cores():
    """The bf16 plain versions against ``_forward_kernel_call_fp`` /
    ``_forward_train_call_fp`` / ``_backward_call_full`` fed bf16 x, Rk, z,
    h_prev and Rkᵀ/Wᵀ and f32 W (rounded inside, as the core casts it):
    same values and the same output types (z, h_prev, dx and dRk bf16; dW
    and db f32 and not rounded)."""
    B, T = 5, 4
    p, x, h0, c0 = _problem(B, T, seed=31)
    bf = jnp.bfloat16
    jx, jw, jb, jrk, jh0, jc0 = _jax_inputs(p, x, h0, c0)
    jx, jrk = jnp.asarray(jx, bf), jnp.asarray(jrk, bf)
    t = torch.from_numpy
    tx = t(np.ascontiguousarray(np.swapaxes(x, 0, 1))).bfloat16()
    trk = t(p["recurrent_kernel"]).bfloat16()
    tins = (tx, t(p["kernel"]), t(p["bias"]), trk, t(h0), t(c0))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))

    ref = jpl._forward_kernel_call_fp(jx, jw, jb, jrk, jh0, jc0)
    for name, got, r in zip(("h", "c"), ls.lstm_seq_fwd_plain(*tins), ref):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), f32(r), err_msg=name, **FWD)
    ref = jpl._forward_train_call_fp(jx, jw, jb, jrk, jh0, jc0)
    got = ls.lstm_seq_train_fwd_plain(*tins)
    for name, g, r in zip(("h", "c", "z", "h_prev", "c_prev"), got, ref):
        want = torch.bfloat16 if name in ("z", "h_prev") else torch.float32
        assert g.dtype == want and r.dtype == (bf if want == torch.bfloat16 else jnp.float32)
        np.testing.assert_allclose(g.float().numpy(), f32(r), err_msg=name, **FWD)

    h, c, z, hp, cp = ref
    rng = np.random.default_rng(32)
    dh = rng.standard_normal(h.shape).astype(np.float32)
    dc = (0.5 * rng.standard_normal(c.shape)).astype(np.float32)
    jout = jpl._backward_call_full(z, cp, c, hp, jx, dh, dc, jrk.T, jnp.asarray(jw.T, bf))
    tz, thp = (t(np.array(f32(a))).bfloat16() for a in (z, hp))
    tout = ls.lstm_seq_bwd_plain(tz, t(np.array(cp)), t(np.array(c)), thp, tx, t(dh), t(dc),
                                 trk.T.contiguous(), t(np.ascontiguousarray(p["kernel"].T)))
    jdx, jdh0, jdc0, jdrk, jdw, jdb = (f32(r) for r in jout)
    for name, g, r in (("dx", tout[0], jdx[..., :IN]), ("dh0", tout[1], jdh0),
                       ("dc0", tout[2], jdc0), ("drk", tout[3], f32(jnp.asarray(jdrk, bf))),
                       ("dw", tout[4], jdw[:IN]), ("db", tout[5], jdb[0])):
        assert g.shape == r.shape, name
        want = torch.bfloat16 if name in ("dx", "drk") else torch.float32
        assert g.dtype == want, name
        np.testing.assert_allclose(g.float().numpy(), r, err_msg=name, **GRAD)
    # the core (``_core_fp_bwd``) rounds the kernel's f32 dRk sum to bf16, as
    # the plain version returns it; dW keeps its f32 sum
    assert not torch.equal(tout[4], tout[4].bfloat16().float())


RUNGS = [(True, True, False), (True, False, False), (False, True, False), (False, False, False)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("fusion", RUNGS, ids=lambda f: "".join("TF"[not v] for v in f))
def test_fusion_rungs_match_jax(fusion, bf16):
    """Each rung other than the default, f32 and bf16: forward h_seq, h_T,
    c_T and the six gradients against JAX's ``lstm_sequence(backend="pallas",
    fusion=...)``. In bf16 the representability of each gradient is JAX's:
    dRk and dx bf16-valued at every rung, dW exactly at the unfused rungs
    (autograd of the hoisted bf16 projection rounds it), db never (the f32
    sum of the rounded dz stream)."""
    B, T = 5, 4
    p, x, h0, c0 = _problem(B, T, seed=40 + 2 * RUNGS.index(fusion) + bf16)
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jh, (jhT, jcT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas", compute_dtype=jcd,
                                         fusion=fusion)
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0, backend="pallas", compute_dtype=tcd,
                                         fusion=fusion)
    for name, got, ref in (("h_seq", th, jh), ("h_T", thT, jhT), ("c_T", tcT, jcT)):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), err_msg=name, **FWD)
    _loss(th, thT, tcT, torch).backward()

    def loss(p, x, h0, c0):
        h, (hT, cT) = jlstm.lstm_sequence(p, x, h0, c0, backend="pallas", compute_dtype=jcd,
                                          fusion=fusion)
        return _loss(h, hT, cT, jnp)

    gp, gx, gh0, gc0 = jax.grad(loss, argnums=(0, 1, 2, 3))(p, x, h0, c0)
    got = {**{k: v.grad for k, v in tp.items()}, "x": tx.grad, "h0": th0.grad, "c0": tc0.grad}
    ref = {**gp, "x": gx, "h0": gh0, "c0": gc0}
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]), err_msg=k, **GRAD)
    if bf16:
        representable = lambda g: torch.equal(g, g.bfloat16().float())
        assert representable(got["recurrent_kernel"]) and representable(got["x"])
        assert representable(got["kernel"]) == (not fusion[0])
        assert not representable(got["bias"])
        for k, g in got.items():  # the same pattern as JAX's own gradients
            r = torch.from_numpy(np.array(ref[k], np.float32))
            assert representable(g) == representable(r), k


def _rung_cores(bf16):
    """The unfused rungs' operands: xz as ``lstm_sequence_pallas`` hoists it
    (bf16: the product of the rounded operands plus b, rounded once), Rk,
    h0, c0, on both sides."""
    B, T = 5, 4
    p, x, h0, c0 = _problem(B, T, seed=51)
    x_t = np.ascontiguousarray(np.swapaxes(x, 0, 1))
    t = torch.from_numpy
    tins = ls._hoisted_projection(t(x), params_from_numpy(p, "cpu"), bf16)
    sd = torch.bfloat16 if bf16 else torch.float32
    tins = (tins, t(p["recurrent_kernel"]).to(sd), t(h0), t(c0))
    if bf16:
        bf = jnp.bfloat16
        xz = (jnp.dot(jnp.asarray(x_t, bf), jnp.asarray(p["kernel"], bf),
                      preferred_element_type=jnp.float32) + p["bias"]).astype(bf)
        jins = (xz, jnp.asarray(p["recurrent_kernel"], bf), h0, c0)
    else:
        xz = jnp.dot(x_t, p["kernel"], precision="highest") + p["bias"]
        jins = (xz, p["recurrent_kernel"], h0, c0)
    return jins, tins


def _jax_walk_loop(z, cp, c, hp, dh_seq, dc_seq, rk_t):
    """The body of ``_lstm_bwd_kernel_drk`` (``_lstm_bwd_kernel`` without
    its dRk sum) as a plain JAX loop, one op at a time, so nothing is fused:
    per step in reverse ``_bwd_gate_grads``, dz stored at z's type, ``dh = dz
    @ Rkᵀ`` and ``dRk += h_prev[t]ᵀ dz`` over operands at Rkᵀ's type, summed
    in f32."""
    f32 = jnp.float32
    wt = rk_t.dtype
    prec = "highest" if wt == f32 else None
    T, B, H = c.shape
    dh, dc = jnp.zeros((B, H), f32), jnp.zeros((B, H), f32)
    drk = jnp.zeros((H, 4 * H), f32)
    dzs = [None] * T
    for t in reversed(range(T)):
        dz, dc = jpl._bwd_gate_grads(z[t].astype(f32), c[t], cp[t], dh + dh_seq[t],
                                     dc + dc_seq[t])
        dzs[t] = dz.astype(z.dtype)
        dh = jnp.dot(dz.astype(wt), rk_t, preferred_element_type=f32, precision=prec)
        drk = drk + jax.lax.dot_general(hp[t].astype(wt), dz.astype(wt), (((0,), (0,)), ((), ())),
                                        preferred_element_type=f32, precision=prec)
    return jnp.stack(dzs), dh, dc, drk


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_other_rung_plain_functions_match_the_jax_cores(bf16):
    """``lstm_seq_xz_fwd_plain`` / ``lstm_seq_xz_train_fwd_plain`` /
    ``lstm_seq_walk_plain`` / ``lstm_seq_walk_drk_plain`` against
    ``_forward_kernel_call`` / ``_forward_train_call`` / ``_backward_call``
    / ``_backward_call_drk``, with the same output types (z and dz at the
    stream type; h, c, dh0, dc0 and dRk f32). The walks' outputs in bf16
    within 1e-2 relative Frobenius (the card's bf16 backward bound): the
    interpret-mode kernel fuses the gate math with other f32 roundings, a
    few dz land on the other bf16 neighbour, and each such flip moves its
    row's earlier steps through the dh carry (8e-4 at this seed); in f32
    within ``GRAD``. The walks are also held, in f32 and bf16, against the
    same body as a plain JAX loop (:func:`_jax_walk_loop`), which rounds
    where the kernel does without fusing: every output within ``GRAD`` (the
    f32 sums are taken in another order) and, in bf16, dz exactly."""
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    t = lambda a: torch.from_numpy(np.array(f32(a)))
    jins, tins = _rung_cores(bf16)
    np.testing.assert_array_equal(tins[0].float().numpy(), f32(jins[0]))  # the same xz
    sd, jsd = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    B = jins[2].shape[0]
    ref = jpl._forward_kernel_call(*jins, block_b=B)
    for name, got, r in zip(("h", "c"), ls.lstm_seq_xz_fwd_plain(*tins), ref):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), f32(r), err_msg=name, **FWD)
    ref = jpl._forward_train_call(*jins)
    got = ls.lstm_seq_xz_train_fwd_plain(*tins)
    for name, g, r in zip(("h", "c", "z"), got, ref):
        want = sd if name == "z" else torch.float32
        assert g.dtype == want and r.dtype == (jsd if name == "z" else jnp.float32), name
        np.testing.assert_allclose(g.float().numpy(), f32(r), err_msg=name, **FWD)

    h, c, z = ref
    h0, c0 = jins[2], jins[3]
    cp = jnp.concatenate([c0[None], c[:-1]])
    hp = jnp.concatenate([h0[None], h[:-1]]).astype(z.dtype)
    rng = np.random.default_rng(52)
    dh = rng.standard_normal(h.shape).astype(np.float32)
    dc = (0.5 * rng.standard_normal(c.shape)).astype(np.float32)
    rk_t = jins[1].T
    jwalk = jpl._backward_call(z, cp, c, dh, dc, rk_t)
    jdrk = jpl._backward_call_drk(z, cp, c, hp, dh, dc, rk_t)
    tz, thp, trk_t = t(z).to(sd), t(hp).to(sd), tins[1].T.contiguous()
    twalk = ls.lstm_seq_walk_plain(tz, t(cp), t(c), t(dh), t(dc), trk_t)
    tdrk = ls.lstm_seq_walk_drk_plain(tz, t(cp), t(c), thp, t(dh), t(dc), trk_t)
    for label, jout, tout in (("walk", jwalk, twalk), ("drk walk", jdrk, tdrk)):
        for name, g, r in zip(("dz", "dh0", "dc0", "drk"), tout, jout):
            want = sd if name == "dz" else torch.float32
            assert g.dtype == want and g.shape == r.shape, f"{label} {name}"
            g, r = g.float().numpy(), f32(r)
            if bf16:
                assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r), f"{label} {name}"
            else:
                np.testing.assert_allclose(g, r, err_msg=f"{label} {name}", **GRAD)
    # both walks run the same reverse walk: dz, dh0 and dc0 agree exactly
    for g, r in zip(twalk, tdrk):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    loop = _jax_walk_loop(z, cp, c, hp, dh, dc, rk_t)
    for name, g, r in zip(("dz", "dh0", "dc0", "drk"), tdrk, loop):
        assert g.shape == r.shape and g.dtype == (sd if name == "dz" else torch.float32), name
        np.testing.assert_allclose(g.float().numpy(), f32(r), err_msg=name, **GRAD)
    if bf16:  # the rounded dz stream: every value on the same bf16 neighbour
        np.testing.assert_array_equal(tdrk[0].float().numpy(), f32(loop[0]))


def _spy(monkeypatch):
    calls = []
    for name in ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain", "lstm_seq_bwd_plain",
                 "lstm_seq_xz_fwd_plain", "lstm_seq_xz_train_fwd_plain", "lstm_seq_walk_plain",
                 "lstm_seq_walk_drk_plain"):
        real = getattr(ls, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(ls, name, spy)
    return calls


def test_grad_mode_routing(monkeypatch):
    """Recording autograd with an input that needs a gradient runs the
    training forward and, on backward, the backward; ``no_grad`` or inputs
    without gradients run the inference forward alone. On CPU tensors no
    kernel launches."""
    calls = _spy(monkeypatch)
    counts = (ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES, ls.BWD_LAUNCHES)
    p, x, h0, c0 = _problem(4, 3)
    tp = params_from_numpy(p, "cpu")
    run = lambda xx: ls.lstm_sequence_kernel(tp, xx, torch.from_numpy(h0), torch.from_numpy(c0))
    run(torch.from_numpy(x))
    assert calls == ["lstm_seq_fwd_plain"]
    tx = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        run(tx)
    assert calls == ["lstm_seq_fwd_plain"] * 2
    h, (hT, cT) = run(tx)
    assert calls[2:] == ["lstm_seq_train_fwd_plain"]
    (h.sum() + cT.sum()).backward()
    assert calls[2:] == ["lstm_seq_train_fwd_plain", "lstm_seq_bwd_plain"]
    assert tx.grad is not None and tx.grad.shape == tx.shape
    assert (ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES, ls.BWD_LAUNCHES) == counts


ROUTES = {  # rung -> (the inference forward, the training forward, the backward)
    (True, True, False): ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain",
                          "lstm_seq_walk_drk_plain"),
    (True, False, False): ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain",
                           "lstm_seq_walk_plain"),
    (False, True, False): ("lstm_seq_xz_fwd_plain", "lstm_seq_xz_train_fwd_plain",
                           "lstm_seq_walk_drk_plain"),
    (False, False, False): ("lstm_seq_xz_fwd_plain", "lstm_seq_xz_train_fwd_plain",
                            "lstm_seq_walk_plain"),
}


@pytest.mark.parametrize("fusion", RUNGS, ids=lambda f: "".join("TF"[not v] for v in f))
def test_rung_routing(monkeypatch, fusion):
    """Each rung runs its own kernels' plain versions: ``no_grad`` the
    inference forward alone (every proj rung shares the default rung's, as
    every JAX proj rung shares its primal), with a gradient the training
    forward and, on backward, the rung's walk; no launch on CPU tensors."""
    calls = _spy(monkeypatch)
    counts = {n: getattr(ls, n) for n in dir(ls) if n.endswith("_LAUNCHES")}
    p, x, h0, c0 = _problem(4, 3)
    tp = params_from_numpy(p, "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    run = lambda: ls.lstm_sequence_kernel(tp, tx, torch.from_numpy(h0), torch.from_numpy(c0),
                                          fusion=fusion)
    with torch.no_grad():
        run()
    h, (hT, cT) = run()
    (h.sum() + cT.sum()).backward()
    assert calls == list(ROUTES[fusion])
    assert tx.grad is not None and tx.grad.shape == tx.shape
    assert {n: getattr(ls, n) for n in counts} == counts
    assert not hasattr(ls, "FUSION_TODO")


def test_bf16_and_the_wide_default_raise_naming_the_roadmap(monkeypatch):
    """The default triple equals (True, True, True) spelled out, in f32 and
    in bf16; above the drk ceiling (16·H² > 38 MiB, H >= 1,579) the default
    drops to the proj-only rung (T, F, F), which the JAX package's
    ``--lstm_backend auto`` pins into args.json there: at H=1,600 it runs
    its training forward and dz-only walk in both modes (zero weights as
    broadcast views: nothing H-sized is allocated up front)."""
    p, x, h0, c0 = _problem(2, 2)
    t = torch.from_numpy
    tp = params_from_numpy(p, "cpu")
    for dtype in (None, torch.bfloat16):
        a = tlstm.lstm_sequence(tp, t(x), t(h0), t(c0), backend="pallas", compute_dtype=dtype)[0]
        b = tlstm.lstm_sequence(tp, t(x), t(h0), t(c0), backend="pallas", compute_dtype=dtype,
                                fusion=(True, True, True))[0]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    W = 1600
    assert tlstm.resolve_fusion(None, hidden_dim=W) == (True, False, False)
    calls = _spy(monkeypatch)
    for dtype in (None, torch.bfloat16):
        zero = torch.zeros(1, 1, requires_grad=True)
        wide = {"kernel": zero.expand(IN, 4 * W), "recurrent_kernel": zero.expand(W, 4 * W),
                "bias": torch.zeros(4 * W)}
        h, (hT, cT) = tlstm.lstm_sequence(wide, t(x), backend="pallas", compute_dtype=dtype)
        assert h.shape == (2, 2, W) and not h.any() and not cT.any()  # zero weights: h = c = 0
        (h.sum() + cT.sum()).backward()
        assert zero.grad is not None and torch.isfinite(zero.grad).all()
    assert calls == ["lstm_seq_train_fwd_plain", "lstm_seq_walk_plain"] * 2


def test_pallas_backend_refuses_dropout_and_remat():
    p, x, _, _ = _problem(2, 2)
    tp, tx = params_from_numpy(p, "cpu"), torch.from_numpy(x)
    with pytest.raises(ValueError, match="dropout"):
        tlstm.lstm_sequence(tp, tx, backend="pallas", dropout=0.5,
                            dropout_generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat"):
        tlstm.lstm_sequence(tp, tx, backend="pallas", remat=True)
    # dropout without a generator is inert on both backends, as in JAX
    torch.testing.assert_close(tlstm.lstm_sequence(tp, tx, backend="pallas", dropout=0.5)[0],
                               tlstm.lstm_sequence(tp, tx)[0], rtol=0, atol=1e-6)


def test_shared_memory_formulas():
    # the f32 forward: the resident slice [kx + kh][4 nu] and the ring, 3
    # stages of a 64-row tile's operand chunk [rows][36] (8 of a 16-row
    # tile's, + the streamed slice's [32][4 nu])
    assert ls.fwd_smem_bytes(32, 4, 128, 256, True) == (384 * 128 + 3 * 64 * 36) * 4
    assert ls.fwd_smem_bytes(32, 1, 128, 256, False) == 8 * (16 * 36 + 32 * 128) * 4
    assert ls.fwd_plan(12800, 106, 256, 132)["rt"] == 4  # the evaluation shape
    assert ls.fwd_plan(200, 109, 256, 132)["rt"] == 1    # the training shape
    assert not ls.fwd_plan(12800, 106, 2048, 132)["resident"]  # the slice streams
    for H in (2048, 2560):  # the xz forwards at the widths the bf16 rungs reach, in f32
        p = ls.fwd_plan(1024, 0, H, 132)
        assert ls.fwd_smem_bytes(p["nu"], p["rt"], 0, p["kh"], p["resident"]) <= ls._SMEM_LIMIT


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_walks_take_the_transposed_view_of_rk(bf16):
    """The cores hand the walks ``rk.T``, a view of Rk as stored (the f32
    kernel reads Rk [H, 4H] without a copy): on the CPU both walks give the
    same results from that view as from ``rk.T.contiguous()``."""
    rng = np.random.default_rng(61)
    T, B, Hh = 3, 5, 7
    f = lambda *s, scale=1.0: torch.from_numpy((scale * rng.standard_normal(s)).astype(np.float32))
    sd = torch.bfloat16 if bf16 else torch.float32
    z, hp = f(T, B, 4 * Hh).to(sd), f(T, B, Hh, scale=0.5).to(sd)
    cp, c, dh, dc = (f(T, B, Hh, scale=0.5) for _ in range(4))
    rk = f(Hh, 4 * Hh, scale=0.3).to(sd)
    view, copy = rk.T, rk.T.contiguous()
    assert not view.is_contiguous() and view.T.data_ptr() == rk.data_ptr()
    for got, want in ((ls.lstm_seq_walk(z, cp, c, dh, dc, view),
                       ls.lstm_seq_walk(z, cp, c, dh, dc, copy)),
                      (ls.lstm_seq_walk_drk(z, cp, c, hp, dh, dc, view),
                       ls.lstm_seq_walk_drk(z, cp, c, hp, dh, dc, copy))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
