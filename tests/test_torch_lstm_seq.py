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


def _spy(monkeypatch):
    calls = []
    for name in ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain", "lstm_seq_bwd_plain"):
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


@pytest.mark.parametrize("fusion", [(True, False, False), (False, False, False),
                                    (True, True, False), (False, True, False)])
def test_other_fusion_rungs_raise_naming_the_roadmap(fusion):
    p, x, h0, c0 = _problem(2, 2)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 6"):
        tlstm.lstm_sequence(params_from_numpy(p, "cpu"), t(x), t(h0), t(c0), backend="pallas",
                            fusion=fusion)


def test_bf16_and_the_wide_default_raise_naming_the_roadmap():
    """The default triple equals (True, True, True) spelled out, in f32 and
    in bf16; above the drk ceiling the default drops to the unported
    proj-only rung, which raises in both modes."""
    p, x, h0, c0 = _problem(2, 2)
    t = torch.from_numpy
    tp = params_from_numpy(p, "cpu")
    for dtype in (None, torch.bfloat16):
        a = tlstm.lstm_sequence(tp, t(x), t(h0), t(c0), backend="pallas", compute_dtype=dtype)[0]
        b = tlstm.lstm_sequence(tp, t(x), t(h0), t(c0), backend="pallas", compute_dtype=dtype,
                                fusion=(True, True, True))[0]
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # above the drk ceiling (16·H² > 38 MiB) the default drops to proj-only,
    # a rung that is not ported (a broadcast view: no weights allocated)
    wide = {"kernel": torch.zeros(1, 1).expand(IN, 4 * 1600),
            "recurrent_kernel": torch.zeros(1, 1).expand(1600, 4 * 1600),
            "bias": torch.zeros(4 * 1600)}
    for dtype in (None, torch.bfloat16):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 item 6"):
            tlstm.lstm_sequence(wide, t(x), backend="pallas", compute_dtype=dtype)


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
    assert ls.fwd_smem_bytes(109, 256, 16) == (109 + 768) * 16 * 4
    assert ls.fwd_rows(12800, 106, 256, 132) == 16  # the evaluation shape
    assert ls.fwd_rows(200, 109, 256, 132) == 4     # the training shape
    assert ls.fwd_rows(12800, 106, 2048, 132) == 4  # a 16-row tile no longer fits
    assert ls.bwd_smem_bytes(256) <= ls._SMEM_LIMIT < ls.bwd_smem_bytes(4096)
