"""The port's training-side model pieces vs the JAX package.

Initializers are held by their statistics (the PRNGs differ): shapes equal
to the JAX init, glorot limits and spread, orthogonal recurrent kernels in
float64 to 1e-5, unit forget bias, RandomNormal(0, 0.1) heads within 5% of
their std. Everything else gets the same weights (the JAX init) and the same
NumPy inputs and noise on both sides: values at rtol 1e-5 / atol 1e-6 (f32
products summed in another order); gradients at rtol 2e-4 / atol 1e-5 (BPTT
compounds the reordering, as in ``tests/test_two_cell.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.nn import distributions as jdist
from classifying_vae_lstm_tpu.nn import losses as jloss
from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.nn import distributions as tdist
from classifying_vae_lstm_tpu_torch.nn import losses as tloss
from classifying_vae_lstm_tpu_torch.ops import lstm as tlstm
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
T_ = torch.from_numpy


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or VAL))


def test_init_shapes_and_statistics():
    jcfg = jcl.Config(original_dim=88, intermediate_dim=64, latent_dim=4, seq_length=8,
                      n_classes=5, use_x_prev=True)
    tcfg = tcl.Config(**dataclasses.asdict(jcfg))
    p = tcl.init(torch.Generator().manual_seed(0), tcfg)
    ref = jax.tree.map(lambda a: tuple(a.shape), jcl.init(jax.random.PRNGKey(0), jcfg))
    assert {k: {n: tuple(v.shape) for n, v in d.items()} for k, d in p.items()} == ref
    for name, leaf in (("hW", "kernel"), ("Wargs", "kernel"), ("encoder_h", "kernel"),
                       ("decoder_h", "kernel")):
        k = p[name][leaf]
        limit = np.sqrt(6.0 / (k.shape[0] + k.shape[1]))
        assert k.abs().max().item() <= limit
        assert abs(k.std().item() / (limit / np.sqrt(3)) - 1) < 0.05, name
    H = jcfg.intermediate_dim
    for name in ("encoder_h", "decoder_h"):
        rk = p[name]["recurrent_kernel"].double()
        torch.testing.assert_close(rk @ rk.T, torch.eye(H, dtype=torch.float64), rtol=0,
                                   atol=1e-5)
        bias = p[name]["bias"]
        assert torch.equal(bias[H:2 * H], torch.ones(H))
        assert torch.equal(torch.cat([bias[:H], bias[2 * H:]]), torch.zeros(3 * H))
    heads = torch.cat([p[n]["kernel"].flatten() for n in ("Z_mean", "Z_log_var",
                                                          "X_decoded_mean")])
    assert abs(heads.std().item() / 0.1 - 1) < 0.05
    assert all(not p[n]["bias"].any() for n in ("hW", "Wargs", "Z_mean", "X_decoded_mean"))


def test_losses_and_kl_terms_match_jax():
    rng = np.random.default_rng(0)
    y = (rng.random((4, 5, 12)) < 0.3).astype(np.float32)
    p = rng.random((4, 5, 12)).astype(np.float32)
    p[0, 0, :3] = [0.0, 1.0, 1e-9]  # the Keras clip
    w_true = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    w = rng.random((4, 3)).astype(np.float32) + 0.05
    m, lv = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    for f in ("binary_crossentropy",):
        _close(getattr(tloss, f)(T_(y), T_(p)), getattr(jloss, f)(y, p))
    _close(tloss.categorical_crossentropy(T_(w_true), T_(w)),
           jloss.categorical_crossentropy(w_true, w))
    _close(tloss.vae_loss(T_(y), T_(p), 12), jloss.vae_loss(y, p, 12))
    _close(tloss.kl_loss(T_(m), T_(lv)), jloss.kl_loss(m, lv))
    _close(tdist.gaussian_kl(T_(m), T_(lv)), jdist.gaussian_kl(m, lv))
    for prior in (0.0, -1.5):
        _close(tloss.w_kl_loss(T_(m), T_(lv), prior), jloss.w_kl_loss(m, lv, prior))
        _close(tdist.logistic_normal_kl(T_(m), T_(lv), prior),
               jdist.logistic_normal_kl(m, lv, prior))
    _close(tloss.w_rec_loss(T_(w_true), T_(w), 3), jloss.w_rec_loss(w_true, w, 3))


def test_generator_samplers():
    g = torch.Generator().manual_seed(1)
    m, lv = torch.zeros(20000, 3), torch.full((20000, 3), np.log(4.0))
    z = tdist.sample_gaussian(g, m + 1.0, lv)
    assert abs(z.mean().item() - 1.0) < 0.05 and abs(z.std().item() - 2.0) < 0.05
    w = tdist.sample_logistic_normal(g, m[:5], lv[:5])
    assert w.shape == (5, 4) and torch.allclose(w.sum(-1), torch.ones(5))
    _close(tdist.sample_logistic_normal(g, m[:2], lv[:2], add_noise=False),
           jdist.logistic_normal_from_eps(np.zeros((2, 3), np.float32), np.zeros((2, 3),
                                          np.float32), None, add_noise=False))


def _lstm_problem(seed=0, B=5, T=6, IN=7, H=9):
    rng = np.random.default_rng(seed)
    p = {"kernel": (0.3 * rng.standard_normal((IN, 4 * H))).astype(np.float32),
         "recurrent_kernel": (0.3 * rng.standard_normal((H, 4 * H))).astype(np.float32),
         "bias": (0.3 * rng.standard_normal(4 * H)).astype(np.float32)}
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    h0, c0 = (0.5 * rng.standard_normal((2, B, H))).astype(np.float32)
    return p, x, h0, c0


def test_lstm_sequence_values_and_grads():
    p, x, h0, c0 = _lstm_problem()
    jh, (jhT, jcT) = jlstm.lstm_sequence(p, x, h0, c0)
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tx, th0, tc0 = (T_(a.copy()).requires_grad_(True) for a in (x, h0, c0))
    th, (thT, tcT) = tlstm.lstm_sequence(tp, tx, th0, tc0)
    for got, ref in ((th, jh), (thT, jhT), (tcT, jcT)):
        _close(got, ref)
    # every input's gradient, h0 and c0 included
    (th.square().sum() + tcT.sin().sum()).backward()

    def loss(p, x, h0, c0):
        h, (_, c) = jlstm.lstm_sequence(p, x, h0, c0)
        return jnp.sum(h ** 2) + jnp.sum(jnp.sin(c))

    gp, gx, gh0, gc0 = jax.grad(loss, argnums=(0, 1, 2, 3))(p, x, h0, c0)
    for k in p:
        _close(tp[k].grad, gp[k], **GRAD)
    for got, ref in ((tx.grad, gx), (th0.grad, gh0), (tc0.grad, gc0)):
        _close(got, ref, **GRAD)
    # zero initial state by default
    _close(tlstm.lstm_sequence(tp, tx)[0], jlstm.lstm_sequence(p, x)[0])


def test_lstm_sequence_bf16_operands():
    p, x, h0, c0 = _lstm_problem(seed=1)
    jh, _ = jlstm.lstm_sequence(p, x, h0, c0, compute_dtype=jnp.bfloat16)
    th, _ = tlstm.lstm_sequence(params_from_numpy(p, "cpu"), T_(x), T_(h0), T_(c0),
                                compute_dtype=torch.bfloat16)
    _close(th, jh, rtol=1e-4, atol=1e-5)


def test_lstm_dropout_masks_and_unported_backend():
    g = torch.Generator().manual_seed(2)
    masks = tlstm.keras_lstm_dropout_masks(g, 0.25, 400, 50)
    assert masks.shape == (4, 400, 50)
    assert set(torch.unique(masks).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs((masks > 0).float().mean().item() - 0.75) < 0.01
    p, x, h0, c0 = _lstm_problem()
    h, _ = tlstm.lstm_sequence(params_from_numpy(p, "cpu"), T_(x), dropout=0.5,
                               dropout_generator=g)
    assert h.shape == (5, 6, 9) and torch.isfinite(h).all()
    # the pallas backend runs the whole-sequence kernels' plain versions on
    # the CPU; it refuses dropout masks, and runs every fusion rung: without
    # a gradient each proj rung is the default rung's forward (in either
    # stream mode), as every JAX proj rung shares its primal
    with pytest.raises(ValueError, match="dropout"):
        tlstm.lstm_sequence(params_from_numpy(p, "cpu"), T_(x), backend="pallas", dropout=0.5,
                            dropout_generator=g)
    for dtype in (None, torch.bfloat16):
        run = lambda fusion: tlstm.lstm_sequence(params_from_numpy(p, "cpu"), T_(x),
                                                 backend="pallas", compute_dtype=dtype,
                                                 fusion=fusion)[0]
        torch.testing.assert_close(run((True, False, False)), run(None), rtol=0, atol=0)


def _model_problem(backend, B=6, seed=0):
    jcfg = jcl.Config(original_dim=12, intermediate_dim=16, latent_dim=3, seq_length=5,
                      n_classes=4, use_x_prev=True)
    if backend == "pallas":
        jcfg = dataclasses.replace(jcfg, lstm_backend="pallas", two_cell=True)
    elif backend == "pallas_two_loop":  # the whole-sequence LSTM kernels
        jcfg = dataclasses.replace(jcfg, lstm_backend="pallas", two_cell=False)
    elif backend == "pallas_two_loop_bf16":  # their bf16 streams
        jcfg = dataclasses.replace(jcfg, lstm_backend="pallas", two_cell=False,
                                   bf16_compute=True)
    elif backend == "pallas_bf16":  # the two-cell kernels' bf16 streams
        jcfg = dataclasses.replace(jcfg, lstm_backend="pallas", two_cell=True, bf16_compute=True)
    elif backend == "two_loop":  # remat sends both packages to the two-loop path
        jcfg = dataclasses.replace(jcfg, remat=True)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    D, T, K = jcfg.original_dim, jcfg.seq_length, jcfg.n_classes
    batch = {"x": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "x_prev": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "y": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "w": np.eye(K, dtype=np.float32)[rng.integers(0, K, B)],
             "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, T, jcfg.latent_dim)).astype(np.float32)}
    return jcfg, tcl.Config(**dataclasses.asdict(jcfg)), params, batch


@pytest.mark.parametrize("backend", ["xla", "pallas", "two_loop", "pallas_two_loop",
                                     "pallas_two_loop_bf16", "pallas_bf16"])
def test_apply_and_loss_match_jax(backend):
    jcfg, tcfg, params, batch = _model_problem(backend)
    noise = {k: batch[k] for k in ("eps_w", "eps_z")}
    ref = jcl.apply(params, jcfg, batch["x"], jax.random.PRNGKey(0), batch["x_prev"],
                    noise=noise)
    tp = params_from_numpy(params, "cpu")
    got = tcl.apply(tp, tcfg, T_(batch["x"]), None, T_(batch["x_prev"]),
                    noise={k: T_(v) for k, v in noise.items()})
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])

    weights = (0.5, 0.3, 0.7)  # kl, class, w_kl
    (jtotal, jm), jg = jax.value_and_grad(jcl.loss_and_metrics, has_aux=True)(
        params, jcfg, batch, jax.random.PRNGKey(0), *weights)
    for v in tp.values():
        for leaf in v.values():
            leaf.requires_grad_(True)
    total, metrics = tcl.loss_and_metrics(tp, tcfg, {k: T_(v) for k, v in batch.items()},
                                          None, *weights)
    total.backward()
    assert set(metrics) == set(jm)
    for k in jm:
        _close(metrics[k], jm[k])
    for name, d in jg.items():
        for leaf, g in d.items():
            _close(tp[name][leaf].grad, g, **GRAD)


def test_generator_noise_equals_pre_drawn_noise():
    """apply's own draws are draw_apply_noise's, in order and shape."""
    _, tcfg, params, batch = _model_problem("xla")
    tp = params_from_numpy(params, "cpu")
    x, xp = T_(batch["x"]), T_(batch["x_prev"])
    a = tcl.apply(tp, tcfg, x, torch.Generator().manual_seed(5), xp)
    noise = tcl.draw_apply_noise(torch.Generator().manual_seed(5), tcfg, x.shape[0])
    b = tcl.apply(tp, tcfg, x, None, xp, noise=noise)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_two_loop_pallas_gradients_match_the_two_cell_path():
    """``loss_and_metrics`` gradients on the ``pallas`` two-loop path (the
    whole-sequence kernels' plain versions) against the port's own two-cell
    path, same weights and noise: two routes through the same model."""
    _, tcfg, params, batch = _model_problem("pallas_two_loop", B=7, seed=4)
    grads = {}
    for two_cell in (False, True):
        tp = params_from_numpy(params, "cpu")
        for v in tp.values():
            for leaf in v.values():
                leaf.requires_grad_(True)
        cfg = dataclasses.replace(tcfg, two_cell=two_cell)
        total, _ = tcl.loss_and_metrics(tp, cfg, {k: T_(v) for k, v in batch.items()}, None,
                                        0.5, 0.3, 0.7)
        total.backward()
        grads[two_cell] = (float(total.detach()), {(n, k): v.grad for n, d in tp.items()
                                          for k, v in d.items()})
    np.testing.assert_allclose(grads[False][0], grads[True][0], rtol=1e-5)
    assert set(grads[False][1]) == set(grads[True][1])
    for key, g in grads[False][1].items():
        np.testing.assert_allclose(g.numpy(), grads[True][1][key].numpy(), err_msg=str(key),
                                   **GRAD)


def test_bf16_two_cell_and_two_loop_routes_agree():
    """A bf16 config through the two-cell core and through the two-loop
    path (both plain versions here): the same model, rounded at different
    places (the two-loop path rounds x @ W + b before h @ Rk is added and
    hands the decoder z as a bf16 x stream; the two-cell core rounds z only
    as an operand and W's products not at all), so the loss and gradients
    agree to bf16 precision: the loss within 1e-4 relative, each gradient
    within 1e-2 relative Frobenius (this draw: 4.7e-06 and at most
    5.2e-03)."""
    _, tcfg, params, batch = _model_problem("pallas_bf16", B=7, seed=6)
    out = {}
    for two_cell in (True, False):
        tp = params_from_numpy(params, "cpu")
        for v in tp.values():
            for leaf in v.values():
                leaf.requires_grad_(True)
        cfg = dataclasses.replace(tcfg, two_cell=two_cell)
        total, _ = tcl.loss_and_metrics(tp, cfg, {k: T_(v) for k, v in batch.items()}, None,
                                        0.5, 0.3, 0.7)
        total.backward()
        out[two_cell] = (float(total.detach()), {(n, k): v.grad for n, d in tp.items()
                                                 for k, v in d.items()})
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)
    for key, g in out[True][1].items():
        ref = out[False][1][key]
        rel = ((g - ref).norm() / ref.norm()).item()
        assert rel <= 1e-2, (key, rel)
