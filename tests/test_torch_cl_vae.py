"""The port's cl_vae model functions, checkpoint loading, training forward
and ELBO against the JAX package's, on the three trained cl_vae checkpoints:
``jsball_vae`` (K=10), ``jsbcs_vae`` (K=2) and the vanilla
``jsball_vanilla`` (K=1, no x_prev).

Both sides get the checkpoint's weights and the same NumPy inputs and noise;
the model functions agree within 1e-6 (the same f32 products, another
summation order); the tolerances of ``apply`` and ``loss_and_metrics`` are
stated beside their tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CHECKPOINTS = ("jsball_vae", "jsbcs_vae", "jsball_vanilla")


def _load(name):
    path = f"artifacts/{name}.npz"
    jp, jcfg, jmargs = jcommon.load_model(path, "cl_vae")
    raw, tcfg, tmargs = tcommon.load_model(path, "cl_vae")
    return jp, jcfg, jmargs, raw, tcfg, tmargs


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_load_model_and_config_match_jax(name):
    jp, jcfg, jmargs, raw, tcfg, tmargs = _load(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tmargs == jmargs
    margs = load_model_args(f"artifacts/{name}.npz")
    assert tcommon.cl_vae_config_from_args(margs) == tcfg
    assert tcfg.has_hidden == jcfg.has_hidden
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(len(d) for d in raw.values())
    for path, leaf in flat_j:
        layer, field = (p.key for p in path)
        np.testing.assert_array_equal(raw[layer][field], np.asarray(leaf))


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_model_functions_match_jax(name):
    jp, jcfg, _, raw, tcfg, _ = _load(name)
    tp = params_from_numpy(raw, "cpu")
    rng = np.random.default_rng(0)
    B, D, K, L = 9, tcfg.original_dim, tcfg.n_classes, tcfg.latent_dim
    x = (rng.random((B, D)) < 0.1).astype(np.float32)
    xp = (rng.random((B, D)) < 0.1).astype(np.float32)
    w = rng.dirichlet(np.ones(K), size=B).astype(np.float32)
    z = rng.standard_normal((B, L)).astype(np.float32)
    t = torch.from_numpy
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tvae.encode_w(tp, t(x)), jvae.encode_w(jp, x)):
        assert a.shape == (B, K - 1)
        close(a, b)
    for a, b in zip(tvae.encode_z(tp, tcfg, t(x), t(w)), jvae.encode_z(jp, jcfg, x, w)):
        close(a, b)
    got = tvae.decode(tp, tcfg, t(w), t(z), t(xp) if tcfg.use_x_prev else None)
    close(got, jvae.decode(jp, jcfg, w, z, xp if jcfg.use_x_prev else None))
    assert got.shape == (B, D)


@pytest.mark.parametrize("hidden", [16, 0])
def test_init_matches_jax_layout(hidden):
    """Same layer names and shapes as the JAX init, hidden layers or not, K=1
    included; glorot kernels within their limits, zero biases."""
    for K, use_x_prev in ((3, True), (1, False)):
        kw = dict(original_dim=12, intermediate_dim=hidden, latent_dim=2,
                  intermediate_class_dim=10, n_classes=K, use_x_prev=use_x_prev)
        jp = jvae.init(jax.random.PRNGKey(0), jvae.Config(**kw))
        tp = tvae.init(torch.Generator().manual_seed(0), tvae.Config(**kw))
        shapes = lambda tree: {(a, b): tuple(v.shape) for a, d in tree.items()
                               for b, v in d.items()}
        assert shapes(tp) == shapes(jp)
        for layer in tp.values():
            k = layer["kernel"]
            if k.numel():  # the K=1 model's w heads are [in, 0]
                assert float(k.abs().max()) <= float(np.sqrt(6.0 / sum(k.shape)))
            assert not layer["bias"].any()


# ---- the training forward and the ELBO (apply, loss_and_metrics)
#
# Both routes of the port's apply (plain PyTorch with train_backend "xla",
# the dense-stack kernels' plain versions with "pallas") against the JAX
# loss_and_metrics on the same route, with the batch's eps_w/eps_z: the loss
# and every metric within rtol 1e-5, every parameter gradient within rtol
# 2e-4 / atol 1e-5 (the bounds of tests/test_pallas_vae.py). The vanilla
# checkpoint (K=1) has no kernel route: "pallas" resolves to the plain one.

from classifying_vae_lstm_tpu_torch.ops import vae_dense  # noqa: E402


def _elbo_batch(cfg, B=9, seed=5):
    rng = np.random.default_rng(seed)
    D, K = cfg.original_dim, cfg.n_classes
    return {"x": (rng.random((B, D)) < 0.1).astype(np.float32),
            "x_prev": (rng.random((B, D)) < 0.1).astype(np.float32),
            "y": (rng.random((B, D)) < 0.1).astype(np.float32),
            "w": np.eye(K, dtype=np.float32)[rng.integers(0, K, B)],
            "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
            "eps_z": rng.standard_normal((B, cfg.latent_dim)).astype(np.float32)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", CHECKPOINTS)
def test_loss_and_metrics_and_grads_match_jax(name, backend):
    jp, jcfg, _, raw, tcfg, _ = _load(name)
    jcfg = dataclasses.replace(jcfg, train_backend=backend)
    tcfg = dataclasses.replace(tcfg, train_backend=backend)
    assert vae_dense.should_use(tcfg) == (backend == "pallas" and tcfg.n_classes > 1)
    batch = _elbo_batch(tcfg)
    if not tcfg.use_x_prev:
        del batch["x_prev"]
    weights = (0.7, 0.5, 0.9)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jvae.loss_and_metrics(p, jcfg, batch, jax.random.PRNGKey(0), *weights),
        has_aux=True)(jp)
    tp = params_from_numpy(raw, "cpu")
    for d in tp.values():
        for v in d.values():
            v.requires_grad_(True)
    tl, tm = tvae.loss_and_metrics(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   None, *weights)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tm) == set(jm) == {"loss", "x_decoded_mean_loss", "w_loss", "w2_loss",
                                  "z_args_loss", "w_acc"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if tcfg.n_classes == 1:
        assert float(tm["w_loss"]) == float(tm["w2_loss"]) == 0.0 and float(tm["w_acc"]) == 1.0
    for layer, leaves in jg.items():
        for leaf, g in leaves.items():
            got = tp[layer][leaf].grad
            got = torch.zeros_like(tp[layer][leaf]) if got is None else got  # K=1's empty heads
            np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=2e-4, atol=1e-5,
                                       err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_apply_matches_jax_and_draws_its_noise_in_order(backend):
    """apply on jsball_vae (K=10) against the JAX apply with the same noise;
    draw_apply_noise gives eps_w [B, K-1] then eps_z [B, L], and apply with
    a generator draws exactly those, on either route."""
    jp, jcfg, _, raw, tcfg, _ = _load("jsball_vae")
    tcfg = dataclasses.replace(tcfg, train_backend=backend)
    B = 7
    batch = _elbo_batch(tcfg, B=B, seed=6)
    noise = {"eps_w": batch["eps_w"], "eps_z": batch["eps_z"]}
    ref = jvae.apply(jp, dataclasses.replace(jcfg, train_backend=backend), batch["x"],
                     jax.random.PRNGKey(0), batch["x_prev"], noise=noise)
    tp = params_from_numpy(raw, "cpu")
    t = torch.from_numpy
    got = tvae.apply(tp, tcfg, t(batch["x"]), x_prev=t(batch["x_prev"]),
                     noise={k: t(v) for k, v in noise.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)

    drawn = tvae.draw_apply_noise(torch.Generator().manual_seed(3), tcfg, B)
    g = torch.Generator().manual_seed(3)
    assert drawn["eps_w"].shape == (B, tcfg.n_classes - 1)
    assert drawn["eps_z"].shape == (B, tcfg.latent_dim)
    torch.testing.assert_close(drawn["eps_w"], torch.randn((B, tcfg.n_classes - 1), generator=g))
    torch.testing.assert_close(drawn["eps_z"], torch.randn((B, tcfg.latent_dim), generator=g))
    own = tvae.apply(tp, tcfg, t(batch["x"]), torch.Generator().manual_seed(3), t(batch["x_prev"]))
    given = tvae.apply(tp, tcfg, t(batch["x"]), x_prev=t(batch["x_prev"]), noise=drawn)
    for k in own:
        torch.testing.assert_close(own[k], given[k], rtol=0, atol=0, msg=k)


def test_bf16_plain_route_matches_jax_bf16():
    """bf16 operands with f32 accumulation on the hidden layers and the frame
    head, the heads in f32, on both sides; within the bounds of
    tests/test_pallas_vae.py's bf16 check (rtol 0.05, atol 0.05), and off the
    f32 result (the mode really ran)."""
    jp, jcfg, _, raw, tcfg, _ = _load("jsball_vae")
    jcfg = dataclasses.replace(jcfg, bf16_compute=True)
    tcfg = dataclasses.replace(tcfg, bf16_compute=True)
    batch = _elbo_batch(tcfg, B=16, seed=7)
    noise = {"eps_w": batch["eps_w"], "eps_z": batch["eps_z"]}
    ref = jvae.apply(jp, jcfg, batch["x"], jax.random.PRNGKey(0), batch["x_prev"], noise=noise)
    t = torch.from_numpy
    tp = params_from_numpy(raw, "cpu")
    got = tvae.apply(tp, tcfg, t(batch["x"]), x_prev=t(batch["x_prev"]),
                     noise={k: t(v) for k, v in noise.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0.05, atol=0.05,
                                   err_msg=k)
    f32 = tvae.apply(tp, dataclasses.replace(tcfg, bf16_compute=False), t(batch["x"]),
                     x_prev=t(batch["x_prev"]), noise={k: t(v) for k, v in noise.items()})
    assert (got["x_decoded_mean"] - f32["x_decoded_mean"]).abs().max() > 1e-6
