"""The port's cl_vae model functions and checkpoint loading against the JAX
package's, on the three trained cl_vae checkpoints: ``jsball_vae`` (K=10),
``jsbcs_vae`` (K=2) and the vanilla ``jsball_vanilla`` (K=1, no x_prev).

Both sides get the checkpoint's weights and the same NumPy inputs; the model
functions agree within 1e-6 (the same f32 products, another summation
order).
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
