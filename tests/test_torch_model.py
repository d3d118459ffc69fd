"""Port's cl_vrnn building blocks vs the JAX package, at f32 tolerance.

Same weights (the JAX init, or the trained ``artifacts/jsball_vrnn4``
checkpoint) and the same inputs from ``np.random.default_rng`` on both sides.
Tolerance rtol 1e-5, atol 1e-6: both compute f32 products (the JAX side at
``precision='highest'``) and only the summation order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.nn import core as jcore
from classifying_vae_lstm_tpu.nn import distributions as jdist
from classifying_vae_lstm_tpu.ops import lstm as jlstm
from classifying_vae_lstm_tpu.sampling import generate as jgen
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.nn import core as tcore
from classifying_vae_lstm_tpu_torch.nn import distributions as tdist
from classifying_vae_lstm_tpu_torch.ops import lstm as tlstm
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.train.checkpoint import load_checkpoint
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(t, j):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), **TOL)


def _model(which):
    if which == "jsball_vrnn4":
        import json

        with open("artifacts/jsball_vrnn4.json") as f:
            margs = json.load(f)
        jcfg = jcl.Config(original_dim=margs["original_dim"],
                          intermediate_dim=margs["intermediate_dim"],
                          latent_dim=margs["latent_dim"], seq_length=margs["seq_length"],
                          n_classes=margs["n_classes"], use_x_prev=margs["use_x_prev"])
        params = load_checkpoint("artifacts/jsball_vrnn4.npz")
    else:
        jcfg = jcl.Config(original_dim=12, intermediate_dim=16, latent_dim=3, seq_length=4,
                          n_classes=4, use_x_prev=True)
        params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, params, tcl.Config(**dataclasses.asdict(jcfg)), params_from_numpy(params, "cpu")


def test_hard_sigmoid_and_dense():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)).astype(np.float32) * 4
    _close(tcore.hard_sigmoid(torch.from_numpy(x)), jcore.hard_sigmoid(x))
    p = {"kernel": rng.standard_normal((7, 3)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    _close(tcore.dense(params_from_numpy(p, "cpu"), torch.from_numpy(x), torch.sigmoid),
           jcore.dense(p, x, jax.nn.sigmoid))


def test_lstm_step():
    rng = np.random.default_rng(1)
    B, IN, H = 4, 6, 5
    p = {"kernel": rng.standard_normal((IN, 4 * H)).astype(np.float32),
         "recurrent_kernel": rng.standard_normal((H, 4 * H)).astype(np.float32),
         "bias": rng.standard_normal(4 * H).astype(np.float32)}
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((B, IN), (B, H), (B, H)))
    th, tc = tlstm.lstm_step(params_from_numpy(p, "cpu"), *map(torch.from_numpy, (x, h, c)))
    jh, jc = jlstm.lstm_step(p, x, h, c)
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("which", ["small", "jsball_vrnn4"])
def test_step_functions(which):
    jcfg, params, tcfg, tparams = _model(which)
    rng = np.random.default_rng(2)
    B, D, H, L, K = 5, jcfg.original_dim, jcfg.intermediate_dim, jcfg.latent_dim, jcfg.n_classes
    win = (rng.random((B, jcfg.seq_length, D)) < 0.2).astype(np.float32)
    x = (rng.random((B, D)) < 0.2).astype(np.float32)
    w = np.array(jax.nn.softmax(rng.standard_normal((B, K)).astype(np.float32)))
    h, c = rng.standard_normal((2, B, H)).astype(np.float32) * 0.5
    z = rng.standard_normal((B, L)).astype(np.float32)
    T = torch.from_numpy
    for got, ref in zip(tcl.encode_w(tparams, tcfg, T(win)), jcl.encode_w(params, jcfg, win)):
        _close(got, ref)
    for got, ref in zip(tcl.encode_z_step(tparams, T(x), T(w), T(h), T(c)),
                        jcl.encode_z_step(params, x, w, h, c)):
        _close(got, ref)
    for got, ref in zip(tcl.decode_step(tparams, tcfg, T(z), T(w), T(h), T(c), x_prev=T(x)),
                        jcl.decode_step(params, jcfg, z, w, h, c, x_prev=x)):
        _close(got, ref)


def test_logistic_normal_and_discrete_draw():
    rng = np.random.default_rng(3)
    m, lv, eps = (rng.standard_normal((6, 4)).astype(np.float32) for _ in range(3))
    T = torch.from_numpy
    for add_noise in (True, False):
        _close(tdist.logistic_normal_from_eps(T(m), T(lv), T(eps), add_noise=add_noise),
               jdist.logistic_normal_from_eps(m, lv, eps, add_noise=add_noise))
    w = np.array(jdist.logistic_normal_from_eps(m[0], lv[0], eps[0]))
    for u in (0.0, 0.3, 0.77, 0.999999):
        got = tdist.sample_w_discrete_from_u(torch.tensor(u), T(w))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdist.sample_w_discrete_from_u(u, w)))


@pytest.mark.parametrize("which", ["small", "jsball_vrnn4"])
@pytest.mark.parametrize("w_sample,w_discrete", [(False, False), (True, False), (True, True)])
def test_infer_w_noise(which, w_sample, w_discrete):
    jcfg, params, tcfg, tparams = _model(which)
    rng = np.random.default_rng(4)
    T_seed = 3 * jcfg.seq_length + 1  # three chunks, one frame left over
    seed = (rng.random((T_seed, jcfg.original_dim)) < 0.2).astype(np.float32)
    eps = rng.standard_normal((3, jcfg.n_classes - 1)).astype(np.float32)
    u = np.float32(rng.random())
    ref = jgen.infer_w_cl_vrnn_noise(params, jcfg, seed, eps, w_sample=w_sample,
                                     w_discrete=w_discrete, u_discrete=jnp.asarray(u))
    got = tgen.infer_w_cl_vrnn_noise(tparams, tcfg, torch.from_numpy(seed), torch.from_numpy(eps),
                                     w_sample=w_sample, w_discrete=w_discrete,
                                     u_discrete=torch.tensor(u))
    _close(got, ref)
    # a batch of seeds at once gives each seed's w
    batch = np.stack([seed, seed[::-1].copy()])
    got_b = tgen.infer_w_cl_vrnn_noise(tparams, tcfg, torch.from_numpy(batch),
                                       torch.from_numpy(np.stack([eps, eps])),
                                       w_sample=w_sample, w_discrete=w_discrete,
                                       u_discrete=torch.tensor([u, u]))
    _close(got_b[0], ref)


def test_infer_w_matches_jax_key_variant_without_noise():
    """Without w_sample, the key-based JAX sampler draws nothing that
    matters: the port's generator-based one agrees with it."""
    jcfg, params, tcfg, tparams = _model("jsball_vrnn4")
    rng = np.random.default_rng(5)
    seeds = (rng.random((3, 32, jcfg.original_dim)) < 0.1).astype(np.float32)
    got = tgen.infer_w_cl_vrnn(tparams, tcfg, torch.from_numpy(seeds))
    for i in range(3):
        _close(got[i], jgen.infer_w_cl_vrnn(params, jcfg, seeds[i], jax.random.PRNGKey(i)))
