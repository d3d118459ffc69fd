"""The port's optimizers vs the JAX package's optax transformations.

Every name ``init_optimizer`` resolves takes the same N steps from the same
parameters and the same sequence of gradients (NumPy, seeded) on both sides;
the parameters and every piece of optimizer state (m, v, m_g, v_g,
v_scaler, momenta, accumulators, Nadam's schedule) must agree within
rtol 1e-6 (atol 1e-7 for elements near zero): the update arithmetic is the
same float32 sequence, only the order of the weight-norm column sums differs.
The tree holds rank-1, rank-2 and rank-3 leaves, so both the weight-norm
and the plain rules run.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from classifying_vae_lstm_tpu import optim as joptim
from classifying_vae_lstm_tpu.optim import init_optimizer as jax_init_optimizer
from classifying_vae_lstm_tpu_torch.optim import adamwn, init_optimizer, keras_optimizers

TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5

# port state key -> how to read it from the JAX state (a field, or the state itself)
STATE = {
    "adam-wn": {"m": "m", "v": "v", "m_g": "m_g", "v_g": "v_g", "v_scaler": "v_scaler"},
    "sgd-wn": {"momentum": "momentum", "momentum_g": "momentum_g", "v_scaler": "v_scaler"},
    "sgd": {"momentum": "momentum"},
    "rmsprop": {"acc": None},
    "adagrad": {"acc": None},
    "adadelta": {"acc": "acc", "delta_acc": "delta_acc"},
    "adam": {"m": "m", "v": "v"},
    "adamax": {"m": "m", "u": "u"},
    "nadam": {"m": "m", "v": "v"},
}


def _tree(rng):
    return {"dense": {"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                      "bias": rng.standard_normal(4).astype(np.float32)},
            "conv": rng.standard_normal((3, 5, 2)).astype(np.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _run_both(tx, ctor, seed=0):
    """STEPS steps of the JAX transformation and of the port's optimizer from
    the same parameters and gradients; checks the parameters agree and
    returns (JAX state, port optimizer, port leaves)."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jparams, jstate = params, tx.init(params)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in _flat(params).items()}
    opt = ctor(list(leaves.values()))
    for g in grads:
        for k, v in _flat(g).items():
            leaves[k].grad = torch.from_numpy(v)
        opt.step()
    for k, v in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(leaves[k].detach().numpy(), v, err_msg=f"param {k}", **TOL)
    return jstate, opt, leaves


@pytest.mark.parametrize("name", sorted(STATE))
def test_steps_match_jax(name):
    tx, was_wn = jax_init_optimizer(name)
    ctor, t_was_wn = init_optimizer(name)
    assert t_was_wn == was_wn
    jstate, opt, leaves = _run_both(tx, ctor)
    for key, field in STATE[name].items():
        ref = _flat(jax.tree.map(np.asarray, jstate if field is None else getattr(jstate, field)))
        for k, v in ref.items():
            st = opt.state[leaves[k]]
            assert st["step"] == STEPS
            np.testing.assert_allclose(st[key].numpy(), v, err_msg=f"{key} of {k}", **TOL)
    if name == "nadam":
        for p in leaves.values():
            np.testing.assert_allclose(opt.state[p]["m_schedule"],
                                       float(jstate.m_schedule), rtol=1e-6)


@pytest.mark.parametrize("fn,kw", [
    ("adam_with_weightnorm", dict(decay=0.01)),
    ("sgd_with_weightnorm", dict(momentum=0.9, nesterov=True, decay=0.01)),
    ("keras_sgd", dict(momentum=0.9, nesterov=True, decay=0.01)),
])
def test_decay_and_momentum_variants_match_jax(fn, kw):
    """Hyperparameters no CLI name sets (Keras decay, Nesterov momentum)."""
    port = getattr(adamwn, fn, None) or getattr(keras_optimizers, fn)
    _run_both(getattr(joptim, fn)(**kw), port(**kw), seed=3)


def test_factory_names():
    assert init_optimizer("adam-wn")[1] and not init_optimizer("sgd-wn")[1]
    assert init_optimizer("NAdam")[0].func.__name__ == "KerasNadam"
    with pytest.raises(ValueError, match="Could not interpret optimizer identifier"):
        init_optimizer("bogus")


def test_parameter_without_gradient_takes_a_zero_gradient():
    """As the JAX transformation sees zeros where autograd leaves None."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tx, _ = jax_init_optimizer("adam-wn")
    zeros = jax.tree.map(np.zeros_like, params)
    updates, _ = tx.update(zeros, tx.init(params), params)
    ref = optax.apply_updates(params, updates)
    leaves = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    init_optimizer("adam-wn")[0](list(leaves.values())).step()
    for k, v in _flat(jax.tree.map(np.asarray, ref)).items():
        np.testing.assert_allclose(leaves[k].numpy(), v, err_msg=k, **TOL)
