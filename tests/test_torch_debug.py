"""The port's numerics checks (``train/debug.py``) vs the JAX package's.

* ``assert_finite_pytree``: on the same trees (nested dicts and lists of
  arrays, tensors in the port), the same ``FloatingPointError`` message
  naming each non-finite leaf as ``path (n_bad/size non-finite)``.
* ``check_first_batch`` on a small cl_vrnn (both backends; the noise fixed
  in the batch): finite params give the JAX metrics within 1e-5 relative;
  a NaN parameter or input, and an infinite gradient, raise with the JAX
  package's message.
* ``--check_numerics`` in both train CLIs prints the JAX CLIs' line.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.train import debug as jdebug
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.train import debug as tdebug
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _message(fn, *args):
    with pytest.raises(FloatingPointError) as info:
        fn(*args)
    return str(info.value)


def _trees():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    bad = a.copy()
    bad[1, 2] = np.nan
    worse = a.copy()
    worse[0] = [np.inf, -np.inf, np.nan]
    return {
        "one_leaf": {"enc": {"kernel": bad, "bias": a[0]}, "dec": {"kernel": a}},
        "two_leaves": {"enc": {"kernel": worse}, "dec": {"kernel": a, "bias": bad[1]}},
        "lists": {"stack": [a, {"w": bad}], "t": (worse[0], a)},
    }


@pytest.mark.parametrize("case", sorted(_trees()))
def test_assert_finite_pytree_message_matches_jax(case):
    tree = _trees()[case]
    as_torch = _torch(tree)
    want = _message(jdebug.assert_finite_pytree, tree, "params")
    assert _message(tdebug.assert_finite_pytree, tree, "params") == want
    assert _message(tdebug.assert_finite_pytree, as_torch, "params") == want
    tdebug.assert_finite_pytree({"a": np.ones(3), "b": [torch.zeros(2)], "c": 1.5})


def _setup(backend):
    B, T, D, H, L, K = 6, 4, 10, 8, 2, 3
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=True, lstm_backend=backend,
                      two_cell=True if backend == "pallas" else None)
    tcfg = tcl.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    raw = jax.tree.map(np.array, jcl.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    batch = {"x": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "x_prev": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "y": (rng.random((B, T, D)) < 0.3).astype(np.float32),
             "w": np.eye(K, dtype=np.float32)[rng.integers(0, K, B)],
             "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, T, L)).astype(np.float32)}
    jloss = lambda p, b, k, *a: jcl.loss_and_metrics(p, jcfg, b, k, *a)
    tloss = lambda p, b, g, *a: tcl.loss_and_metrics(p, tcfg, b, g, *a)
    return raw, batch, jloss, tloss


def _torch(tree):
    """The tree with its leaves as tensors, its dicts in their own order."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_check_first_batch_matches_jax(backend):
    raw, batch, jloss, tloss = _setup(backend)
    args = (1.0, 0.3, 1.0)
    want = jdebug.check_first_batch(jloss, raw, batch, jax.random.PRNGKey(0), *args)
    got = tdebug.check_first_batch(tloss, params_from_numpy(raw, "cpu"), _torch(batch),
                                   torch.Generator().manual_seed(0), *args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("where", ["params", "batch"])
def test_check_first_batch_names_the_bad_leaf(where):
    raw, batch, jloss, tloss = _setup("xla")
    if where == "params":
        raw["decoder_h"]["recurrent_kernel"][2, 5] = np.nan
    else:
        batch["x_prev"][0, 1, 2] = np.inf
    args = (1.0, 1.0, 1.0)
    want = _message(jdebug.check_first_batch, jloss, raw, batch, jax.random.PRNGKey(0), *args)
    got = _message(tdebug.check_first_batch, tloss, params_from_numpy(raw, "cpu"),
                   _torch(batch), torch.Generator().manual_seed(0), *args)
    assert got == want
    assert ("decoder_h/recurrent_kernel (1/" if where == "params" else "x_prev (1/") in got


def test_check_first_batch_infinite_gradient_matches_jax():
    params = {"a": {"kernel": np.array([0.0, 1.0, 4.0], np.float32)},
              "b": {"bias": np.ones(2, np.float32)}}
    batch = {"x": np.ones(3, np.float32)}

    def jloss(p, b, key):
        return jnp.sum(jnp.sqrt(p["a"]["kernel"]) * b["x"]), {"s": jnp.sum(p["b"]["bias"])}

    def tloss(p, b, g):
        return torch.sum(torch.sqrt(p["a"]["kernel"]) * b["x"]), {"s": torch.sum(p["b"]["bias"])}

    want = _message(jdebug.check_first_batch, jloss, params, batch, jax.random.PRNGKey(0))
    got = _message(tdebug.check_first_batch, tloss, _torch(params), _torch(batch), None)
    assert got == want == "non-finite values in gradients: a/kernel (1/3 non-finite)"


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_check_numerics_flag_prints_the_jax_line(tmp_path, capsys, family):
    cli = cl_vrnn_train if family == "cl_vrnn" else cl_vae_train
    extra = (["--intermediate_dim", "8", "--seq_length", "4", "--batch_size", "1000"]
             if family == "cl_vrnn" else ["--latent_dim", "2", "--batch_size", "500"])
    args = cli.build_parser().parse_args(
        ["r", "--device", "cpu", "--train_file", CORPUS, "--num_epochs", "1", "--patience", "0",
         "--model_dir", str(tmp_path), "--check_numerics", *extra])
    seen = []
    real = tdebug.check_first_batch
    spy = functools.wraps(real)(lambda *a: seen.append(a[2]) or real(*a))
    tdebug.check_first_batch = spy
    try:
        cli.train(args)
    finally:
        tdebug.check_first_batch = real
    assert "check_numerics: first batch loss/grads finite" in capsys.readouterr().out
    assert len(seen) == 1 and len(next(iter(seen[0].values()))) == args.batch_size
