"""Mid-training resume in the port, and across the two packages.

``<run>.last.npz`` + ``<run>.last.opt.npz`` (the optimizer state as the
leaves of the JAX optimizer's state, ``leaf_0 … leaf_n``, and
``__epoch__``) written by the JAX package resume in the port, and the
port's resume in the JAX package, for every optimizer ``init_optimizer``
resolves. Both sides start from the same JAX-initialised cl_vrnn (f32,
``xla``, small width) and step on the same NumPy batch with explicit noise;
the losses and the parameters of the next steps agree within rtol 1e-6
(atol 1e-7 for elements near zero), the bound of ``tests/test_torch_optim.py``:
the same update arithmetic, on gradients summed in another order. Then the
two cases of ``tests/test_resume.py`` on the port's ``fit``, and resume
through both train CLIs, a bf16 two-cell cl_vrnn (plain versions) among
them.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.optim import init_optimizer as jax_init_optimizer
from classifying_vae_lstm_tpu.train import checkpoint as jckpt
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.models import cl_vae, cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.train import Trainer, checkpoint as tckpt, fit
from classifying_vae_lstm_tpu_torch.train.loop import copy_params
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

TOL = dict(rtol=1e-6, atol=1e-7)
OPTIMIZERS = ["adam-wn", "sgd-wn", "sgd", "rmsprop", "adagrad", "adadelta", "adam", "adamax",
              "nadam"]
WEIGHTS = (0.5, 0.3, 0.7)  # kl, class, w_kl
CORPUS = "data/input/Piano-midi_Cs.pickle"


def _problem(seed=0, B=6):
    jcfg = jcl.Config(original_dim=12, intermediate_dim=16, latent_dim=3, seq_length=5,
                      n_classes=4, use_x_prev=True)
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


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jcfg):
    def loss(p, batch):
        return jcl.loss_and_metrics(p, jcfg, batch, jax.random.PRNGKey(0), *WEIGHTS)[0]
    return jax.jit(jax.value_and_grad(loss))


def _jax_steps(jcfg, tx, params, state, batch, n):
    losses = []
    for _ in range(n):
        loss, g = _jax_grad_fn(jcfg)(params, batch)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, state, losses


def _port_trainer(tcfg, name):
    loss_fn = functools.partial(
        lambda c, p, b, g, klw, cw, wklw: tcl.loss_and_metrics(p, c, b, g, klw, cw, wklw), tcfg)
    return Trainer(loss_fn, init_optimizer(name)[0], batch_size=6)


def _port_steps(trainer, params, opt, batch, n):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [float(trainer.train_step(params, opt, tb, None, *WEIGHTS)["loss"]) for _ in range(n)]


def _assert_trees_close(got, ref, what):
    for (k, g), (k2, r) in zip(sorted(tckpt._flatten(got).items()),
                               sorted(jckpt._flatten(ref).items())):
        assert k == k2
        np.testing.assert_allclose(g, r, err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_run_resumes_in_the_port(tmp_path, name):
    """JAX: 2 steps, ``save_checkpoint`` with the optimizer state, 2 more
    steps. The port: ``load_checkpoint`` + ``load_opt_state`` of JAX's files,
    the same 2 more steps; losses, parameters and every state leaf agree."""
    jcfg, tcfg, params, batch = _problem()
    tx, _ = jax_init_optimizer(name)
    jp, js, _ = _jax_steps(jcfg, tx, params, tx.init(params), batch, 2)
    path = str(tmp_path / "r.last.npz")
    jckpt.save_checkpoint(path, jp, js, epoch=3)
    jp, js, jlosses = _jax_steps(jcfg, tx, jp, js, batch, 2)

    leaves, epoch = tckpt.load_opt_state(path.replace(".npz", ".opt.npz"))
    assert epoch == 3 and len(leaves) == len(jax.tree.leaves(js))
    trainer = _port_trainer(tcfg, name)
    tp = copy_params(params_from_numpy(tckpt.load_checkpoint(path), "cpu"), requires_grad=True)
    opt = trainer.init_optimizer(tp)
    order = tckpt.sorted_leaves(tp)
    opt.load_state_leaves(order, leaves)
    losses = _port_steps(trainer, tp, opt, batch, 2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    _assert_trees_close(tp, jp, "parameter")
    for i, (g, r) in enumerate(zip(opt.state_leaves(order), jax.tree.leaves(js))):
        assert g.shape == r.shape and g.dtype == r.dtype, i
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"state leaf {i}", **TOL)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_run_resumes_in_jax(tmp_path, name):
    """The other way round: the port's 2 steps and files, JAX's
    ``load_opt_state`` (its optimizer's template) reads them, and both go on
    for 2 steps."""
    jcfg, tcfg, params, batch = _problem(seed=2)
    trainer = _port_trainer(tcfg, name)
    tp = copy_params(params_from_numpy(params, "cpu"), requires_grad=True)
    opt = trainer.init_optimizer(tp)
    order = tckpt.sorted_leaves(tp)
    _port_steps(trainer, tp, opt, batch, 2)
    path = str(tmp_path / "r.last.npz")
    tckpt.save_checkpoint(path, tp, opt.state_leaves(order), epoch=5)
    losses = _port_steps(trainer, tp, opt, batch, 2)

    tx, _ = jax_init_optimizer(name)
    jp = jckpt.load_checkpoint(path)
    js, epoch = jckpt.load_opt_state(path.replace(".npz", ".opt.npz"), tx.init(jp))
    assert epoch == 5
    jp, js, jlosses = _jax_steps(jcfg, tx, jp, js, batch, 2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    _assert_trees_close(tp, jp, "parameter")
    for i, (g, r) in enumerate(zip(opt.state_leaves(order), jax.tree.leaves(js))):
        np.testing.assert_allclose(g, np.asarray(r), err_msg=f"state leaf {i}", **TOL)


def _vae_setup():
    """``tests/test_resume.py``'s problem on the port: a small cl_vae on 120
    seeded frames, AdamWN, batches of 20."""
    cfg = cl_vae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                        intermediate_class_dim=8, n_classes=3)
    params = cl_vae.init(torch.Generator().manual_seed(0), cfg)
    x = (torch.rand((120, 12), generator=torch.Generator().manual_seed(1)) < 0.25).float()
    data = {"x": x, "y": x, "w": torch.eye(3)[torch.arange(120) % 3]}
    loss_fn = functools.partial(
        lambda c, p, b, g, klw, cw, wklw: cl_vae.loss_and_metrics(p, c, b, g, klw, cw, wklw),
        cfg)
    return Trainer(loss_fn, init_optimizer("adam-wn")[0], batch_size=20), params, data


def test_opt_state_roundtrip(tmp_path):
    trainer, params, data = _vae_setup()
    params = copy_params(params, requires_grad=True)
    opt = trainer.init_optimizer(params)
    trainer.train_epoch(params, opt, data, torch.Generator().manual_seed(2), 1.0, 1.0, 1.0)
    order = tckpt.sorted_leaves(params)
    path = str(tmp_path / "m.npz")
    tckpt.save_checkpoint(path, params, opt.state_leaves(order), epoch=7)
    loaded = tckpt.load_checkpoint(path)
    leaves, epoch = tckpt.load_opt_state(path.replace(".npz", ".opt.npz"))
    assert epoch == 7 and int(leaves[0]) == 6  # AdamWN's count: 120 / 20 steps
    for a, b in zip(opt.state_leaves(order), leaves):
        np.testing.assert_array_equal(a, b)
    fresh = copy_params(params_from_numpy(loaded, "cpu"), requires_grad=True)
    opt2 = trainer.init_optimizer(fresh)
    opt2.load_state_leaves(tckpt.sorted_leaves(fresh), leaves)
    for a, b in zip(opt2.state_leaves(tckpt.sorted_leaves(fresh)), leaves):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        opt2.load_state_leaves(tckpt.sorted_leaves(fresh), leaves[:-1])


def test_resumed_fit_equals_uninterrupted(tmp_path):
    """fit(4 epochs) == fit(2) -> ``<run>.last`` files -> fit(resume 2..4).
    The port's generator goes on where the first part left it, so the
    resumed epochs draw what the uninterrupted run drew, and the histories
    agree exactly (the JAX test, whose keys restart, compares loosely)."""
    trainer, params, data = _vae_setup()
    _, _, hist_full, _ = fit(trainer, params, data, data, num_epochs=4,
                             generator=torch.Generator().manual_seed(5), patience=0,
                             verbose=False)
    ckpt = str(tmp_path / "r.npz")
    gen = torch.Generator().manual_seed(5)
    _, _, hist_a, _ = fit(trainer, params, data, data, num_epochs=2, generator=gen, patience=0,
                          verbose=False, checkpoint_path=ckpt, save_last=True)
    last = ckpt.replace(".npz", ".last.npz")
    assert os.path.exists(last) and os.path.exists(last.replace(".npz", ".opt.npz"))
    leaves, epoch = tckpt.load_opt_state(last.replace(".npz", ".opt.npz"))
    assert epoch == 2
    params_r = params_from_numpy(tckpt.load_checkpoint(last), "cpu")
    _, _, hist_b, _ = fit(trainer, params_r, data, data, num_epochs=4, generator=gen,
                          patience=0, verbose=False, opt_state=leaves, initial_epoch=epoch)
    assert len(hist_a["loss"]) == 2 and len(hist_b["loss"]) == 2
    for k in hist_full:
        assert hist_a[k] + hist_b[k] == hist_full[k], k


def _cli_argv(family):
    if family == "cl_vrnn_bf16_two_cell":
        return cl_vrnn_train, ["--train_file", CORPUS, "--seq_length", "4", "--intermediate_dim",
                               "16", "--latent_dim", "2", "--batch_size", "2000",
                               "--use_x_prev", "--lstm_backend", "pallas", "--two_cell", "on"]
    return cl_vae_train, ["--train_file", CORPUS, "--batch_size", "2000", "--latent_dim", "2",
                          "--intermediate_dim", "16", "--intermediate_class_dim", "8",
                          "--train_backend", "pallas"]


@pytest.mark.parametrize("family", ["cl_vrnn_bf16_two_cell", "cl_vae"])
def test_cli_resumes_at_the_saved_epoch_and_count(tmp_path, family, capsys):
    """``--save_last`` for 1 epoch, then ``--resume`` to 2 epochs through the
    train CLI on the CPU: the second run starts at epoch 1 with the saved
    count and leaves ``__epoch__`` 2 and twice the count. The cl_vrnn runs
    the bf16 two-cell config (as JAX ``auto`` pins it at H=512, here at
    width 16): its args.json reads back bf16 and two-cell."""
    cli, flags = _cli_argv(family)
    base = ["r", "--device", "cpu", *flags, "--patience", "0", "--model_dir", str(tmp_path)]

    def run(extra):
        args = cli.build_parser().parse_args(base + extra)
        if family.endswith("bf16_two_cell"):
            args.bf16_compute = True  # JAX auto sets it on the namespace
        return cli.train(args)

    opt_file = str(tmp_path / "r.last.opt.npz")
    run(["--num_epochs", "1", "--save_last"])
    leaves1, epoch1 = tckpt.load_opt_state(opt_file)
    steps = int(leaves1[0])
    assert epoch1 == 1 and steps > 0
    capsys.readouterr()
    run(["--num_epochs", "2", "--resume"])
    assert f"at epoch 1\n" in capsys.readouterr().out
    leaves2, epoch2 = tckpt.load_opt_state(opt_file)
    assert epoch2 == 2 and int(leaves2[0]) == 2 * steps
    assert all(np.isfinite(np.asarray(v)).all() for v in leaves2)
    with open(tmp_path / "r.json") as f:
        margs = json.load(f)
    if family.endswith("bf16_two_cell"):
        assert (margs["bf16_compute"], margs["two_cell"], margs["lstm_backend"]) == (
            True, True, "pallas")
