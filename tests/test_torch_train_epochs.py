"""``Trainer.train_epochs`` (E epochs in one call) and ``pianoroll_to_song``,
the last of the JAX package's public surface the port lacked.

Mirrors JAX ``tests/test_train.py``'s ``train_epochs`` test: per-epoch
train and validation metric arrays of shape (E,) and a falling loss; the
port's loop is also held to E calls of its epoch bodies with the same
generator (bitwise), and to JAX's ``train_epochs`` metric shapes on the
same weights and data. ``pianoroll_to_song`` against the JAX function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.data import pianoroll as jpr
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.optim import init_optimizer as jinit_optimizer
from classifying_vae_lstm_tpu.train import Trainer as JTrainer
from classifying_vae_lstm_tpu_torch.data import pianoroll_to_song, song_to_pianoroll
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.train import Trainer
from classifying_vae_lstm_tpu_torch.train.loop import copy_params
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

E = 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_trainer_and_data(n=120, batch=20, n_classes=3):
    cfg = tvae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                      intermediate_class_dim=8, n_classes=n_classes)
    params = tvae.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((n, 12)) < 0.25).astype(np.float32))
    w = torch.eye(n_classes)[torch.arange(n) % n_classes]
    loss_fn = functools.partial(
        lambda c, p, b, g, klw, cw, wklw: tvae.loss_and_metrics(p, c, b, g, klw, cw, wklw), cfg)
    opt, _ = init_optimizer("adam-wn")
    return Trainer(loss_fn, opt, batch_size=batch), params, {"x": x, "y": x, "w": w}, cfg


def test_train_epochs_compiled_mode_matches_sequential_shapes():
    """Per-epoch metric arrays of shape (E,) and a falling loss, as in JAX;
    the anneal weights of each epoch taken in turn; and the run equal,
    bitwise, to E calls of ``train_epoch`` and ``eval_epoch`` with the same
    generator."""
    trainer, params, data, _ = _make_trainer_and_data()
    p = copy_params(params, requires_grad=True)
    opt = trainer.init_optimizer(p)
    kl_ws, w_kl_ws = torch.linspace(0.1, 1.0, E), torch.ones(E)
    p_out, opt_out, ms, vms = trainer.train_epochs(p, opt, data, data,
                                                   torch.Generator().manual_seed(3), kl_ws,
                                                   1.0, w_kl_ws)
    assert p_out is p and opt_out is opt
    assert ms["loss"].shape == (E,) and vms["loss"].shape == (E,)
    assert set(ms) == set(vms) and "w_acc" in ms
    assert float(ms["loss"][-1]) < float(ms["loss"][0])
    # the same run, epoch by epoch
    q = copy_params(params, requires_grad=True)
    opt2 = trainer.init_optimizer(q)
    g = torch.Generator().manual_seed(3)
    for e in range(E):
        m = trainer.train_epoch(q, opt2, data, g, float(kl_ws[e]), 1.0, float(w_kl_ws[e]))
        vm = trainer.eval_epoch(q, data, g, float(kl_ws[e]), 1.0, float(w_kl_ws[e]))
        assert torch.equal(m["loss"], ms["loss"][e]) and torch.equal(vm["loss"], vms["loss"][e])
    for layer in p:
        for name in p[layer]:
            assert torch.equal(p[layer][name], q[layer][name]), (layer, name)


def test_train_epochs_matches_jax_returns():
    """JAX's ``train_epochs`` on the same weights and data returns the same
    metric names, each a per-epoch array of the same shape, and both
    losses fall (the draws differ: a JAX key against a torch generator)."""
    trainer, params, data, cfg = _make_trainer_and_data()
    raw = {k: {n: v.numpy() for n, v in d.items()} for k, d in params.items()}
    jcfg = jvae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                       intermediate_class_dim=8, n_classes=3)
    jloss = functools.partial(
        lambda c, p, b, k, klw, cw, wklw: jvae.loss_and_metrics(p, c, b, k, klw, cw, wklw), jcfg)
    jopt, _ = jinit_optimizer("adam-wn")
    jtrainer = JTrainer(jloss, jopt, batch_size=20)
    jparams = jax.tree.map(jnp.asarray, raw)
    jdata = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    _, _, jms, jvms = jtrainer.train_epochs(jparams, jtrainer.optimizer.init(jparams), jdata,
                                            jdata, jax.random.PRNGKey(3), jnp.ones(E),
                                            jnp.float32(1.0), jnp.ones(E))
    p = copy_params(params_from_numpy(raw, "cpu"), requires_grad=True)
    _, _, ms, vms = trainer.train_epochs(p, trainer.init_optimizer(p), data, data,
                                         torch.Generator().manual_seed(3), torch.ones(E), 1.0,
                                         torch.ones(E))
    assert set(ms) == set(jms) and set(vms) == set(jvms)
    for k in ms:
        assert tuple(ms[k].shape) == tuple(jms[k].shape) == (E,), k
    assert float(ms["loss"][-1]) < float(ms["loss"][0])
    assert float(jms["loss"][-1]) < float(jms["loss"][0])


@pytest.mark.parametrize("offset", [21, 0])
def test_pianoroll_to_song_matches_jax(offset):
    """The per-step note lists of a roll, as the JAX function gives them, and
    the round trip through ``song_to_pianoroll``."""
    rng = np.random.default_rng(offset)
    roll = (rng.random((16, 88)) < 0.05).astype(np.float32)
    roll[3] = 0  # a silent step
    song = pianoroll_to_song(roll, offset)
    assert song == jpr.pianoroll_to_song(roll, offset) and song[3] == []
    song = [[60, 72, 79], [72, 79], [67, 70, 76, 84]]
    assert pianoroll_to_song(song_to_pianoroll(song)) == song
