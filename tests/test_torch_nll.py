"""The port's IW-NLL estimators (cl_vrnn and cl_vae) and ``cli/evaluate.py``
vs the JAX package.

``iw_nll_cl_vrnn_noise`` is held against the JAX ``iw_nll_cl_vrnn`` fed
the same key: the test rebuilds the JAX draws (``split(key, S)``, then per
sample ``ku, kz = split(k)``, ``normal(ku, [B, K-1])``, ``normal(kz, [B, T,
L])``) and hands them to the port. Both JAX backends (the XLA scan and the
Pallas kernels in interpret mode) against the port's matching backend (its
plain LSTM, or the plain versions of its whole-sequence kernels), with and
without ``x_prev``. Tolerance 1e-4 nats/frame (f32 sums in another order
through a log-mean-exp over S samples).
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import evaluate as jeval
from classifying_vae_lstm_tpu.evaluation import nll as jnll
from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train as tcli
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.cli import evaluate as teval
from classifying_vae_lstm_tpu_torch.data import PianoData
from classifying_vae_lstm_tpu_torch.evaluation import nll as tnll
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"
S = 5


def _setup(backend, use_x_prev, B=6, T=5, D=12, H=16, L=3, K=4, seed=0):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=use_x_prev, lstm_backend=backend)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    data = {k: (rng.random((B, T, D)) < 0.3).astype(np.float32) for k in ("x", "y", "x_prev")}
    return jcfg, tcl.Config(**dataclasses.asdict(jcfg)), params, data


def _jax_draws(key, B, T, L, K):
    eps_u, eps_z = [], []
    for k in jax.random.split(key, S):
        ku, kz = jax.random.split(k)
        eps_u.append(np.asarray(jax.random.normal(ku, (B, K - 1))))
        eps_z.append(np.asarray(jax.random.normal(kz, (B, T, L))))
    return np.stack(eps_u), np.stack(eps_z)


@pytest.mark.parametrize("use_x_prev", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_iw_nll_noise_matches_jax(backend, use_x_prev):
    jcfg, tcfg, params, d = _setup(backend, use_x_prev)
    key = jax.random.PRNGKey(7)
    xp = d["x_prev"] if use_x_prev else None
    ref = jnll.iw_nll_cl_vrnn(params, jcfg, d["x"], d["y"], key, n_samples=S, x_prev=xp)
    B, T, _ = d["x"].shape
    eps_u, eps_z = _jax_draws(key, B, T, jcfg.latent_dim, jcfg.n_classes)
    t = torch.from_numpy
    with torch.no_grad():
        got = tnll.iw_nll_cl_vrnn_noise(params_from_numpy(params, "cpu"), tcfg, t(d["x"]),
                                        t(d["y"]), t(eps_u), t(eps_z),
                                        t(xp) if use_x_prev else None)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_iw_nll_dataset_covers_every_example():
    """N % batch_size != 0: the last batch wraps around and its pad rows are
    dropped, so all N examples come back; the first batch draws what
    ``iw_nll_cl_vrnn`` draws from a generator in the same state."""
    _, tcfg, params, d = _setup("pallas", True, B=7)
    tp = params_from_numpy(params, "cpu")
    data = {k: torch.from_numpy(v) for k, v in d.items()}
    nlls = tnll.iw_nll_dataset(tp, tcfg, data, torch.Generator().manual_seed(3), n_samples=S,
                               batch_size=3, family="cl_vrnn")
    assert nlls.shape == (7,) and torch.isfinite(nlls).all()
    first = tnll.iw_nll_cl_vrnn(tp, tcfg, data["x"][:3], data["y"][:3],
                                torch.Generator().manual_seed(3), S, data["x_prev"][:3])
    torch.testing.assert_close(nlls[:3], first, rtol=0, atol=0)


def _actions(parser):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax_flag_for_flag():
    port, ref = _actions(teval.build_parser()), _actions(jeval.build_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert {k for k in ref if port[k] != ref[k]} == {"train_file"}
    assert port["train_file"][0] == tcommon.DEFAULT_TRAIN_FILE
    assert port["device"] == ("cuda", ("cuda", "cpu"))


def test_cli_evaluates_a_port_checkpoint_on_every_test_window(tmp_path, capsys):
    """A tiny ``--two_cell off`` run of the port's trainer writes a checkpoint;
    the port's ``cli/evaluate.py --device cpu`` prints the JAX package's JSON
    line over every window of the test split."""
    tcli.train(tcli.build_parser().parse_args(
        ["tiny", "--device", "cpu", "--train_file", CORPUS, "--intermediate_dim", "8",
         "--latent_dim", "2", "--seq_length", "4", "--batch_size", "1000", "--num_epochs", "2",
         "--patience", "0", "--use_x_prev", "--lstm_backend", "pallas", "--two_cell", "off",
         "--model_dir", str(tmp_path)]))
    capsys.readouterr()
    ckpt = str(tmp_path / "tiny.npz")
    out = teval.evaluate(teval.build_parser().parse_args(
        ["-i", ckpt, "--train_file", CORPUS, "--device", "cpu", "--n_samples", "2",
         "--batch_size", "1500"]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    P = PianoData(CORPUS, batch_size=1, seq_length=4, return_y_next=True, return_y_hist=True,
                  squeeze_x=False, squeeze_y=False)
    assert line["n_test_examples"] == len(P.x_test) > 1500  # the last batch is ragged
    assert set(line) == {"test_nll_nats_per_frame", "n_importance_samples", "n_test_examples",
                         "family", "train_file"}
    assert line["family"] == "cl_vrnn" and line["n_importance_samples"] == 2
    assert np.isfinite(line["test_nll_nats_per_frame"]) and line["test_nll_nats_per_frame"] > 0


def test_unported_options_raise_naming_the_roadmap():
    for model in ("artifacts/jsball_vrnn4.npz", "artifacts/jsbcs_vae.npz"):
        args = teval.build_parser().parse_args(["-i", model, "--device", "cpu", "--dp", "2"])
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
            teval.evaluate(args)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        tnll.iw_nll_dataset_dp()
    assert not hasattr(tnll, "CL_VAE_TODO")  # the cl_vae estimator is ported
    assert teval.build_parser().parse_args(["-i", "m.npz"]).device == "cuda"


def test_log_densities_match_jax():
    rng = np.random.default_rng(4)
    x, m, lv = rng.standard_normal((3, 5, 7)).astype(np.float32)
    p = rng.random((5, 7)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 1e-9]  # the clip
    y = (rng.random((5, 7)) < 0.5).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tnll._log_normal(t(x), t(m), t(lv)).numpy(),
                               np.asarray(jnll._log_normal(x, m, lv)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tnll._log_bernoulli(t(y), t(p)).numpy(),
                               np.asarray(jnll._log_bernoulli(jnp.asarray(y), jnp.asarray(p))),
                               rtol=1e-6, atol=1e-5)


# ---- the cl_vae estimator
#
# iw_nll_cl_vae_noise against the JAX iw_nll_cl_vae fed the same key: the
# draws are rebuilt from JAX's own splits (split(key, S), then per sample
# ku, kz = split(k), normal(ku, [B, K-1]), normal(kz, [B, L])). Both run the
# plain dense layers; tolerance 1e-5 nats/frame (f32 sums in another order).

from classifying_vae_lstm_tpu.cli import common as jcommon  # noqa: E402


def _vae_draws(key, S, B, L, K):
    eps_u, eps_z = [], []
    for k in jax.random.split(key, S):
        ku, kz = jax.random.split(k)
        eps_u.append(np.asarray(jax.random.normal(ku, (B, K - 1))))
        eps_z.append(np.asarray(jax.random.normal(kz, (B, L))))
    return np.stack(eps_u), np.stack(eps_z)


def _vae_windows(n, seed=0):
    P = PianoData(CORPUS, batch_size=1, seq_length=1, return_y_next=True)
    idx = np.random.default_rng(seed).choice(len(P.x_test), size=n, replace=False)
    return P.y_test[idx], P.x_test[idx]  # x (= the next frame) and x_prev


@pytest.mark.parametrize("name", ["jsbcs_vae", "jsball_vanilla"])
def test_iw_nll_cl_vae_noise_matches_jax(name):
    jp, jcfg, _ = jcommon.load_model(f"artifacts/{name}.npz", "cl_vae")
    raw, tcfg, _ = tcommon.load_model(f"artifacts/{name}.npz", "cl_vae")
    S, B = 4, 11
    x, xp = _vae_windows(B)
    xp_in = xp if tcfg.use_x_prev else None
    key = jax.random.PRNGKey(5)
    ref = jnll.iw_nll_cl_vae(jp, jcfg, x, x, key, n_samples=S, x_prev=xp_in)
    eps_u, eps_z = _vae_draws(key, S, B, tcfg.latent_dim, tcfg.n_classes)
    t = torch.from_numpy
    with torch.no_grad():
        got = tnll.iw_nll_cl_vae_noise(params_from_numpy(raw, "cpu"), tcfg, t(x), t(x),
                                       t(eps_u), t(eps_z), t(xp) if tcfg.use_x_prev else None)
    assert got.shape == (B,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_iw_nll_dataset_cl_vae_covers_every_example():
    """N % batch_size != 0: the last batch wraps around and its pad rows are
    dropped; the first batch draws what ``iw_nll_cl_vae`` draws from a
    generator in the same state."""
    raw, tcfg, _ = tcommon.load_model("artifacts/jsbcs_vae.npz", "cl_vae")
    tp = params_from_numpy(raw, "cpu")
    x, xp = _vae_windows(7, seed=1)
    data = {"x": torch.from_numpy(x), "y": torch.from_numpy(x), "x_prev": torch.from_numpy(xp)}
    nlls = tnll.iw_nll_dataset(tp, tcfg, data, torch.Generator().manual_seed(3), n_samples=S,
                               batch_size=3, family="cl_vae")
    assert nlls.shape == (7,) and torch.isfinite(nlls).all()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        batches = [tnll.iw_nll_cl_vae(tp, tcfg, data["x"][i], data["y"][i], gen, S,
                                      data["x_prev"][i])
                   for i in ([0, 1, 2], [3, 4, 5], [6, 0, 1])]
    torch.testing.assert_close(nlls, torch.cat(batches)[:7], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["jsbcs_vae", "jsball_vanilla"])
def test_cli_evaluates_cl_vae_checkpoints(name, capsys):
    """``cli.evaluate --family auto --device cpu`` on a cl_vae checkpoint
    prints the JAX package's JSON line over every test frame; the vanilla
    model (K=1, no x_prev) has its key labels collapsed as in JAX."""
    out = teval.evaluate(teval.build_parser().parse_args(
        ["-i", f"artifacts/{name}.npz", "--train_file", CORPUS, "--device", "cpu",
         "--n_samples", "4", "--batch_size", "1000"]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"test_nll_nats_per_frame", "n_importance_samples", "n_test_examples",
                         "family", "train_file"}
    assert line["family"] == "cl_vae" and line["n_importance_samples"] == 4
    P = PianoData(CORPUS, batch_size=1, seq_length=1,
                  return_y_next=name == "jsbcs_vae")
    assert line["n_test_examples"] == len(P.x_test) > 1000  # the last batch is ragged
    assert np.isfinite(line["test_nll_nats_per_frame"]) and line["test_nll_nats_per_frame"] > 0
