"""The port's ``cl_vae_train`` CLI and its dataset helpers vs the JAX package.

* ``build_parser()`` against the JAX CLI's: the same dests, defaults and
  choices, apart from the ``--train_file`` default (the committed corpus)
  and the added ``--device``.
* ``build_cl_vae_datasets`` (with and without ``use_x_prev``) and the
  seq-concat ``prune_and_flatten_cl_vae`` give arrays equal to the JAX
  package's on ``Piano-midi_Cs.pickle``.
* Two epochs at a narrow width with ``--train_backend pallas --device cpu``
  (the dense-stack kernels' plain versions) and then with ``xla`` from the
  same seed: the first epochs' train losses agree within 1e-5 relative (the
  same f32 arithmetic in another order, ten AdamWN steps). The checkpoint
  triple loads in the JAX package, whose ``apply`` on it equals the port's
  (rtol 1e-5), and args.json records the resolved ``train_backend``.
* ``--bf16_compute --train_backend pallas`` trains two epochs through the
  bf16 mode of the dense-stack kernels' plain versions; args.json records
  both flags, and the checkpoint loads in the JAX package, whose bf16 kernel
  route on it equals the port's (1e-5: the same rounding points). Its IW-NLL
  rounds no layer, in either package (JAX ``iw_nll_cl_vae`` passes no
  dtype).
* ``--vanilla`` resolves ``pallas`` to ``xla``; ``--dp`` past the devices
  there are, or with ``--streaming``, raises the JAX package's message.
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import cl_vae_train as jcli
from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.data import PianoData as JaxPianoData
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train as tcli
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.data import PianoData
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"


def _actions(parser):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax_flag_for_flag():
    port, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert {k for k in ref if port[k] != ref[k]} == {"train_file"}
    assert port["train_file"][0] == tcommon.DEFAULT_TRAIN_FILE
    assert port["device"] == ("cuda", ("cuda", "cpu"))


@pytest.mark.parametrize("use_x_prev", [True, False])
def test_datasets_match_jax(use_x_prev):
    kw = dict(batch_size=100, seq_length=1, step_length=1, return_y_next=use_x_prev,
              squeeze_x=True, squeeze_y=True)
    P, JP = PianoData(CORPUS, **kw), JaxPianoData(CORPUS, **kw)
    K = int(len(np.unique(P.train_song_keys)))
    got = tcommon.build_cl_vae_datasets(P, K, use_x_prev, "cpu")
    ref = jcommon.build_cl_vae_datasets(JP, K, use_x_prev)
    assert set(got) == set(ref) == {"train", "valid", "test"}
    for split in ref:
        assert set(got[split]) == set(ref[split])
        for k, v in ref[split].items():
            np.testing.assert_array_equal(got[split][k].numpy(), np.asarray(v),
                                          err_msg=f"{split}/{k}")
    # 202 batches of 100 frames with a next frame, 203 without
    assert got["train"]["x"].shape == (20200 if use_x_prev else 20300, 88)


def test_seq_concat_pruning_matches_jax():
    kw = dict(batch_size=100, seq_length=2, step_length=1, return_y_next=False,
              squeeze_x=True, squeeze_y=True)
    P, JP = PianoData(CORPUS, **kw), JaxPianoData(CORPUS, **kw)
    np.testing.assert_array_equal(tcommon.active_pitch_mask(P), jcommon.active_pitch_mask(JP))
    dim = tcommon.prune_and_flatten_cl_vae(P, 2)
    assert dim == jcommon.prune_and_flatten_cl_vae(JP, 2) < 2 * 88
    for attr in ("x_train", "x_valid", "x_test", "y_train", "y_valid", "y_test"):
        assert getattr(P, attr).shape[1] == dim
        np.testing.assert_array_equal(getattr(P, attr), getattr(JP, attr), err_msg=attr)


def _train(tmp_path, monkeypatch, run, backend, extra=()):
    """One run of the port's CLI on the CPU; returns its args and history."""
    seen = {}
    real_fit = tcli.fit

    def fit(*a, **k):
        out = real_fit(*a, **k)
        seen["history"] = out[2]
        return out

    monkeypatch.setattr(tcli, "fit", fit)
    args = tcli.build_parser().parse_args(
        [run, "--device", "cpu", "--train_file", CORPUS, "--intermediate_dim", "16",
         "--intermediate_class_dim", "16", "--latent_dim", "2", "--batch_size", "2000",
         "--num_epochs", "2", "--patience", "0", "--use_x_prev", "--train_backend", backend,
         "--model_dir", str(tmp_path), *extra])
    _, best_loss = tcli.train(args)
    assert np.isfinite(best_loss["loss"]) and np.isfinite(best_loss["val_loss"])
    return args, seen["history"]


def test_pallas_and_xla_train_alike_and_the_checkpoint_loads_in_jax(tmp_path, monkeypatch,
                                                                     capsys):
    args_p, hist_p = _train(tmp_path, monkeypatch, "kern", "pallas")
    assert "train_backend=pallas" in capsys.readouterr().out
    args_x, hist_x = _train(tmp_path, monkeypatch, "plain", "xla")
    np.testing.assert_allclose(hist_p["loss"][0], hist_x["loss"][0], rtol=1e-5)
    assert hist_p["loss"][1] < hist_p["loss"][0]
    assert {p.name for p in tmp_path.iterdir()} == {f"{r}.{e}" for r in ("kern", "plain")
                                                    for e in ("npz", "json", "yaml")}

    ckpt = str(tmp_path / "kern.npz")
    jparams, jcfg, margs = jcommon.load_model(ckpt, "cl_vae")
    raw, tcfg, _ = tcommon.load_model(ckpt, "cl_vae")
    assert margs["train_backend"] == "pallas" and margs["n_classes"] == 2
    assert jcfg == jvae.Config(**dataclasses.asdict(tcfg)) and jcfg.train_backend == "pallas"
    rng = np.random.default_rng(4)
    B = 6
    x, xp = ((rng.random((B, 88)) < 0.1).astype(np.float32) for _ in range(2))
    noise = {"eps_w": rng.standard_normal((B, 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, 2)).astype(np.float32)}
    ref = jvae.apply(jparams, jcfg, x, jax.random.PRNGKey(0), xp, noise=noise)
    t = torch.from_numpy
    got = tvae.apply(params_from_numpy(raw, "cpu"), tcfg, t(x), x_prev=t(xp),
                     noise={k: t(v) for k, v in noise.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bf16_pallas_trains_and_the_checkpoint_loads_in_jax(tmp_path, monkeypatch, capsys):
    from classifying_vae_lstm_tpu.evaluation import nll as jnll
    from classifying_vae_lstm_tpu_torch.evaluation import nll as tnll

    args, hist = _train(tmp_path, monkeypatch, "bf", "pallas", ["--bf16_compute"])
    assert "train_backend=pallas" in capsys.readouterr().out
    assert hist["loss"][1] < hist["loss"][0]
    ckpt = str(tmp_path / "bf.npz")
    jparams, jcfg, margs = jcommon.load_model(ckpt, "cl_vae")
    raw, tcfg, _ = tcommon.load_model(ckpt, "cl_vae")
    assert (margs["train_backend"], margs["bf16_compute"]) == ("pallas", True)
    assert jcfg.bf16_compute and jcfg == jvae.Config(**dataclasses.asdict(tcfg))
    rng = np.random.default_rng(5)
    B = 6
    x, xp = ((rng.random((B, 88)) < 0.1).astype(np.float32) for _ in range(2))
    noise = {"eps_w": rng.standard_normal((B, 1)).astype(np.float32),
             "eps_z": rng.standard_normal((B, 2)).astype(np.float32)}
    ref = jvae.apply(jparams, jcfg, x, jax.random.PRNGKey(0), xp, noise=noise)
    t = torch.from_numpy
    tp = params_from_numpy(raw, "cpu")
    got = tvae.apply(tp, tcfg, t(x), x_prev=t(xp), noise={k: t(v) for k, v in noise.items()})
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # the estimator: no layer rounded under bf16_compute, as in JAX
    eps_u, eps_z = rng.standard_normal((2, 3, B, 1)), rng.standard_normal((2, 3, B, 2))
    nll = lambda c: tnll.iw_nll_cl_vae_noise(tp, c, t(x), t(x), t(eps_u[0]).float(),
                                             t(eps_z[0]).float(), t(xp))
    with torch.no_grad():
        torch.testing.assert_close(nll(tcfg), nll(dataclasses.replace(tcfg, bf16_compute=False)),
                                   rtol=0, atol=0)
    key = jax.random.PRNGKey(1)
    np.testing.assert_array_equal(
        np.asarray(jnll.iw_nll_cl_vae(jparams, jcfg, x, x, key, n_samples=3, x_prev=xp)),
        np.asarray(jnll.iw_nll_cl_vae(jparams, dataclasses.replace(jcfg, bf16_compute=False), x,
                                      x, key, n_samples=3, x_prev=xp)))


@pytest.mark.parametrize("choice", ["auto", "xla"])
def test_auto_and_xla_record_xla(tmp_path, monkeypatch, choice):
    args, _ = _train(tmp_path, monkeypatch, "r", choice, ["--num_epochs", "1"])
    assert jcommon.load_model_args(str(tmp_path / "r.json"))["train_backend"] == "xla"


def test_vanilla_trains_on_xla(tmp_path, monkeypatch, capsys):
    args, hist = _train(tmp_path, monkeypatch, "van", "pallas", ["--vanilla", "--num_epochs", "1"])
    assert "train_backend=xla" in capsys.readouterr().out
    margs = jcommon.load_model_args(str(tmp_path / "van.json"))
    assert (margs["train_backend"], margs["n_classes"]) == ("xla", 1)
    assert hist["w_acc"] == [1.0] and hist["w_loss"] == [0.0]


@pytest.mark.parametrize("flag", ["dp"])
def test_unported_flags_raise(flag, tmp_path):
    """--dp is ported (tests/test_torch_parallel.py trains through it); what
    still raises is the JAX package's guard: more ranks than the devices
    there are (on the CPU, its cores), and --dp with --streaming, before any
    rank starts."""
    n = tcommon.dp_device_count(torch.device("cpu"))
    args = tcli.build_parser().parse_args(["r", "--device", "cpu", f"--{flag}", str(n + 1),
                                           "--model_dir", str(tmp_path)])
    with pytest.raises(ValueError, match=f"--dp {n + 1}: only {n} devices available"):
        tcli.train(args)
    args = tcli.build_parser().parse_args(["r", "--device", "cpu", f"--{flag}", "1",
                                           "--streaming", "--model_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--streaming"):
        tcli.train(args)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    args = tcli.build_parser().parse_args(["r", "--train_file", CORPUS])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.train(args)
