"""The port's trainer and ``cl_vrnn_train`` CLI vs the JAX package.

* Three ``train_step``s on identical batches and noise (AdamWN; one batch
  three times, so the loss falls), on both backends: losses within 1e-4
  relative. Adam's ``m / (sqrt(v) + eps)`` is about +-1 on the first step
  whatever the gradient's size, so where a gradient is rounding noise the
  parameters can differ by ~lr after a step; the losses are what stays
  comparable.
* ``build_parser()`` against the JAX CLI's: same dests, defaults and
  choices, apart from the ``--train_file`` default (the committed corpus)
  and the added ``--device``.
* A tiny ``--device cpu`` run writes a checkpoint triple that the JAX
  package loads (``cli/common.load_model``) and that gives the same loss
  under the same noise in both packages (rtol 1e-5, f32 summation order),
  and that the port's serving engine generates from.
* ``--dp`` past the devices there are, or with ``--streaming``, raises the
  JAX package's message.
"""

import argparse
import functools

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import cl_vrnn_train as jcli
from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.optim import init_optimizer as jax_init_optimizer
from classifying_vae_lstm_tpu.train import Trainer as JaxTrainer
from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train as tcli
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.serving import GenerationEngine
from classifying_vae_lstm_tpu_torch.train.loop import Trainer, copy_params
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_Cs.pickle"


def _batch(rng, B, T, D, K, L):
    return {"x": (rng.random((B, T, D)) < 0.2).astype(np.float32),
            "x_prev": (rng.random((B, T, D)) < 0.2).astype(np.float32),
            "y": (rng.random((B, T, D)) < 0.2).astype(np.float32),
            "w": np.eye(K, dtype=np.float32)[rng.integers(0, K, B)],
            "eps_w": rng.standard_normal((B, K - 1)).astype(np.float32),
            "eps_z": rng.standard_normal((B, T, L)).astype(np.float32)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_three_train_steps_match_jax(backend):
    B, T, D, H, L, K = 8, 5, 12, 16, 3, 4
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                      n_classes=K, use_x_prev=True, lstm_backend=backend,
                      two_cell=True if backend == "pallas" else None)
    tcfg = tcl.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    batches = [_batch(rng, B, T, D, K, L)] * 3  # the same batch, so the loss must fall
    weights = (1.0, 0.3, 1.0)

    tx, _ = jax_init_optimizer("adam-wn")
    jtrainer = JaxTrainer(functools.partial(jcli._loss, jcfg), tx, batch_size=B)
    jp, js, jlosses = params, tx.init(params), []
    for b in batches:
        jp, js, m = jtrainer.train_step(jp, js, b, jax.random.PRNGKey(0), *weights)
        jlosses.append(float(m["loss"]))

    trainer = Trainer(functools.partial(tcli._loss, tcfg), init_optimizer("adam-wn")[0], B)
    tp = copy_params(params_from_numpy(params, "cpu"), requires_grad=True)
    opt = trainer.init_optimizer(tp)
    tlosses = [float(trainer.train_step(tp, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                                        None, *weights)["loss"]) for b in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[2] < tlosses[0]


def _actions(parser):
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax_flag_for_flag():
    port, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    differ = {k for k in ref if port[k] != ref[k]}
    assert differ == {"train_file"}
    assert port["train_file"][0] == tcommon.DEFAULT_TRAIN_FILE
    assert port["device"] == ("cuda", ("cuda", "cpu"))


def test_cli_run_checkpoint_loads_in_both_packages(tmp_path):
    args = tcli.build_parser().parse_args(
        ["tiny", "--device", "cpu", "--train_file", CORPUS, "--intermediate_dim", "16",
         "--latent_dim", "2", "--seq_length", "8", "--batch_size", "500", "--num_epochs", "2",
         "--patience", "0", "--use_x_prev", "--class_weight", "0.3",
         "--lstm_backend", "pallas", "--model_dir", str(tmp_path)])
    _, best_loss = tcli.train(args)
    assert np.isfinite(best_loss["loss"]) and np.isfinite(best_loss["val_loss"])
    ckpt = str(tmp_path / "tiny.npz")
    assert {p.name for p in tmp_path.iterdir()} == {"tiny.npz", "tiny.json", "tiny.yaml"}

    jparams, jcfg, margs = jcommon.load_model(ckpt, "cl_vrnn")
    raw, tcfg, _ = tcommon.load_model(ckpt, "cl_vrnn")
    assert margs["lstm_backend"] == "pallas" and margs["two_cell"] is True
    assert margs["fusion"] == [True, True, True] and margs["n_classes"] == 2
    assert jcfg == jcl.Config(**{f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__})

    batch = _batch(np.random.default_rng(2), 6, 8, 88, 2, 2)
    jl, _ = jcl.loss_and_metrics(jparams, jcfg, batch, jax.random.PRNGKey(0), 1.0, 0.3, 1.0)
    tl, _ = tcl.loss_and_metrics(params_from_numpy(raw, "cpu"), tcfg,
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                                 1.0, 0.3, 1.0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)

    seeds = (np.random.default_rng(3).random((4, 8, 88)) < 0.2).astype(np.float32)
    rolls = GenerationEngine(raw, tcfg, seeds, device="cpu").generate(n=2, nsteps=8)
    assert rolls.shape == (2, 8, 88) and set(np.unique(rolls).tolist()) <= {0.0, 1.0}


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


def test_two_cell_off_on_pallas_raises(tmp_path):
    """``--two_cell off`` on ``pallas`` trains through the whole-sequence LSTM
    kernels (their plain versions here) at the default fusion triple and
    records it in args.json; a run whose args name the proj-only triple (as
    a JAX checkpoint's args.json does at H >= 1,579) trains through that
    rung and records it."""
    argv = ["r", "--device", "cpu", "--train_file", CORPUS, "--seq_length", "4",
            "--intermediate_dim", "8", "--latent_dim", "2", "--batch_size", "1000",
            "--num_epochs", "1", "--patience", "0", "--lstm_backend", "pallas",
            "--two_cell", "off", "--model_dir", str(tmp_path)]
    _, best_loss = tcli.train(tcli.build_parser().parse_args(argv))
    assert np.isfinite(best_loss["loss"]) and np.isfinite(best_loss["val_loss"])
    margs = jcommon.load_model_args(str(tmp_path / "r.npz"))
    assert (margs["lstm_backend"], margs["two_cell"], margs["fusion"]) == (
        "pallas", False, [True, True, True])
    args = tcli.build_parser().parse_args([*argv[:-1], str(tmp_path / "proj")])
    args.fusion = [True, False, False]
    _, best_loss = tcli.train(args)
    assert np.isfinite(best_loss["loss"]) and np.isfinite(best_loss["val_loss"])
    margs = jcommon.load_model_args(str(tmp_path / "proj" / "r.npz"))
    assert (margs["lstm_backend"], margs["two_cell"], margs["fusion"]) == (
        "pallas", False, [True, False, False])


def test_wide_bf16_pallas_pins_the_proj_only_rung(monkeypatch):
    """``cl_vrnn_train --lstm_backend pallas --intermediate_dim 2048`` with
    ``bf16_compute`` (set on the namespace: neither CLI has the flag; JAX
    ``--lstm_backend auto`` sets it on a TPU) pins fusion (T, F, F), the
    args.json JAX auto writes at that width, and ``two_cell`` on, where the
    port's H100 gate measured the two-cell route faster (JAX writes it off
    there; both routes compute the same function, and a checkpoint reloads
    onto the route its args.json names). Checked where the run builds its
    model, without training at that width."""
    args = tcli.build_parser().parse_args(
        ["r", "--device", "cpu", "--train_file", CORPUS, "--seq_length", "4",
         "--intermediate_dim", "2048", "--batch_size", "1000", "--lstm_backend", "pallas"])
    args.bf16_compute = True
    class Built(Exception):
        pass

    def stop(generator, cfg):
        raise Built(cfg)

    monkeypatch.setattr(tcli.cl_vrnn, "init", stop)
    with pytest.raises(Built) as built:
        tcli.train(args)
    cfg = built.value.args[0]
    assert (cfg.intermediate_dim, cfg.lstm_backend, cfg.bf16_compute, cfg.fusion,
            cfg.two_cell) == (2048, "pallas", True, (True, False, False), True)
    assert (args.fusion, args.two_cell) == ([True, False, False], True)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    args = tcli.build_parser().parse_args(["r", "--train_file", CORPUS])
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.train(args)
