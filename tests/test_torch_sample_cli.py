"""The port's sample CLIs on the CPU (plain samplers): their parsers against
the JAX package's, and the MIDI (and WAV) files they write, parsed back by
the JAX package's reader."""

import os
import wave

import numpy as np
import pytest

from classifying_vae_lstm_tpu.cli import cl_vae_sample as j_vae_cli
from classifying_vae_lstm_tpu.cli import cl_vrnn_sample as j_vrnn_cli
from classifying_vae_lstm_tpu.data.midi import midi_to_roll as j_midi_to_roll
from classifying_vae_lstm_tpu.data.midi import read_midi_roll as j_read_midi_roll
from classifying_vae_lstm_tpu.data.wav import render_roll as j_render_roll
from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, cl_vae_train, cl_vrnn_sample
from classifying_vae_lstm_tpu_torch.cli import common
from classifying_vae_lstm_tpu_torch.data import PianoData, read_midi_roll, render_roll, write_sample
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae

CS = "data/input/Piano-midi_Cs.pickle"


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_cli", [(cl_vae_sample, j_vae_cli),
                                          (cl_vrnn_sample, j_vrnn_cli)])
def test_parser_matches_jax(port, jax_cli):
    """Every dest of the JAX parser with its default; the port adds
    ``--device`` and defaults ``--train_file`` to the committed corpus."""
    got, want = _defaults(port.build_parser()), _defaults(jax_cli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest in set(want) - {"train_file"}:
        assert got[dest] == want[dest], dest
    assert got["device"] == "cuda" and os.path.exists(got["train_file"])
    opts = lambda p: {s for a in p._actions for s in a.option_strings}
    assert opts(port.build_parser()) == opts(jax_cli.build_parser()) | {"--device"}


def _check_files(samples, outdir, names, doubled=True):
    """Each sample's MIDI parses back (JAX reader) into its frames; trailing
    silent frames are not representable in the format."""
    for roll, name in zip(samples, names):
        path = os.path.join(outdir, name + ".mid")
        want = np.repeat(roll, 2, axis=0) if doubled else roll
        got = j_read_midi_roll(path)
        np.testing.assert_array_equal(got, want[: len(got)])
        assert not want[len(got):].any()
        np.testing.assert_array_equal(read_midi_roll(path), got)


@pytest.mark.parametrize("extra", [[], ["--infer_w"], ["--use_z_prior", "--write_wav"]])
def test_cl_vae_sample_writes_midi(tmp_path, extra):
    args = cl_vae_sample.build_parser().parse_args(
        ["run", "-i", "artifacts/jsbcs_vae.npz", "--train_file", CS, "-n", "2", "-t", "16",
         "--sample_dir", str(tmp_path), "--device", "cpu", *extra])
    samples = cl_vae_sample.sample(args)
    assert samples.shape == (2, 16, 88) and set(np.unique(samples)) <= {0.0, 1.0}
    assert samples.any()
    _check_files(samples, tmp_path, ["run_0", "run_1"])
    if "--write_wav" in extra:
        with wave.open(str(tmp_path / "run_1.wav")) as f:
            assert f.getnframes() == 2 * 16 * int(round(0.25 * f.getframerate()))
    else:
        assert not list(tmp_path.glob("*.wav"))


def train_cl_vae(model_dir, hidden, run="ckpt"):
    """A two-epoch cl_vae checkpoint (the first epoch saves none) of the port's CLI on the CPU (hidden
    ``hidden``, 2 keys); returns its path."""
    cl_vae_train.train(cl_vae_train.build_parser().parse_args(
        [run, "--device", "cpu", "--train_file", CS, "--intermediate_dim", str(hidden),
         "--intermediate_class_dim", "16", "--latent_dim", "2", "--batch_size", "2000",
         "--num_epochs", "2", "--patience", "0", "--use_x_prev", "--model_dir", str(model_dir)]))
    return str(model_dir / f"{run}.npz")


@pytest.mark.parametrize("hidden", [256, 0])
def test_cl_vae_sample_takes_wide_and_no_hidden_checkpoints(tmp_path, hidden):
    """Checkpoints whose weights one block does not hold (hidden 256 in f32:
    the cluster kernel on two blocks) and without hidden layers sample
    through the cluster kernel's route; on the CPU, its plain version."""
    ckpt = train_cl_vae(tmp_path, hidden)
    _, cfg, _ = common.load_model(ckpt, "cl_vae")
    assert cuda_generate_vae.kernel_for(cfg) == "generate_cl_vae_cluster"
    assert cuda_generate_vae.cluster_plan(cfg, 2)["C"] == (2 if hidden else 1)
    out = tmp_path / "samples"
    args = cl_vae_sample.build_parser().parse_args(
        ["run", "-i", ckpt, "--train_file", CS, "-n", "2", "-t", "12", "--sample_dir", str(out),
         "--device", "cpu"])
    samples = cl_vae_sample.sample(args)
    assert samples.shape == (2, 12, 88) and set(np.unique(samples)) <= {0.0, 1.0}
    _check_files(samples, out, ["run_0", "run_1"])


def test_cl_vae_sample_from_midi_and_wav_matches_jax(tmp_path):
    roll = np.zeros((7, 88), np.float32)
    roll[:, [39, 43]] = 1.0
    roll[-1, [40, 47]] = 1.0
    write_sample(roll, str(tmp_path), "seed")
    args = cl_vae_sample.build_parser().parse_args(
        ["midi", "-i", "artifacts/jsbcs_vae.npz", "--train_file", CS, "-n", "3", "-t", "8",
         "--sample_dir", str(tmp_path), "--device", "cpu", "--seed_midi",
         str(tmp_path / "seed.mid")])
    seeds, w_vals = cl_vae_sample.gather_seeds(None, {"original_dim": 88}, args, None)
    assert w_vals is None and seeds.shape == (3, 88)
    # the file's last frame on the eighth-note grid, as the JAX CLI reads it
    np.testing.assert_array_equal(seeds[1], j_midi_to_roll(str(tmp_path / "seed.mid"))[-1])
    samples = cl_vae_sample.sample(args)
    _check_files(samples, tmp_path, [f"midi_{i}" for i in range(3)])
    np.testing.assert_allclose(render_roll(samples[0][:4]), j_render_roll(samples[0][:4]))


def test_cl_vrnn_sample_writes_midi(tmp_path):
    """jsball_vrnn4 on Piano-midi_Cs: key-filtered true-key seeds, then
    per-seed discrete inferred w, then seeding from the first run's MIDI."""
    base = ["run", "-i", "artifacts/jsball_vrnn4.npz", "--train_file", CS, "-t", "16",
            "--sample_dir", str(tmp_path), "--device", "cpu"]
    parse = cl_vrnn_sample.build_parser().parse_args
    samples = cl_vrnn_sample.sample(parse(base + ["-n", "2", "-c", "E-"]))
    assert samples.shape == (2, 16, 88) and set(np.unique(samples)) <= {0.0, 1.0}
    _check_files(samples, tmp_path, ["run_0", "run_1"], doubled=False)
    seed_files = sorted(tmp_path.glob("run*_seed_*.mid"))
    assert len(seed_files) == 2
    # the seeds are test windows of the named key
    P = PianoData(CS, batch_size=1, seq_length=16, squeeze_x=False)
    for f in seed_files:
        i = int(f.stem.split("_seed_")[1])
        assert P.test_song_keys[i] == P.key_map["E-"]
        _check_files([P.x_test[i]], tmp_path, [f.stem], doubled=False)

    samples = cl_vrnn_sample.sample(parse(base + ["-n", "3", "--infer_w", "--discrete_w"]))
    assert samples.shape == (3, 16, 88)
    _check_files(samples, tmp_path, [f"run_{j}" for j in range(3)], doubled=False)
    assert cl_vrnn_sample.sample(parse(base + ["-c", "G"])) is None  # no such seeds

    seed = str(tmp_path / "run_0.mid")
    out = tmp_path / "from_midi"
    for extra in ([], ["-c", "C"]):
        args = parse(base + ["-n", "2", "--seed_midi", seed, "--sample_dir", str(out), *extra])
        samples = cl_vrnn_sample.sample(args)
        assert samples.shape == (2, 16, 88)
        _check_files(samples, out, ["run_0", "run_1"], doubled=False)
    with pytest.raises(ValueError, match="unknown key"):
        cl_vrnn_sample.sample(parse(base + ["--seed_midi", seed, "-c", "Q"]))


def test_jsb_corpora_write_at_half_speed(tmp_path, monkeypatch):
    """A train file whose name says JSB doubles every frame, as the JAX CLI
    does (only the name is read)."""
    args = cl_vrnn_sample.build_parser().parse_args(
        ["run", "-i", "artifacts/jsball_vrnn4.npz", "--train_file", CS, "-t", "8", "-n", "1",
         "--sample_dir", str(tmp_path), "--device", "cpu"])
    P = PianoData(CS, batch_size=1, seq_length=8, squeeze_x=False)
    monkeypatch.setattr(cl_vrnn_sample, "PianoData", lambda *a, **k: P)
    args.train_file = "JSB Chorales_Cs.pickle"
    samples = cl_vrnn_sample.sample(args)
    _check_files(samples, tmp_path, ["run_0"], doubled=True)
