"""The port's key-consistency metric and CLI vs the JAX package.

* ``key_to_pitch_classes``, ``in_scale_fraction`` and
  ``key_consistency_report`` on the same inputs: equal exactly (the same
  NumPy code).
* ``cli.key_consistency`` on ``artifacts/pm_configs/c5m.npz`` (13 keys,
  ``Piano-midi_all``) at ``-n 2 -t 16``: the JAX CLI as it runs, and the
  port's with each key's noise the JAX CLI draws (``draw_generation_noise``
  of ``PRNGKey(kidx)``) handed in through ``run``'s ``noise_fn``; the
  reports within 1e-6 (same frames: f32 sums in another order only move a
  frame at a near-tie, which these draws do not meet), ``corpus_ceiling``
  and ``n_songs`` exactly.
* The parser against the JAX one (same dests and defaults, plus
  ``--device``; the ``--train_file`` default is the committed corpus); a
  key at or past the checkpoint's ``n_classes`` raises.
"""

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import key_consistency as jcli
from classifying_vae_lstm_tpu.evaluation import key_consistency as jkc
from classifying_vae_lstm_tpu.sampling.generate import draw_generation_noise
from classifying_vae_lstm_tpu_torch.cli import key_consistency as tcli
from classifying_vae_lstm_tpu_torch.evaluation import key_consistency as tkc

KEYS = ["C", "D-", "D", "E-", "E", "F", "F#", "G", "G-", "A-", "A", "B-", "B", "C-",
        "a", "b-", "c#", "d", "e-", "f#", "g#"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("key", KEYS)
def test_key_to_pitch_classes_matches_jax(key):
    np.testing.assert_array_equal(tkc.key_to_pitch_classes(key), jkc.key_to_pitch_classes(key))


def test_in_scale_fraction_and_report_match_jax():
    rng = np.random.default_rng(0)
    rolls = [(rng.random((24, 88)) < p).astype(np.float32) for p in (0.05, 0.1, 0.0, 0.2)]
    names = ["C", "F#", "a", "B-"]
    for roll in rolls:
        for key in names:
            a, b = tkc.in_scale_fraction(roll, key), jkc.in_scale_fraction(roll, key)
            assert a == b or (np.isnan(a) and np.isnan(b))
    assert tkc.key_consistency_report(rolls, names) == jkc.key_consistency_report(rolls, names)
    assert (tkc.key_consistency_report(rolls, names, all_keys=KEYS)
            == jkc.key_consistency_report(rolls, names, all_keys=KEYS))


def test_parser_matches_jax():
    argv = ["-i", "m.npz"]
    t = vars(tcli.build_parser().parse_args(argv))
    j = vars(jcli.build_parser().parse_args(argv))
    assert t.pop("device") == "cuda"
    assert t.pop("train_file") == "data/input/Piano-midi_all.pickle"
    j.pop("train_file")
    assert t == j


def test_cli_on_c5m_matches_jax(capsys):
    argv = ["-i", "artifacts/pm_configs/c5m.npz", "-n", "2", "-t", "16", "--train_file",
            "data/input/Piano-midi_all.pickle"]
    want = jcli.run(jcli.build_parser().parse_args(argv))
    capsys.readouterr()
    keys = []

    def jax_noise(kidx, B, total, L, D):
        keys.append(kidx)
        eps, u = draw_generation_noise(jax.random.PRNGKey(kidx), B, total, L, D)
        return torch.from_numpy(np.array(eps)), torch.from_numpy(np.array(u))

    got = tcli.run(tcli.build_parser().parse_args([*argv, "--device", "cpu"]),
                   noise_fn=jax_noise)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(got) == {"conditioned", "mismatched", "margin", "corpus_ceiling", "n_songs"}
    assert printed.startswith('{"conditioned": ')
    assert keys == sorted(keys) and len(keys) == 13
    assert got["corpus_ceiling"] == want["corpus_ceiling"]
    assert got["n_songs"] == want["n_songs"] == 26
    for k in ("conditioned", "mismatched", "margin"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["margin"] > 0


def test_key_past_n_classes_raises():
    """jsball_vrnn4 has 10 key classes; Piano-midi_all labels 13 keys."""
    args = tcli.build_parser().parse_args(["-i", "artifacts/jsball_vrnn4.npz", "-n", "1", "-t",
                                           "1", "--seed_len", "16", "--device", "cpu"])
    with pytest.raises(ValueError, match="n_classes=10"):
        tcli.run(args)
