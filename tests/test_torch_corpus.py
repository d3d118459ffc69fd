"""The port's MIDI-directory corpus and key labelling vs the JAX package's.

On the 120 synthetic Piano-midi files committed under
``data/input/pm_synth_midi``: ``corpus_from_midi_dir``, with and without
the transpose to C, equals the JAX package's dict (songs, key names,
modes, split); ``PianoData`` on the directory gives the JAX package's
arrays, labels and key map; ``estimate_key`` and ``key_from_midi`` give
the JAX labels on every file, with and without its key-signature meta.
"""

import os

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.data import PianoData as JPianoData
from classifying_vae_lstm_tpu.data import corpus as jcorpus
from classifying_vae_lstm_tpu.data import midi as jmidi
from classifying_vae_lstm_tpu_torch.data import PianoData as TPianoData
from classifying_vae_lstm_tpu_torch.data import corpus as tcorpus
from classifying_vae_lstm_tpu_torch.data import midi as tmidi

MIDI_DIR = "data/input/pm_synth_midi"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("transpose", [False, True], ids=["as_is", "to_c"])
def test_corpus_from_midi_dir_matches_jax(transpose):
    got = tcorpus.corpus_from_midi_dir(MIDI_DIR, transpose_to_c=transpose)
    want = jcorpus.corpus_from_midi_dir(MIDI_DIR, transpose_to_c=transpose)
    assert got == want
    assert [len(got[s]) for s in ("train", "valid", "test")] == [84, 18, 18]


def test_corpus_split_lists_and_empty_dir_match_jax(tmp_path):
    names = sorted(os.listdir(MIDI_DIR))
    lists = {"train": names[5:9], "valid": names[:2] + ["missing.mid"], "test": names[40:41]}
    assert (tcorpus.corpus_from_midi_dir(MIDI_DIR, split_lists=lists)
            == jcorpus.corpus_from_midi_dir(MIDI_DIR, split_lists=lists))
    with pytest.raises(ValueError, match="no .mid files"):
        tcorpus.corpus_from_midi_dir(str(tmp_path))


@pytest.mark.parametrize("seq_length,y_hist", [(16, True), (1, False)])
def test_pianodata_from_the_directory_matches_jax(seq_length, y_hist):
    kw = dict(batch_size=100, seq_length=seq_length, return_y_hist=y_hist,
              squeeze_x=seq_length == 1, squeeze_y=seq_length == 1)
    got, want = TPianoData(MIDI_DIR, **kw), JPianoData(MIDI_DIR, **kw)
    assert got.key_map == want.key_map and len(got.key_map) == 13
    for split in ("train", "valid", "test"):
        for attr in (f"x_{split}", f"y_{split}", f"{split}_song_inds", f"{split}_song_keys",
                     f"{split}_song_modes"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)


def test_key_labels_match_jax():
    for f in sorted(os.listdir(MIDI_DIR)):
        with open(os.path.join(MIDI_DIR, f), "rb") as fh:
            _, notes, key_sig = tmidi.parse_smf(fh.read())
        assert tmidi.estimate_key(notes) == jmidi.estimate_key(notes), f
        assert tmidi.key_from_midi(key_sig, notes) == jmidi.key_from_midi(key_sig, notes), f
        assert tmidi.key_from_midi(None, notes) == jmidi.key_from_midi(None, notes), f
    for sf in range(-7, 8):
        for mi in (0, 1):
            assert tmidi.key_from_midi((sf, mi), []) == jmidi.key_from_midi((sf, mi), [])
    assert tmidi.estimate_key([]) == "C"


@pytest.mark.parametrize("key", ["C", "F#", "B-", "g#", "e-", "A", "c"])
def test_transpose_song_matches_jax(key):
    song = [[60, 64, 67], [], [62, 71]]
    assert tcorpus.key_pitch_class(key) == jcorpus.key_pitch_class(key)
    assert tcorpus.transpose_song(song, key) == jcorpus.transpose_song(song, key)
