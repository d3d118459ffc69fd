"""Piano-roll data pipeline (host side, pure NumPy).

Copy of the NumPy path of ``classifying_vae_lstm_tpu/data/pianoroll.py``:
loads the pickled JSB Chorales / Piano-midi corpora (Python-2 pickles, read
with ``encoding='latin1'``) and turns them into ``[N, T, 88]`` float32 binary
window arrays, keeping the reference pipeline's two quirks:

* the sliding-window start indices are ``np.arange(n - seq_length)``, which
  drops the final valid window of each song;
* minor keys map through the relative-major table.

A directory ``train_file`` of ``.mid`` files becomes a corpus in memory
(:func:`.corpus.corpus_from_midi_dir`), as in the JAX package.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

# Relative-major mapping for minor keys (reference utils/pianoroll.py:7-22).
rel_keys = {
    "a": "C",
    "b-": "D-",
    "b": "D",
    "c": "E-",
    "c#": "E",
    "d-": "F-",
    "d": "F",
    "d#": "F#",
    "e-": "G-",
    "e": "G",
    "f": "A-",
    "f#": "A",
    "g": "B-",
    "g#": "B",
    "a-": "C-",
}


def relative_major(k: str) -> str:
    """Map a minor key (lowercase) to its relative major (reference :24-25)."""
    return k if k.isupper() else rel_keys[k]


def pianoroll_to_song(roll: np.ndarray, offset: int = 21) -> list:
    """Binary roll [T, 88] -> list of per-step MIDI note lists (reference :27-29)."""
    return [(np.where(s)[0] + offset).tolist() for s in roll]


def song_to_pianoroll(song, offset: int = 21) -> np.ndarray:
    """List of note-number tuples -> [T, 88] binary roll (reference :31-47).

    Octave-shifts the offset if the song under/overflows the 88-key range,
    exactly once in each direction, like the reference.
    """
    all_notes = [n for step in song for n in step]
    if min(all_notes) - offset < 0:
        offset -= 12
    if max(all_notes) - offset > 87:
        offset += 12
    roll = np.zeros((len(song), 88), dtype=np.float64)
    for t, notes in enumerate(song):
        roll[t, [n - offset for n in notes]] = 1.0
    return roll


def sliding_inds(n: int, seq_length: int, step_length: int) -> np.ndarray:
    """Window start indices. NOTE: drops the final valid window (reference :49-50)."""
    return np.arange(n - seq_length, step=step_length)


def sliding_window(roll: np.ndarray, seq_length: int, step_length: int = 1) -> np.ndarray:
    """[T, 88] -> [num_windows, seq_length, 88] overlapping windows (reference :52-62)."""
    starts = sliding_inds(roll.shape[0], seq_length, step_length)
    if len(starts) == 0:
        return np.array([])
    # Vectorized gather replaces the reference's per-window Python loop + dstack
    # (same result; the dstack/swapaxes dance in the reference is an identity here).
    idx = starts[:, None] + np.arange(seq_length)[None, :]
    return roll[idx]


def songs_to_pianoroll(songs, seq_length, step_length, inner_fcn=song_to_pianoroll):
    """Stack windows from all songs; returns (windows, per-window song index).

    Reference ``utils/pianoroll.py:64-71``.
    """
    rolls = [sliding_window(inner_fcn(s), seq_length, step_length) for s in songs]
    rolls = [r for r in rolls if len(r) > 0]
    inds = [i * np.ones((len(r),)) for i, r in enumerate(rolls)]
    return np.vstack(rolls), np.hstack(inds)


class PianoData:
    """Windowed piano-roll dataset with per-window key/mode labels.

    Drop-in equivalent of the reference ``PianoData`` (``utils/pianoroll.py:74-158``):
    exposes ``x_train/y_train/x_valid/y_valid/x_test/y_test``, ``*_song_inds``,
    ``*_song_keys``, ``*_song_modes`` and ``key_map``.

    Arrays are float32 (device-ready) rather than the reference's float64; values
    are exact binaries so this loses nothing.
    """

    def __init__(
        self,
        train_file,
        batch_size=None,
        seq_length=1,
        step_length=1,
        return_y_next=True,
        return_y_hist=False,
        squeeze_x=True,
        squeeze_y=True,
        use_rel_major=True,
    ):
        if os.path.isdir(train_file):
            # a directory of raw .mid files: the pickles' schema built in memory
            from .corpus import corpus_from_midi_dir

            D = corpus_from_midi_dir(train_file)
        else:
            with open(train_file, "rb") as f:
                D = pickle.load(f, encoding="latin1")
        self.train_file = train_file
        self.batch_size = batch_size  # truncates so nsamples % batch_size == 0
        self.seq_length = seq_length
        self.step_length = step_length
        self.return_y_next = return_y_next  # y is the next frame(s) of x
        self.return_y_hist = return_y_hist  # y per-timestep (3-D) instead of final frame
        self.squeeze_x = squeeze_x
        self.squeeze_y = squeeze_y
        self.use_rel_major = use_rel_major

        self.x_train, self.y_train, self.train_song_inds = self.make_xy(D["train"])
        self.x_test, self.y_test, self.test_song_inds = self.make_xy(D["test"])
        self.x_valid, self.y_valid, self.valid_song_inds = self.make_xy(D["valid"])

        if "train_mode" in D:
            self.train_song_modes = self.song_modes(D["train_mode"], self.train_song_inds)
            self.test_song_modes = self.song_modes(D["test_mode"], self.test_song_inds)
            self.valid_song_modes = self.song_modes(D["valid_mode"], self.valid_song_inds)
        if "train_key" in D:
            D = self.update_keys(D)
            self.key_map = self.make_keymap(D)
            self.train_song_keys = self.song_keys(D["train_key"], self.train_song_inds)
            self.test_song_keys = self.song_keys(D["test_key"], self.test_song_inds)
            self.valid_song_keys = self.song_keys(D["valid_key"], self.valid_song_inds)

    def make_xy(self, songs):
        """Windows + targets for one split (reference :113-130)."""
        x_rolls, song_inds = songs_to_pianoroll(
            songs, self.seq_length + int(self.return_y_next), self.step_length
        )
        x_rolls = self.adjust_for_batch_size(x_rolls)
        song_inds = self.adjust_for_batch_size(song_inds)
        if self.return_y_next:
            if self.return_y_hist:
                y_rolls = x_rolls[:, 1:, :]
            else:
                y_rolls = x_rolls[:, -1, :]
            x_rolls = x_rolls[:, :-1, :]
        else:
            y_rolls = x_rolls
        if self.squeeze_x:
            x_rolls = x_rolls.squeeze()
        if self.squeeze_y:
            y_rolls = y_rolls.squeeze()
        return (
            np.ascontiguousarray(x_rolls, dtype=np.float32),
            np.ascontiguousarray(y_rolls, dtype=np.float32),
            song_inds,
        )

    def song_modes(self, modes, song_inds):
        return np.array(modes)[song_inds.astype(int)]

    def update_keys(self, D):
        if not self.use_rel_major:
            return D
        for split in ("train", "test", "valid"):
            D[f"{split}_key"] = [relative_major(k) for k in D[f"{split}_key"]]
        return D

    def make_keymap(self, D):
        """Alphabetical key -> int map over ALL splits (reference :143-145)."""
        all_keys = np.unique(np.hstack([D["train_key"], D["test_key"], D["valid_key"]]))
        return dict(zip(all_keys, range(len(all_keys))))

    def song_keys(self, keys, song_inds):
        key_inds = [self.key_map[k] for k in keys]
        return np.array(key_inds)[song_inds.astype(int)]

    def adjust_for_batch_size(self, items):
        if self.batch_size is None:
            return items
        mod = items.shape[0] % self.batch_size
        return items[:-mod] if mod > 0 else items


def to_categorical(y, num_classes: int) -> np.ndarray:
    """Integer labels -> one-hot float32 (equivalent of keras.utils.to_categorical)."""
    y = np.asarray(y, dtype=np.int64).ravel()
    out = np.zeros((len(y), num_classes), dtype=np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out
