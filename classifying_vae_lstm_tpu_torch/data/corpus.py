"""Corpus assembly: a directory of raw .mid files -> the reference schema.

Copy of ``classifying_vae_lstm_tpu/data/corpus.py``. ``--train_file`` may
name a directory of ``.mid`` files: :class:`.pianoroll.PianoData` builds
the ``{split, split_key, split_mode}`` dict of the pickled corpora in memory
with :func:`corpus_from_midi_dir`, so windows, key labels and the
relative-major mapping downstream are the same.

Deterministic 70/15/15 split over the sorted file list (or explicit lists);
keys from key-signature metas or Krumhansl-Schmuckler; an optional
transpose-to-C variant mirroring the ``_Cs`` corpora.
"""

from __future__ import annotations

import os
import sys

from .midi import key_from_midi, parse_smf, quantize_notes

_PITCH_CLASS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def key_pitch_class(key: str) -> int:
    pc = _PITCH_CLASS[key[0].upper()]
    if key.endswith("#"):
        pc += 1
    elif key.endswith("-"):
        pc -= 1
    return pc % 12


def transpose_song(song, key: str):
    """Shift a song to C major / c minor; returns (song, new_key)."""
    pc = key_pitch_class(key)
    shift = -pc if pc <= 6 else 12 - pc  # within [-6, +5]
    return ([[n + shift for n in frame] for frame in song],
            "c" if key.islower() else "C")


def corpus_from_midi_dir(midi_dir: str, split_lists=None, frames_per_beat: int = 2,
                         transpose_to_c: bool = False) -> dict:
    """Build the reference pickle schema from a directory of .mid files."""
    files = sorted(f for f in os.listdir(midi_dir)
                   if f.lower().endswith((".mid", ".midi")))
    if not files:
        raise ValueError(f"no .mid files in {midi_dir}")
    songs, keys = {}, {}
    for f in files:
        with open(os.path.join(midi_dir, f), "rb") as fh:
            division, notes, key_sig = parse_smf(fh.read())
        song = quantize_notes(division, notes, frames_per_beat)
        if not song:
            print(f"skipping empty {f}", file=sys.stderr)
            continue
        songs[f] = song
        keys[f] = key_from_midi(key_sig, notes)

    names = sorted(songs)
    if split_lists:
        split = {s: [n for n in split_lists[s] if n in songs]
                 for s in ("train", "valid", "test")}
    else:  # deterministic 70/15/15 over the sorted list
        n = len(names)
        n_tr, n_va = int(0.7 * n), int(0.15 * n)
        split = {"train": names[:n_tr], "valid": names[n_tr : n_tr + n_va],
                 "test": names[n_tr + n_va :]}

    D = {}
    for s in ("train", "valid", "test"):
        D[s] = [songs[f] for f in split[s]]
        D[f"{s}_key"] = [keys[f] for f in split[s]]
        D[f"{s}_mode"] = [not keys[f].islower() for f in split[s]]
    return transpose_corpus(D) if transpose_to_c else D


def transpose_corpus(D: dict) -> dict:
    """The ``_Cs`` variant: every piece shifted to C major / c minor."""
    out = {}
    for s in ("train", "valid", "test"):
        pairs = [transpose_song(song, key) for song, key in zip(D[s], D[f"{s}_key"])]
        out[s] = [p[0] for p in pairs]
        out[f"{s}_key"] = [p[1] for p in pairs]
        out[f"{s}_mode"] = list(D[f"{s}_mode"])
    return out
