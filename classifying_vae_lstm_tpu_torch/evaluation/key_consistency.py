"""Key-consistency metric: does the w latent steer the key? (pure NumPy)

Copy of ``classifying_vae_lstm_tpu/evaluation/key_consistency.py``. The
paper's claim is that conditioning on the key latent w makes the model
generate in that key; this module measures it: for a generated piano roll,
the fraction of note cells whose pitch class lies in the conditioned key's
major scale, against the same fraction for the other keys. A positive
margin means w steers the output.
"""

from __future__ import annotations

import numpy as np

from ..data.pianoroll import relative_major

# tonic pitch class for each key name the corpus uses (C=0 ... B=11);
# '-' is flat, '#' is sharp; lowercase (minor) handled via relative major
_TONIC = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_MAJOR_SCALE = np.array([0, 2, 4, 5, 7, 9, 11])


def key_to_pitch_classes(key_name: str) -> np.ndarray:
    """Major-scale pitch classes for a key name like 'C', 'B-', 'F#'."""
    key_name = relative_major(key_name)
    tonic = _TONIC[key_name[0].upper()]
    for ch in key_name[1:]:
        tonic += {"#": 1, "-": -1}[ch]
    return (_MAJOR_SCALE + tonic) % 12


def in_scale_fraction(roll: np.ndarray, key_name: str, offset: int = 21) -> float:
    """Fraction of active note-cells of ``roll [T, 88]`` inside the key's scale."""
    roll = np.asarray(roll)
    t, p = np.nonzero(roll)
    if len(p) == 0:
        return float("nan")
    pitch_classes = (p + offset) % 12
    scale = set(key_to_pitch_classes(key_name).tolist())
    return float(np.mean([pc in scale for pc in pitch_classes]))


def key_consistency_report(rolls, key_names, all_keys=None) -> dict:
    """Mean in-scale fraction for the conditioned keys vs mismatched keys.

    rolls: list/array of [T, 88] rolls; key_names: the key each was
    conditioned on. Returns {"conditioned": float, "mismatched": float,
    "margin": float} — a positive margin means w steers the output.
    """
    all_keys = list(all_keys or sorted(set(key_names)))
    cond, mism = [], []
    for roll, key in zip(rolls, key_names):
        cond.append(in_scale_fraction(roll, key))
        others = [in_scale_fraction(roll, k) for k in all_keys if k != key]
        if others:
            mism.append(float(np.nanmean(others)))
    out = {
        "conditioned": float(np.nanmean(cond)),
        "mismatched": float(np.nanmean(mism)) if mism else float("nan"),
    }
    out["margin"] = out["conditioned"] - out["mismatched"]
    return out
