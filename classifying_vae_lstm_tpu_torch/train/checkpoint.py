"""Checkpoint loading: the ``<run>.json`` + ``<run>.npz`` contract.

Reads what ``classifying_vae_lstm_tpu/train/checkpoint.py`` writes: the
``.npz`` holds the flattened parameter tree under ``a/b`` keys and the
``.json`` beside it the full argparse namespace of the training run. The
tree comes back as nested dicts of NumPy arrays; :func:`..weights.params_from_numpy`
turns it into tensors on a device. Saving waits for the training slice.
"""

from __future__ import annotations

import json

import numpy as np


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path_npz) -> dict:
    """Read a parameter tree (nested dicts of NumPy arrays) from ``.npz``."""
    with np.load(path_npz) as f:
        return _unflatten({k: np.asarray(f[k]) for k in f.files})


def load_model_args(model_file) -> dict:
    """Read the args namespace stored next to a weights file."""
    json_path = model_file.replace(".npz", ".json").replace(".h5", ".json")
    with open(json_path) as f:
        return json.load(f)
