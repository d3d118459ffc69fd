"""Checkpoints: the ``<run>.json`` + ``<run>.yaml`` + ``<run>.npz`` contract.

Reads and writes what ``classifying_vae_lstm_tpu/train/checkpoint.py``
does, so either package loads the other's files: the ``.npz`` holds the
flattened parameter tree under ``a/b`` keys, ``<run>.json`` the JSON-able
part of the training run's argparse namespace, ``<run>.yaml`` the shape of
every parameter (JSON, which is valid YAML). The tree comes back as nested
dicts of NumPy arrays; :func:`..weights.params_from_numpy` turns it into
tensors on a device. Optimizer state (``<run>.opt.npz``, for ``--resume``)
is not written yet.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


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


def save_checkpoint(path_npz, params) -> None:
    """Write the parameter tree (tensors or arrays) as ``.npz``."""
    np.savez(path_npz, **_flatten(params))


def save_model_in_pieces(params, args, model_dir=None, run_name=None) -> str:
    """Write ``<run>.yaml`` (parameter shapes) and ``<run>.json`` (the
    JSON-able args); ``args`` is an argparse Namespace or a dict. Returns the
    ``<run>.npz`` path the weights go to."""
    d = vars(args) if not isinstance(args, dict) else args
    model_dir = model_dir or d["model_dir"]
    run_name = run_name or d["run_name"]
    os.makedirs(model_dir, exist_ok=True)
    arch = {k: list(np.shape(v)) for k, v in _flatten(params).items()}
    with open(os.path.join(model_dir, run_name + ".yaml"), "w") as f:
        json.dump(arch, f, indent=2)  # JSON is valid YAML
    with open(os.path.join(model_dir, run_name + ".json"), "w") as f:
        json.dump({k: v for k, v in d.items() if _json_ok(v)}, f)
    return os.path.join(model_dir, run_name + ".npz")


def _json_ok(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def load_model_args(model_file) -> dict:
    """Read the args namespace stored next to a weights file."""
    json_path = model_file.replace(".npz", ".json").replace(".h5", ".json")
    with open(json_path) as f:
        return json.load(f)
