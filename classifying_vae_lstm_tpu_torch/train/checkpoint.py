"""Checkpoints: the ``<run>.json`` + ``<run>.yaml`` + ``<run>.npz`` contract.

Reads and writes what ``classifying_vae_lstm_tpu/train/checkpoint.py``
does, so either package loads the other's files: the ``.npz`` holds the
flattened parameter tree under ``a/b`` keys, ``<run>.json`` the JSON-able
part of the training run's argparse namespace, ``<run>.yaml`` the shape of
every parameter (JSON, which is valid YAML). The tree comes back as nested
dicts of NumPy arrays; :func:`..weights.params_from_numpy` turns it into
tensors on a device. The optimizer state of a resumable run goes to
``<run>.opt.npz`` in the JAX layout too: ``leaf_0 … leaf_n`` in the order of
``jax.tree.leaves`` of the JAX optimizer's state, and ``__epoch__``, so a
run moves between the packages in both directions. Column-sharded
parameters and their optimizer state are written whole, so a
tensor-parallel run's files are the replicated run's. The orbax variants of
the JAX module are not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..parallel.columns import ColumnShards


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, ColumnShards):  # tensor-parallel: written whole
        out[prefix[:-1]] = tree.numpy()
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


def sorted_leaves(tree) -> list:
    """The leaves of a parameter tree in ``jax.tree.leaves`` order: the keys
    of every dict sorted, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    return [tree]


def save_checkpoint(path_npz, params, opt_state=None, epoch: int | None = None) -> None:
    """Write the parameter tree (tensors or arrays) as ``.npz``; with
    ``opt_state`` (the optimizer's leaves in the JAX order,
    :meth:`..optim.adamwn.LeafOptimizer.state_leaves`) also
    ``<run>.opt.npz`` with ``epoch`` under ``__epoch__``."""
    np.savez(path_npz, **_flatten(params))
    if opt_state is not None:
        flat = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(opt_state)}
        if epoch is not None:
            flat["__epoch__"] = np.asarray(epoch)
        np.savez(path_npz.replace(".npz", ".opt.npz"), **flat)


def load_opt_state(path_opt_npz) -> tuple[list, int]:
    """Read the optimizer state written by :func:`save_checkpoint` (or by the
    JAX package's): (the leaves in order, as NumPy arrays; the epoch it was
    written at, 0 if unrecorded). The optimizer takes the leaves with
    :meth:`..optim.adamwn.LeafOptimizer.load_state_leaves`."""
    with np.load(path_opt_npz) as f:
        epoch = int(f["__epoch__"]) if "__epoch__" in f.files else 0
        n = len([k for k in f.files if k.startswith("leaf_")])
        leaves = [np.asarray(f[f"leaf_{i}"]) for i in range(n)]
    return leaves, epoch


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
