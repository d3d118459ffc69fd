"""Shared CLI plumbing: dataset assembly, model (re)construction, loading.

The checkpoint contract is the JAX package's: ``<run>.json`` is the
training run's argparse namespace and becomes the model config, ``<run>.npz``
holds the weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import PianoData
from ..data.pianoroll import to_categorical
from ..models import cl_vae, cl_vrnn
from ..train.checkpoint import load_checkpoint, load_model_args

# the corpus shipped with the repository (training data, seed windows for serving)
DEFAULT_TRAIN_FILE = "data/input/Piano-midi_all.pickle"


# flags of the JAX train CLIs whose modules the port does not have yet
UNPORTED_FLAGS = {
    "dp": "--dp (data parallelism) is not ported yet: ROADMAP Queue 1 item 14",
    "streaming": "--streaming (host-streamed batches, data/loader.py) is not ported yet: "
                 "ROADMAP Queue 1 item 7",
    "resume": "--resume (optimizer state in <run>.opt.npz) is not ported yet: "
              "ROADMAP Queue 1 item 7",
    "save_last": "--save_last (<run>.last.npz with optimizer state) is not ported yet: "
                 "ROADMAP Queue 1 item 7",
    "data_init": "--data_init (optim/data_init.py) is not ported yet: ROADMAP Queue 1 item 6",
    "check_numerics": "--check_numerics (train/debug.py) is not ported yet: "
                      "ROADMAP Queue 1 item 7",
    "do_log": "--do_log (utils/tb_events.py) is not ported yet: ROADMAP Queue 1 item 12",
    "trace_dir": "--trace_dir (profiler traces) is not ported yet: ROADMAP Queue 1 item 7",
}


def check_ported(args):
    """Raise ``NotImplementedError`` for a set flag of :data:`UNPORTED_FLAGS`."""
    for flag, msg in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotImplementedError(msg)


def active_pitch_mask(P: PianoData) -> np.ndarray:
    """Boolean [88] mask of the pitch columns played anywhere in all splits'
    x and y."""
    X = np.vstack([P.x_train, P.x_valid, P.x_test, P.y_train, P.y_valid, P.y_test])
    return X.sum(axis=0).sum(axis=0) > 0


def prune_and_flatten_cl_vae(P: PianoData, seq_length: int, ix: np.ndarray | None = None) -> int:
    """The cl_vae seq-concat mode: drop never-played pitch columns and
    flatten each window into one row; returns the new ``original_dim``.
    Evaluation passes ``ix``, the mask of the training-time batching (its
    truncation to the batch size changes which windows vote)."""
    if ix is None:
        ix = active_pitch_mask(P)
    for attr in ("x_train", "x_valid", "x_test", "y_train", "y_valid", "y_test"):
        a = getattr(P, attr)
        setattr(P, attr, np.ascontiguousarray(a[:, :, ix].reshape((len(a), -1))))
    return int(ix.sum()) * seq_length


def build_cl_vrnn_datasets(P: PianoData, n_classes: int, use_x_prev: bool, device) -> dict:
    """Per-split dicts of tensors on ``device``: ``x``/``y`` [N, T, 88] and
    the one-hot key ``w``; with ``use_x_prev`` the model reads the next
    frames ``y`` as ``x`` and the current ones as ``x_prev``."""
    out = {}
    for split in ("train", "valid", "test"):
        x = getattr(P, f"x_{split}")
        y = getattr(P, f"y_{split}")
        w = to_categorical(getattr(P, f"{split}_song_keys"), n_classes)
        arrays = {"y": y, "w": w, **({"x": y, "x_prev": x} if use_x_prev else {"x": x})}
        out[split] = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return out


def build_cl_vae_datasets(P: PianoData, n_classes: int, use_x_prev: bool, device) -> dict:
    """The same dicts for cl_vae's single frames: ``x``/``y`` [N, D]."""
    return build_cl_vrnn_datasets(P, n_classes, use_x_prev, device)


def cl_vae_config_from_args(margs: dict) -> cl_vae.Config:
    return cl_vae.Config(
        original_dim=margs["original_dim"],
        intermediate_dim=margs["intermediate_dim"],
        latent_dim=margs["latent_dim"],
        intermediate_class_dim=margs["intermediate_class_dim"],
        n_classes=margs["n_classes"],
        use_x_prev=margs.get("use_x_prev", False),
        w_log_var_prior=margs.get("w_log_var_prior", 0.0),
        gen_backend=margs.get("gen_backend", "xla"),
        bf16_compute=margs.get("bf16_compute", False),
        train_backend=margs.get("train_backend", "xla"),
    )


def cl_vrnn_config_from_args(margs: dict) -> cl_vrnn.Config:
    return cl_vrnn.Config(
        original_dim=margs["original_dim"],
        intermediate_dim=margs["intermediate_dim"],
        latent_dim=margs["latent_dim"],
        seq_length=margs["seq_length"],
        n_classes=margs["n_classes"],
        use_x_prev=margs.get("use_x_prev", False),
        w_log_var_prior=margs.get("w_log_var_prior", 0.0),
        lstm_backend=margs.get("lstm_backend", "xla"),
        bf16_compute=margs.get("bf16_compute", False),
        # JSON stores the tuple as a list; re-tuple so the Config stays hashable
        fusion=tuple(margs["fusion"]) if margs.get("fusion") else None,
        two_cell=margs.get("two_cell", False),
    )


def resolve_lstm_backend(cfg, choice: str = "auto"):
    """The ``--lstm_backend`` flag. ``keep`` leaves the checkpoint's setting;
    ``auto`` resolves as the JAX package does off a TPU, to ``xla`` with the
    config's numerics (the JAX gate to the kernels and bf16 is a TPU
    measurement, which the port does not read); an explicit name is taken
    as it is. Generation on the card always runs its CUDA kernel whatever
    the name, and the CPU its plain version."""
    if choice == "keep":
        return cfg
    return dataclasses.replace(cfg, lstm_backend="xla" if choice == "auto" else choice)


def resolve_gen_backend(cfg, choice: str = "auto"):
    """The cl_vae ``--gen_backend`` flag, parsed as the JAX package parses
    it: ``keep`` leaves the checkpoint's setting, ``auto`` resolves as it
    does off a TPU, to ``xla`` (the JAX gate to its kernel is a TPU
    measurement, which the port does not read), and an explicit name is
    taken as it is. The choice is recorded only: generation on the card
    always runs the CUDA kernel, whose f32 mode gives the same frames as the
    scan, and the CPU its plain version."""
    if choice == "keep":
        return cfg
    return dataclasses.replace(cfg, gen_backend="xla" if choice == "auto" else choice)


def load_model(model_file: str, family: str, no_x_prev: bool = False):
    """args.json + weights -> (params as nested NumPy dicts, cfg, margs)."""
    margs = load_model_args(model_file)
    if no_x_prev or "use_x_prev" not in margs:
        margs["use_x_prev"] = False
    if family == "cl_vae":
        cfg = cl_vae_config_from_args(margs)
    else:
        cfg = cl_vrnn_config_from_args(margs)
    weights_file = model_file if model_file.endswith(".npz") else model_file.replace(".h5", ".npz")
    return load_checkpoint(weights_file), cfg, margs
