"""Shared CLI plumbing: model (re)construction and loading.

The checkpoint contract is the JAX package's: ``<run>.json`` is the
training run's argparse namespace and becomes the model config, ``<run>.npz``
holds the weights.
"""

from __future__ import annotations

import dataclasses

from ..models import cl_vrnn
from ..train.checkpoint import load_checkpoint, load_model_args

# the corpus shipped with the repository (seed windows for serving)
DEFAULT_TRAIN_FILE = "data/input/Piano-midi_all.pickle"

CL_VAE_TODO = "the cl_vae family is not ported yet (ROADMAP Queue 1 item 11)"


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
    """The ``--lstm_backend`` flag. ``auto`` and ``keep`` keep the
    checkpoint's numerics (f32 unless it trained with ``bf16_compute``); an
    explicit name is recorded in the config. Generation on the card always
    runs the CUDA kernel whatever the name, and the CPU its plain version."""
    if choice in ("auto", "keep"):
        return cfg
    return dataclasses.replace(cfg, lstm_backend=choice)


def load_model(model_file: str, family: str, no_x_prev: bool = False):
    """args.json + weights -> (params as nested NumPy dicts, cfg, margs)."""
    if family != "cl_vrnn":
        raise NotImplementedError(CL_VAE_TODO)
    margs = load_model_args(model_file)
    if no_x_prev or "use_x_prev" not in margs:
        margs["use_x_prev"] = False
    cfg = cl_vrnn_config_from_args(margs)
    weights_file = model_file if model_file.endswith(".npz") else model_file.replace(".h5", ".npz")
    return load_checkpoint(weights_file), cfg, margs
