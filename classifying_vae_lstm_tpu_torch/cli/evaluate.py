"""Evaluate a trained model's test NLL (importance-sampled, nats/frame); run as

    python -m classifying_vae_lstm_tpu_torch.cli.evaluate -i <model.npz>

Flag for flag the JAX package's ``cli/evaluate.py``, with two exceptions:
``--train_file`` defaults to the corpus shipped with the repository, and
``--device`` (``cuda``, the default, or ``cpu``) picks where the run goes.
For cl_vrnn, ``--lstm_backend pallas`` runs both LSTMs through the
whole-sequence inference kernel (``ops/lstm_seq.py``; its plain version on
the CPU), ``xla`` through plain PyTorch, ``keep`` (the default) as the
checkpoint trained. The cl_vae estimator runs the model's plain dense
layers, as the JAX one does; a seq-concat checkpoint is pruned with the
mask of its training-time batching, and a vanilla one (``n_classes == 1``)
has its key labels collapsed to 0. ``--dp N`` (N > 1) splits each batch
over N devices (``iw_nll_dataset_dp``: the first N cards, or the CPU N times with
``--device cpu``), each shard keeping the checkpoint's route; the JAX
package turns ``pallas`` into ``xla`` there because XLA cannot partition
its Pallas call, a limit the port does not have. Prints one JSON line, the
JAX package's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData
from ..evaluation.nll import iw_nll_dataset, iw_nll_dataset_dp
from ..train.checkpoint import load_model_args
from ..weights import params_from_numpy
from . import common


def evaluate(args):
    mesh = common.dp_mesh(args) if args.dp > 1 else None
    if args.family == "auto":
        # cl_vae checkpoints carry intermediate_class_dim; cl_vrnn ones don't
        margs_probe = load_model_args(args.model_file)
        args.family = "cl_vae" if "intermediate_class_dim" in margs_probe else "cl_vrnn"
    raw, cfg, margs = common.load_model(args.model_file, args.family)
    device = resolve_device(args.device)
    # batch_size=1: PianoData truncates every split to a multiple of its
    # batch_size; the estimator pads the final batch itself, so the NLL
    # covers every test window
    y_next = margs.get("predict_next", False) or margs.get("use_x_prev", False)
    if args.family == "cl_vae":
        P = PianoData(args.train_file, batch_size=1, seq_length=margs["seq_length"],
                      return_y_next=y_next, squeeze_x=True, squeeze_y=True)
        if margs["seq_length"] > 1:
            # prune with the mask the training run computed: rebuild its
            # batching (the truncation changes which windows vote)
            dim = common.prune_and_flatten_cl_vae(P, margs["seq_length"],
                                                  common.seq_concat_mask(args.train_file, margs))
            if dim != margs["original_dim"]:
                raise ValueError(f"pruned width {dim} != checkpoint original_dim "
                                 f"{margs['original_dim']}: was the model trained on another "
                                 "--train_file?")
        if margs["n_classes"] == 1:  # vanilla VAE: key labels collapse to 0
            for split in ("train", "valid", "test"):
                setattr(P, f"{split}_song_keys", np.zeros_like(getattr(P, f"{split}_song_keys")))
        data = common.build_cl_vae_datasets(P, margs["n_classes"], cfg.use_x_prev, device)
    else:
        cfg = common.resolve_lstm_backend(cfg, args.lstm_backend)
        P = PianoData(args.train_file, batch_size=1, seq_length=margs["seq_length"],
                      return_y_next=y_next, return_y_hist=True, squeeze_x=False, squeeze_y=False)
        data = common.build_cl_vrnn_datasets(P, margs["n_classes"], cfg.use_x_prev, device)
    data = {k: v for k, v in data["test"].items() if k in ("x", "y", "x_prev")}
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = params_from_numpy(raw, device)
    if mesh is not None:
        nlls = iw_nll_dataset_dp(params, cfg, data, generator, args.n_samples, args.batch_size,
                                 args.family, mesh)
    else:
        nlls = iw_nll_dataset(params, cfg, data, generator, args.n_samples, args.batch_size,
                              args.family)
    out = {
        "test_nll_nats_per_frame": round(float(nlls.mean()), 4),
        "n_importance_samples": args.n_samples,
        "n_test_examples": int(len(nlls)),
        "family": args.family,
        "train_file": args.train_file,
    }
    print(json.dumps(out))
    return out


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--model_file", type=str, required=True)
    parser.add_argument("--family", type=str, default="auto",
                        choices=["auto", "cl_vae", "cl_vrnn"])
    parser.add_argument("--n_samples", type=int, default=64, help="importance samples per datapoint")
    parser.add_argument("--batch_size", type=int, default=200)
    parser.add_argument("--train_file", type=str, default=common.DEFAULT_TRAIN_FILE)
    parser.add_argument("--seed", type=int, default=0, help="seed of the torch.Generator")
    parser.add_argument("--dp", type=int, default=1,
                        help="split each batch over N > 1 devices (the first N cards, or the "
                             "CPU N times with --device cpu); 1: one device")
    parser.add_argument("--lstm_backend", type=str, default="keep",
                        choices=["keep", "auto", "xla", "pallas"],
                        help="'keep' = the checkpoint's setting; 'pallas' = the whole-sequence "
                             "CUDA kernels (plain versions on the CPU); 'xla' and 'auto' = "
                             "plain PyTorch")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the card (raises without one); cpu: plain PyTorch")
    return parser


def _main():
    evaluate(build_parser().parse_args())


if __name__ == "__main__":
    _main()
