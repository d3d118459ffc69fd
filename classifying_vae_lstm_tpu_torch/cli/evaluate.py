"""Evaluate a trained model's test NLL (importance-sampled, nats/frame); run as

    python -m classifying_vae_lstm_tpu_torch.cli.evaluate -i <model.npz>

Flag for flag the JAX package's ``cli/evaluate.py``, with two exceptions:
``--train_file`` defaults to the corpus shipped with the repository, and
``--device`` (``cuda``, the default, or ``cpu``) picks where the run goes.
``--lstm_backend pallas`` runs both LSTMs through the whole-sequence
inference kernel (``ops/lstm_seq.py``; its plain version on the CPU),
``xla`` through plain PyTorch, ``keep`` (the default) as the checkpoint
trained. The cl_vae family (its IW-NLL comes with the cl_vae training
slice) and ``--dp > 1`` are not ported yet and raise.
Prints one JSON line, the JAX package's.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..data import PianoData
from ..evaluation.nll import CL_VAE_TODO, DP_TODO, iw_nll_dataset
from ..train.checkpoint import load_model_args
from ..weights import params_from_numpy
from . import common


def evaluate(args):
    if args.dp > 1:
        raise NotImplementedError(DP_TODO)
    if args.family == "auto":
        # cl_vae checkpoints carry intermediate_class_dim; cl_vrnn ones don't
        margs_probe = load_model_args(args.model_file)
        args.family = "cl_vae" if "intermediate_class_dim" in margs_probe else "cl_vrnn"
    if args.family == "cl_vae":
        raise NotImplementedError(CL_VAE_TODO)
    raw, cfg, margs = common.load_model(args.model_file, args.family)
    device = resolve_device(args.device)
    cfg = common.resolve_lstm_backend(cfg, args.lstm_backend)
    # batch_size=1: PianoData truncates every split to a multiple of its
    # batch_size; the estimator pads the final batch itself, so the NLL
    # covers every test window
    P = PianoData(args.train_file, batch_size=1, seq_length=margs["seq_length"],
                  return_y_next=margs.get("predict_next", False) or margs.get("use_x_prev", False),
                  return_y_hist=True, squeeze_x=False, squeeze_y=False)
    data = common.build_cl_vrnn_datasets(P, margs["n_classes"], cfg.use_x_prev, device)["test"]
    data = {k: v for k, v in data.items() if k in ("x", "y", "x_prev")}
    generator = torch.Generator(device=device).manual_seed(args.seed)
    nlls = iw_nll_dataset(params_from_numpy(raw, device), cfg, data, generator, args.n_samples,
                          args.batch_size, args.family)
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
    parser.add_argument("--dp", type=int, default=1, help="not ported: > 1 raises")
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
