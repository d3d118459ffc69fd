"""Measure how far a trained cl_vrnn's key latent steers its songs; run as

    python -m classifying_vae_lstm_tpu_torch.cli.key_consistency -i <model.npz>

Flag for flag the JAX package's ``cli/key_consistency.py``, with two
exceptions: ``--train_file`` defaults to the corpus shipped with the
repository, and ``--device`` (``cuda``, the default, or ``cpu``) picks where
the run goes. For each key with test songs, ``-n`` seed windows are drawn
from that key's test songs (the same ``np.random.default_rng(--seed)``
calls as the JAX CLI, so the same windows) and ``-t`` frames generated,
conditioned on the key's one-hot w, in one batched call: the whole-generation
CUDA kernel on the card, its plain version on the CPU; each key's noise
comes from a ``torch.Generator`` seeded with the key's index. Prints the
JAX CLI's JSON line: the in-scale fraction for the conditioned and the
mismatched keys, their margin (positive: w steers the output), the
corpus's own in-scale fraction (``corpus_ceiling``) and ``n_songs``.

A key whose index is not below the checkpoint's ``n_classes`` raises; the
JAX CLI conditions such a key on an all-zero w.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData, to_categorical
from ..evaluation.key_consistency import in_scale_fraction, key_consistency_report
from ..ops.cuda_generate import generate_cl_vrnn_batch_cuda
from ..sampling.generate import generate_cl_vrnn_batch
from ..weights import params_from_numpy
from . import common


def run(args, noise_fn=None):
    """Generate, score and print; returns the report. ``noise_fn(kidx, B,
    total, latent_dim, D) -> (eps, u)``, when given, supplies each key's
    sampling noise in place of the key's generator (the tests hand both
    packages the same arrays through it)."""
    device = resolve_device(args.device)
    raw, cfg, margs = common.load_model(args.model_file, "cl_vrnn")
    params = params_from_numpy(raw, device)
    P = PianoData(args.train_file, batch_size=1, seq_length=args.seed_len, squeeze_x=False)
    inv = {v: k for k, v in P.key_map.items()}
    keys = sorted(P.key_map)
    rng = np.random.default_rng(args.seed)

    rolls, conds = [], []
    for key_name in keys:
        kidx = P.key_map[key_name]
        pool = np.where(P.test_song_keys == kidx)[0]
        if len(pool) == 0:
            continue
        if kidx >= margs["n_classes"]:
            raise ValueError(
                f"key {str(key_name)!r} of {args.train_file} has index {kidx}, but the "
                f"checkpoint has n_classes={margs['n_classes']}: it cannot be conditioned "
                "on this corpus")
        picks = rng.choice(pool, size=args.n, replace=len(pool) < args.n)
        seeds = torch.from_numpy(P.x_test[picks]).to(device)
        ws = torch.from_numpy(to_categorical(np.full(args.n, kidx), margs["n_classes"])).to(device)
        if noise_fn is None:
            gen = torch.Generator(device=device).manual_seed(int(kidx))
            out = generate_cl_vrnn_batch(params, cfg, seeds, args.t, gen, ws)
        else:
            B, Tseed, D = seeds.shape
            eps, u = noise_fn(int(kidx), B, Tseed + args.t, cfg.latent_dim, D)
            out = generate_cl_vrnn_batch_cuda(params, cfg, seeds, args.t, eps, u, ws)
        for r in out.cpu().numpy():
            rolls.append(r)
            conds.append(key_name)

    rep = key_consistency_report(rolls, conds, all_keys=keys)
    ceiling = [
        in_scale_fraction(np.asarray(P.x_test[i]), inv[P.test_song_keys[i]])
        for i in range(0, len(P.x_test), max(len(P.x_test) // 200, 1))
    ]
    rep["corpus_ceiling"] = float(np.nanmean(ceiling))
    rep["n_songs"] = len(rolls)
    print(json.dumps({k: round(float(v), 4) for k, v in rep.items()}))
    return rep


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--model_file", type=str, required=True)
    parser.add_argument("-n", type=int, default=8, help="songs per key")
    parser.add_argument("-t", type=int, default=64, help="generated frames per song")
    parser.add_argument("--seed_len", type=int, default=32, help="seed window length")
    parser.add_argument("--train_file", type=str, default=common.DEFAULT_TRAIN_FILE)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the card (raises without one); cpu: plain PyTorch")
    return parser


def _main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    _main()
