"""Generate music from a trained Classifying VAE+LSTM; run as

    python -m classifying_vae_lstm_tpu_torch.cli.cl_vrnn_sample <run_name> -i <model.npz>

Flag for flag the JAX package's ``cli/cl_vrnn_sample.py``, with two
exceptions: ``--train_file`` defaults to the corpus shipped with the
repository, and ``--device`` (``cuda``, the default, or ``cpu``) picks where
the run goes. ``-n`` test windows of ``-t`` frames (filtered by key name with
``-c``, through the inverted key map) seed ``-n`` songs of ``-t`` frames,
each conditioned on its window's true key or, with ``--infer_w``, on the key
inferred from it (a one-hot draw with ``--discrete_w``). All songs are
generated by one call of the whole-generation sampler — one launch of its
CUDA kernel on the card. Each sample and its seed are written as MIDI,
frames doubled for JSB corpora (``jsb`` in the train file's name).
``--seed_midi`` seeds every song from the last ``-t`` frames of a MIDI file
instead, its key inferred unless ``-c`` names one.

The windows are shuffled with ``numpy.random.default_rng(--seed)``, as in
the JAX CLI; the key and sampling noise come from a ``torch.Generator``
seeded alike, so the songs differ from the JAX CLI's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData, midi_to_roll, to_categorical, write_sample, write_sample_wav
from ..sampling.generate import generate_cl_vrnn_batch, infer_w_cl_vrnn
from ..weights import params_from_numpy
from . import common


def _write(samples, args, is_jsb, names):
    os.makedirs(args.sample_dir, exist_ok=True)
    for j, name in enumerate(names):
        write_sample(samples[j], args.sample_dir, name, is_jsb)
        if args.write_wav:
            write_sample_wav(samples[j], args.sample_dir, name, is_jsb)


def gen_samples(P, params, cfg, margs, args, device):
    """Songs from test windows; returns [n, t, D] frames (None when no
    window has the ``-c`` key)."""
    if args.seed_midi:
        return gen_from_midi(P, params, cfg, margs, args, device)
    key_map = {v: k for k, v in P.key_map.items()}
    inds = np.arange(len(P.test_song_keys))
    if args.c is not None:  # seeds of the named key only
        kys = np.array([key_map[k] for k in P.test_song_keys])
        inds = inds[kys == args.c]
    rng = np.random.default_rng(args.seed)
    rng.shuffle(inds)
    inds = inds[: args.n]
    if len(inds) == 0:
        print("no matching test seeds")
        return None
    generator = torch.Generator(device=device).manual_seed(args.seed)
    seeds = np.stack([P.x_test[i] for i in inds])
    seeds_dev = torch.from_numpy(seeds).to(device)
    if args.infer_w:  # each seed's own w, one batched inference
        ws = infer_w_cl_vrnn(params, cfg, seeds_dev, generator, w_discrete=args.discrete_w)
    else:
        ws = torch.from_numpy(to_categorical(P.test_song_keys[inds], margs["n_classes"]))
    samples = generate_cl_vrnn_batch(params, cfg, seeds_dev, args.t, generator,
                                     ws.to(device)).cpu().numpy()
    is_jsb = "jsb" in args.train_file.lower()
    _write(samples, args, is_jsb, [f"{args.run_name}_{j}" for j in range(len(inds))])
    for j, i in enumerate(inds):
        write_sample(seeds[j], args.sample_dir, f"{args.run_name}{j}_seed_{i}", is_jsb)
    return samples


def gen_from_midi(P, params, cfg, margs, args, device):
    """Songs seeded from a MIDI file: its last ``-t`` frames (front-padded
    with silence) teacher-forced, w the named key or inferred from it."""
    roll = midi_to_roll(args.seed_midi)
    if len(roll) == 0:
        raise ValueError(f"{args.seed_midi} contains no notes")
    t, K = args.t, margs["n_classes"]
    seed = np.zeros((t, cfg.original_dim), np.float32)
    take = min(t, len(roll))
    seed[-take:] = roll[-take:, : cfg.original_dim]
    seeds = torch.from_numpy(np.repeat(seed[None], args.n, axis=0)).to(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.c is not None:
        idx = P.key_map.get(args.c)
        if idx is None:
            raise ValueError(f"unknown key {args.c!r}; known: {sorted(P.key_map)}")
        w = torch.from_numpy(to_categorical([idx], K)[0]).to(device)
    else:
        w = infer_w_cl_vrnn(params, cfg, seeds[0], generator, w_discrete=args.discrete_w)
    samples = generate_cl_vrnn_batch(params, cfg, seeds, t, generator,
                                     w.expand(args.n, K).contiguous()).cpu().numpy()
    _write(samples, args, "jsb" in args.train_file.lower(),
           [f"{args.run_name}_{j}" for j in range(args.n)])
    return samples


def sample(args):
    device = resolve_device(args.device)
    model_file = args.model_file or os.path.join(args.model_dir, args.run_name + ".npz")
    raw, cfg, margs = common.load_model(model_file, "cl_vrnn")
    P = PianoData(args.train_file, batch_size=1, seq_length=args.t, squeeze_x=False)
    return gen_samples(P, params_from_numpy(raw, device), cfg, margs, args, device)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("run_name", type=str, help="tag for current run")
    parser.add_argument("--infer_w", action="store_true", help="infer w when generating")
    parser.add_argument("--discrete_w", action="store_true",
                        help="sample discrete w when generating")
    parser.add_argument("-t", type=int, default=32, help="number of timesteps per sample")
    parser.add_argument("-n", type=int, default=1, help="number of samples")
    parser.add_argument("-c", type=str, help="set key of seed sample")
    parser.add_argument("--sample_dir", type=str, default="data/samples",
                        help="basedir for saving output midi files")
    parser.add_argument("--model_dir", type=str, default="data/models",
                        help="basedir of saved models: <model_dir>/<run_name>.npz is loaded "
                             "when -i is not given")
    parser.add_argument("-i", "--model_file", type=str, default="",
                        help="preload model weights (no training)")
    parser.add_argument("--train_file", type=str, default=common.DEFAULT_TRAIN_FILE,
                        help="file of training data (.pickle): the test windows seed")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the window shuffle and the sampling noise")
    parser.add_argument("--write_wav", action="store_true", help="also render samples to .wav")
    parser.add_argument("--seed_midi", type=str, default=None,
                        help="seed generation from this .mid file instead of a test window "
                             "(any SMF, quantized to eighth notes)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the whole-generation CUDA kernel; cpu: its plain version")
    return parser


def _main():
    sample(build_parser().parse_args())


if __name__ == "__main__":
    _main()
