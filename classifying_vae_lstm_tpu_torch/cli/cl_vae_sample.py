"""Generate music from a trained Classifying VAE; run as

    python -m classifying_vae_lstm_tpu_torch.cli.cl_vae_sample <run_name> -i <model.npz>

Flag for flag the JAX package's ``cli/cl_vae_sample.py``, with two
exceptions: ``--train_file`` defaults to the corpus shipped with the
repository, and ``--device`` (``cuda``, the default, or ``cpu``) picks where
the run goes. Each of the ``-n`` songs starts from the first frame of a
random test window, conditioned on that window's true key, or on the key
inferred from the frame (``--infer_w``), or from the last frame of
``--seed_midi`` (w inferred). All songs are generated by one call of the
whole-generation sampler — one launch of its CUDA kernel on the card — and
written as ``<run_name>_<i>.mid`` (frames doubled, as the JAX CLI writes
them), and as ``.wav`` with ``--write_wav``.

A seq-concat checkpoint (``seq_length > 1`` in its args; each row a window
of ``seq_length`` frames of the corpus's active pitches, flattened) seeds
from a whole test window, or from the last ``seq_length`` frames of
``--seed_midi``, generates ``-t`` windows, and writes them out as ``-t x
seq_length`` frames of 88 pitches. The JAX package's sample CLI seeds every
checkpoint with one 88-pitch frame, which such a checkpoint cannot read.

The seed windows are drawn with ``numpy.random.default_rng(--seed)`` and the
sampling noise with a ``torch.Generator`` seeded alike, so a seed picks other
windows and other songs than the JAX CLI's ``jax.random`` draws.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData, midi_to_roll, to_categorical, write_sample, write_sample_wav
from ..sampling.generate import generate_cl_vae_batch
from ..weights import params_from_numpy
from . import common


def gather_seeds(P, margs, args, rng: np.random.Generator, layout=None):
    """(seeds [n, D], w_vals [n, K] | None): the first frames of random test
    windows with their true-key one-hots, or w left to inference (None). A
    ``--seed_midi`` contributes its last frame n times, w inferred. With a
    seq-concat ``layout`` (``common.SeqConcat``) a seed is a whole window."""
    n, D = args.n, margs["original_dim"]
    if args.seed_midi:
        roll = midi_to_roll(args.seed_midi)
        if len(roll) == 0:
            raise ValueError(f"{args.seed_midi} contains no notes")
        seed = layout.rows(roll[:, :88]) if layout else roll[-1][:D]
        return np.tile(seed, (n, 1)).astype(np.float32), None
    inds = rng.integers(0, len(P.x_test), size=n)
    seeds = np.stack([layout.rows(P.x_test[i]) if layout else P.x_test[i][0]
                      for i in inds]).astype(np.float32)
    if args.infer_w:
        return seeds, None
    return seeds, to_categorical([P.test_song_keys[i] for i in inds], margs["n_classes"])


def sample(args) -> np.ndarray:
    """Writes the songs; returns them as the piano rolls written: [n, t, 88],
    or [n, t * seq_length, 88] for a seq-concat checkpoint."""
    device = resolve_device(args.device)
    model_file = args.model_file or os.path.join(args.model_dir, args.run_name + ".npz")
    raw, cfg, margs = common.load_model(model_file, "cl_vae", no_x_prev=args.no_x_prev)
    cfg = common.resolve_gen_backend(cfg, args.gen_backend)
    if args.gen_backend == "auto":
        print(f"gen_backend=auto -> {cfg.gen_backend}")
    layout = common.SeqConcat.of(args.train_file, margs)
    P = PianoData(args.train_file, batch_size=1,
                  seq_length=layout.seq_length if layout else args.t, squeeze_x=True)
    os.makedirs(args.sample_dir, exist_ok=True)
    seeds, w_vals = gather_seeds(P, margs, args, np.random.default_rng(args.seed), layout)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    to_dev = lambda a: torch.from_numpy(a).to(device)
    samples = generate_cl_vae_batch(
        params_from_numpy(raw, device), cfg, to_dev(seeds), args.t, generator,
        w_vals=None if w_vals is None else to_dev(w_vals),
        use_z_prior=args.use_z_prior).cpu().numpy()
    if layout:
        samples = layout.rolls(samples)
    for i in range(args.n):
        write_sample(samples[i], args.sample_dir, f"{args.run_name}_{i}", True)
        if args.write_wav:
            write_sample_wav(samples[i], args.sample_dir, f"{args.run_name}_{i}", True)
    return samples


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("run_name", type=str, help="tag for current run")
    parser.add_argument("-n", type=int, default=1, help="number of samples")
    parser.add_argument("--use_z_prior", action="store_true",
                        help="sample z from standard normal at each timestep")
    parser.add_argument("-t", type=int, default=32, help="number of timesteps per sample")
    parser.add_argument("--infer_w", action="store_true", help="infer w when generating")
    parser.add_argument("--no_x_prev", action="store_true", help="override use_x_prev")
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
                        help="seed of the seed-window choice and the sampling noise")
    parser.add_argument("--write_wav", action="store_true", help="also render samples to .wav")
    parser.add_argument("--seed_midi", type=str, default=None,
                        help="seed generation from the last frame of this .mid file")
    parser.add_argument("--gen_backend", type=str, default="auto",
                        choices=["auto", "keep", "xla", "pallas"],
                        help="'auto' resolves to 'xla'; generation on cuda always runs a "
                             "CUDA kernel, and 'pallas' picks int8 weights for a bf16 "
                             "checkpoint where the JAX package does")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the whole-generation CUDA kernel; cpu: its plain version")
    return parser


def _main():
    sample(build_parser().parse_args())


if __name__ == "__main__":
    _main()
