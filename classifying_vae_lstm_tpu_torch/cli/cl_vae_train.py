"""Train a Classifying VAE; run as

    python -m classifying_vae_lstm_tpu_torch.cli.cl_vae_train <run_name> [flags]

Flag for flag the JAX package's ``cli/cl_vae_train.py``, with two
exceptions: ``--train_file`` defaults to the corpus shipped with the
repository, and ``--device`` (``cuda``, the default, or ``cpu``) picks where
the run goes. ``--train_backend pallas`` trains through the dense-stack CUDA
kernels on the card (``ops/vae_dense.py``; their plain versions on the CPU)
wherever they accept the config, and falls to ``xla`` where they do not (a
``--vanilla`` model, no hidden layers), as the JAX CLI does; ``xla`` (and
``auto``, which resolves to it) trains through plain PyTorch. The resolved
backend is printed and recorded in args.json. The checkpoint triple
``<model_dir>/<run>.{json,yaml,npz}`` loads in both packages. Flags whose
modules are not ported yet raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData
from ..models import cl_vae
from ..ops.vae_dense import should_use
from ..optim import init_optimizer
from ..train import Trainer, fit, save_model_in_pieces
from . import common


def train(args):
    """Train from parsed flags; returns (best_params, best_loss)."""
    common.check_ported(args)
    device = resolve_device(args.device)
    P = PianoData(
        args.train_file,
        batch_size=args.batch_size,
        seq_length=args.seq_length,
        step_length=1,
        return_y_next=args.predict_next or args.use_x_prev,
        squeeze_x=True,
        squeeze_y=True,
    )
    if args.seq_length > 1:
        args.original_dim = common.prune_and_flatten_cl_vae(P, args.seq_length)

    if args.vanilla:
        # the vanilla VAE: no key latent, w is the constant [1.0]
        args.n_classes = 1
        for split in ("train", "valid", "test"):
            setattr(P, f"{split}_song_keys", np.zeros_like(getattr(P, f"{split}_song_keys")))
    else:
        args.n_classes = int(len(np.unique(P.train_song_keys)))
    assert not (args.predict_next and args.use_x_prev), \
        "Can't use --predict_next if using --use_x_prev"
    if args.kl_anneal > 0:
        assert args.kl_anneal <= args.num_epochs, "invalid kl_anneal"
    if args.w_kl_anneal > 0:
        assert args.w_kl_anneal <= args.num_epochs, "invalid w_kl_anneal"
    min_epoch = max(args.kl_anneal, args.w_kl_anneal) + 1

    optimizer, was_adam_wn = init_optimizer(args.optimizer)
    args.optimizer = "adam-wn" if was_adam_wn else args.optimizer
    cfg = common.cl_vae_config_from_args(vars(args))
    if cfg.train_backend != "xla":
        # resolve and pin the choice, so the checkpoint reloads onto the path
        # it trained on: pallas where the kernels take the config, else xla
        cfg = dataclasses.replace(cfg, train_backend="pallas" if should_use(cfg) else "xla")
        args.train_backend = cfg.train_backend
        print(f"train_backend={cfg.train_backend}")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = cl_vae.init(generator, cfg)
    ckpt_path = save_model_in_pieces(params, args)
    data = common.build_cl_vae_datasets(P, args.n_classes, args.use_x_prev, device)

    trainer = Trainer(functools.partial(_loss, cfg), optimizer, batch_size=args.batch_size)
    _, best_params, _, best_loss = fit(
        trainer,
        params,
        data["train"],
        data["valid"],
        num_epochs=args.num_epochs,
        generator=generator,
        kl_anneal=args.kl_anneal,
        w_kl_anneal=args.w_kl_anneal,
        class_weight=args.class_weight,
        patience=args.patience,
        min_epoch=min_epoch,
        checkpoint_path=ckpt_path,
    )
    print({k: round(v, 4) for k, v in best_loss.items()})
    return best_params, best_loss


def _loss(cfg, params, batch, generator, kl_w, class_w, w_kl_w):
    return cl_vae.loss_and_metrics(params, cfg, batch, generator, kl_w, class_w, w_kl_w)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("run_name", type=str, help="tag for current run")
    parser.add_argument("--batch_size", type=int, default=100, help="batch size")
    parser.add_argument("--optimizer", type=str, default="adam-wn", help="optimizer name")
    parser.add_argument("--num_epochs", type=int, default=200, help="number of epochs")
    parser.add_argument("--original_dim", type=int, default=88, help="input dim")
    parser.add_argument("--intermediate_dim", type=int, default=88, help="intermediate dim")
    parser.add_argument("--latent_dim", type=int, default=2, help="latent dim")
    parser.add_argument("--seq_length", type=int, default=1, help="sequence length (concat)")
    parser.add_argument("--class_weight", type=float, default=1.0,
                        help="relative weight on classifying key")
    parser.add_argument("--w_log_var_prior", type=float, default=0.0, help="w log var prior")
    parser.add_argument("--intermediate_class_dim", type=int, default=88,
                        help="intermediate dims for classes")
    parser.add_argument("--do_log", action="store_true", help="save log files (not ported)")
    parser.add_argument("--predict_next", action="store_true",
                        help="use x_t to 'autoencode' x_{t+1}")
    parser.add_argument("--use_x_prev", action="store_true",
                        help="use x_{t-1} to help z_t decode x_t")
    parser.add_argument("--patience", type=int, default=5, help="# of epochs, for early stopping")
    parser.add_argument("--kl_anneal", type=int, default=0,
                        help="number of epochs before kl loss term is 1.0")
    parser.add_argument("--w_kl_anneal", type=int, default=0,
                        help="number of epochs before w's kl loss term is 1.0")
    parser.add_argument("--log_dir", type=str, default="data/logs",
                        help="basedir for saving log files")
    parser.add_argument("--model_dir", type=str, default="data/models",
                        help="basedir for saving model weights")
    parser.add_argument("--train_file", type=str, default=common.DEFAULT_TRAIN_FILE,
                        help="file of training data (.pickle)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the run's torch.Generator")
    parser.add_argument("--resume", action="store_true", help="not ported: raises")
    parser.add_argument("--save_last", action="store_true", help="not ported: raises")
    parser.add_argument("--trace_dir", type=str, default=None, help="not ported: raises")
    parser.add_argument("--check_numerics", action="store_true", help="not ported: raises")
    parser.add_argument("--streaming", action="store_true", help="not ported: raises")
    parser.add_argument("--bf16_compute", action="store_true",
                        help="bf16 matmul operands (f32 accumulation) on the hidden layers and "
                             "the frame head; plain PyTorch only (the kernels' bf16 mode is "
                             "not ported and raises)")
    parser.add_argument("--data_init", action="store_true", help="not ported: raises")
    parser.add_argument("--vanilla", action="store_true",
                        help="vanilla VAE: drop the key latent (trains on xla)")
    parser.add_argument("--dp", type=int, default=0, help="not ported: nonzero raises")
    parser.add_argument("--train_backend", type=str, default="xla",
                        choices=["xla", "auto", "pallas"],
                        help="xla: plain PyTorch; pallas: the dense-stack CUDA kernels (plain "
                             "versions on the CPU) where they take the config, else xla; "
                             "auto: xla; the resolved value is recorded in args.json")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the card (raises without one); cpu: plain PyTorch")
    return parser


def _main():
    train(build_parser().parse_args())


if __name__ == "__main__":
    _main()
