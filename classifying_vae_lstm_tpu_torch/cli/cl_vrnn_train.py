"""Train the Classifying VAE+LSTM (STORN); run as

    python -m classifying_vae_lstm_tpu_torch.cli.cl_vrnn_train <run_name> [flags]

Flag for flag the JAX package's ``cli/cl_vrnn_train.py``, with two
exceptions: ``--train_file`` defaults to the corpus shipped with the
repository, and ``--device`` (``cuda``, the default, or ``cpu``) picks
where the run goes. ``--lstm_backend pallas`` trains through the two-cell
CUDA kernels on the card (``ops/two_cell.py``; their plain versions on the
CPU), or with ``--two_cell off`` through the whole-sequence LSTM kernels
(``ops/lstm_seq.py``: training forward and backward per step, the
inference forward for the eval batches); ``xla`` (and ``auto``, which
resolves to it) trains through plain PyTorch.
The checkpoint triple ``<model_dir>/<run>.{json,yaml,npz}`` loads in both
packages. Flags whose modules are not ported yet raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData
from ..models import cl_vrnn
from ..ops.lstm import resolve_fusion
from ..ops.two_cell import should_use
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
        return_y_hist=True,
        squeeze_x=False,
        squeeze_y=False,
    )
    args.n_classes = int(len(np.unique(P.train_song_keys)))
    print(f"Training with {args.n_classes} classes.")
    if args.predict_next and args.use_x_prev:
        raise ValueError("Can't use --predict_next if using --use_x_prev")
    if args.kl_anneal > args.num_epochs or args.w_kl_anneal > args.num_epochs:
        raise ValueError("invalid kl_anneal / w_kl_anneal (more epochs than --num_epochs)")
    # callbacks gate on max(anneals)+1; the reference's best-epoch rule uses
    # min(anneals) (its quirk Q6): both kept
    min_epoch_cb = max(args.kl_anneal, args.w_kl_anneal) + 1
    min_epoch_best = min(args.kl_anneal, args.w_kl_anneal)

    optimizer, was_adam_wn = init_optimizer(args.optimizer)
    args.optimizer = "adam-wn" if was_adam_wn else args.optimizer
    args.two_cell = {"auto": None, "on": True, "off": False}[args.two_cell]
    cfg = common.cl_vrnn_config_from_args(vars(args))
    if args.lstm_backend == "auto":
        cfg = common.resolve_lstm_backend(cfg, "auto")
        # args.json records the resolved backend so the checkpoint reloads
        # with the numerics it trained with
        args.lstm_backend = cfg.lstm_backend
        args.bf16_compute = cfg.bf16_compute
        print(f"lstm_backend=auto -> {cfg.lstm_backend}")
    if cfg.lstm_backend == "pallas":
        # pin the fusion triple and the two-cell decision, as the JAX CLI does
        if cfg.fusion is None:
            cfg = dataclasses.replace(
                cfg, fusion=resolve_fusion(None, hidden_dim=cfg.intermediate_dim))
        if cfg.two_cell is None:
            cfg = dataclasses.replace(cfg, two_cell=bool(should_use(cfg)))
        print(f"two_cell={cfg.two_cell}")
    args.two_cell = cfg.two_cell
    if cfg.fusion is not None:
        args.fusion = list(cfg.fusion)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = cl_vrnn.init(generator, cfg)
    ckpt_path = save_model_in_pieces(params, args)
    data = common.build_cl_vrnn_datasets(P, args.n_classes, args.use_x_prev, device)
    print((P.x_train.shape, P.y_train.shape))

    trainer = Trainer(functools.partial(_loss, cfg), optimizer, batch_size=args.batch_size)
    _, best_params, history, _ = fit(
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
        min_epoch=min_epoch_cb,
        checkpoint_path=ckpt_path,
    )
    val_losses = history.get("val_loss", [])
    masked = [v if i >= min_epoch_best else np.inf for i, v in enumerate(val_losses)]
    best_ind = int(np.argmin(masked)) if masked else 0
    best_loss = {k: v[best_ind] for k, v in history.items() if v}
    print({k: round(v, 4) for k, v in best_loss.items()})
    return best_params, best_loss


def _loss(cfg, params, batch, generator, kl_w, class_w, w_kl_w):
    return cl_vrnn.loss_and_metrics(params, cfg, batch, generator, kl_w, class_w, w_kl_w)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("run_name", type=str, help="tag for current run")
    parser.add_argument("--batch_size", type=int, default=200, help="batch size")
    parser.add_argument("--optimizer", type=str, default="adam-wn", help="optimizer name")
    parser.add_argument("--num_epochs", type=int, default=200, help="number of epochs")
    parser.add_argument("--original_dim", type=int, default=88, help="input dim")
    parser.add_argument("--latent_dim", type=int, default=2, help="latent dim")
    parser.add_argument("--intermediate_dim", type=int, default=88, help="intermediate dim")
    parser.add_argument("--seq_length", type=int, default=16,
                        help="sequence length (to use as history)")
    parser.add_argument("--class_weight", type=float, default=1.0,
                        help="relative weight on classifying key")
    parser.add_argument("--predict_next", action="store_true",
                        help="use x_t to 'autoencode' x_{t+1}")
    parser.add_argument("--do_log", action="store_true", help="save log files (not ported)")
    parser.add_argument("--w_log_var_prior", type=float, default=0.0,
                        help="log variance prior on w")
    parser.add_argument("--kl_anneal", type=int, default=0,
                        help="number of epochs before kl loss term is 1.0")
    parser.add_argument("--w_kl_anneal", type=int, default=0,
                        help="number of epochs before w's kl loss term is 1.0")
    parser.add_argument("--patience", type=int, default=5, help="# of epochs, for early stopping")
    parser.add_argument("--use_x_prev", action="store_true",
                        help="use x_{t-1} to help z_t decode x_t")
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
    parser.add_argument("--lstm_backend", type=str, default="xla",
                        choices=["xla", "pallas", "auto"],
                        help="xla: plain PyTorch; pallas: the CUDA kernels (plain "
                             "versions on the CPU); auto: xla")
    parser.add_argument("--streaming", action="store_true", help="not ported: raises")
    parser.add_argument("--data_init", action="store_true", help="not ported: raises")
    parser.add_argument("--dp", type=int, default=0, help="not ported: nonzero raises")
    parser.add_argument("--two_cell", type=str, default="auto", choices=["auto", "on", "off"],
                        help="pallas backend: 'auto' takes the two-cell kernels wherever "
                             "they accept the config, 'off' the whole-sequence LSTM "
                             "kernels; the resolved value is recorded in args.json")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the card (raises without one); cpu: plain PyTorch")
    return parser


def _main():
    train(build_parser().parse_args())


if __name__ == "__main__":
    _main()
