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
packages, and so do ``--save_last``'s ``<run>.last.npz`` and its optimizer
state ``<run>.last.opt.npz``, which ``--resume`` reads: a run started by
either package goes on in the other. ``--dp N`` trains data-parallel on N
devices: the CLI starts N ranks itself (``torch.multiprocessing.spawn``,
NCCL on the first N cards, gloo with ``--device cpu``), each training its
row shard of every batch through the same kernels and averaging the
gradients; rank 0 alone prints and writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData
from ..models import cl_vrnn
from ..ops.lstm import resolve_fusion
from ..ops.two_cell import should_use
from ..optim import init_optimizer
from ..optim.data_init import data_based_init_cl_vrnn
from ..train import Trainer, fit, save_model_in_pieces
from . import common


def train(args):
    """Train from parsed flags; returns (best_params, best_loss). With
    ``--dp N`` the N ranks train (:func:`common.spawn_dp`) and rank 0's
    result comes back, its parameters on the CPU."""
    if args.dp:
        return common.spawn_dp(_train_rank, args)
    return _train(args)


def _train_rank(rank, args):
    best_params, best_loss = _train(args, rank)
    return common.tree_to_cpu(best_params), best_loss


def _train(args, rank=None):
    """The run; ``rank`` is this process's rank of a ``--dp`` world (None
    without one)."""
    lead = rank in (None, 0)  # prints and writes the files
    device = resolve_device(args.device)
    if rank is not None:
        device = torch.device(device.type, rank) if device.type == "cuda" else device
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
    mesh, noise_fn = common.make_dp_mesh(args, cfg, cl_vrnn.draw_apply_noise)
    if mesh is not None:
        print(f"data-parallel training over {args.dp} devices ({mesh.data_devices[0].type}; "
              "all_reduce of the gradients)")
    ckpt_path = (save_model_in_pieces(params, args) if lead
                 else os.path.join(args.model_dir, args.run_name + ".npz"))
    data = common.build_cl_vrnn_datasets(P, args.n_classes, args.use_x_prev, device)
    print((P.x_train.shape, P.y_train.shape))
    if args.data_init:
        # the weight-norm data-dependent init on the first 100 training rows,
        # its draws seeded seed + 1, as in the JAX CLI
        first = {k: v[:100] for k, v in data["train"].items()}
        params = data_based_init_cl_vrnn(
            params, cfg, first, torch.Generator(device=device).manual_seed(args.seed + 1))
    params, resume_kwargs = common.maybe_resume(args, ckpt_path, params)
    if mesh is not None:
        common.broadcast_params(params)
    loss_fn = functools.partial(_loss, cfg)
    if args.check_numerics and lead:
        common.check_first_batch(loss_fn, params, data["train"], args)

    trainer = Trainer(loss_fn, optimizer, batch_size=args.batch_size, mesh=mesh,
                      noise_fn=noise_fn)
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
        checkpoint_path=ckpt_path if lead else None,
        verbose=lead,
        log_fn=common.make_log_fn(args) if args.do_log and lead else None,
        save_last=(args.save_last or args.resume) and lead,
        trace_dir=args.trace_dir if lead else None,
        streaming=args.streaming,
        stream_seed=args.seed,
        **resume_kwargs,
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
    parser.add_argument("--do_log", action="store_true",
                        help="save log files: <log_dir>/<run>.jsonl and TensorBoard events")
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
    parser.add_argument("--resume", action="store_true",
                        help="resume from <run>.last.npz with optimizer state (extension)")
    parser.add_argument("--save_last", action="store_true",
                        help="write <run>.last.npz (+opt state) every epoch for resume (extension)")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler trace of one epoch (the second) here")
    parser.add_argument("--check_numerics", action="store_true",
                        help="fail fast on NaN/Inf in the first batch's loss/grads")
    parser.add_argument("--lstm_backend", type=str, default="xla",
                        choices=["xla", "pallas", "auto"],
                        help="xla: plain PyTorch; pallas: the CUDA kernels (plain "
                             "versions on the CPU); auto: xla")
    parser.add_argument("--streaming", action="store_true",
                        help="stream training batches from the host with device prefetch")
    parser.add_argument("--data_init", action="store_true",
                        help="weight-norm data-dependent init (the reference's was a no-op)")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel over N devices (N ranks, one a card; gloo "
                             "ranks with --device cpu); 0: one device")
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
