"""Shared CLI plumbing: dataset assembly, model (re)construction, loading.

The checkpoint contract is the JAX package's: ``<run>.json`` is the
training run's argparse namespace and becomes the model config, ``<run>.npz``
holds the weights.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import PianoData
from ..data.pianoroll import to_categorical
from ..models import cl_vae, cl_vrnn
from ..parallel.columns import gather_tree
from ..train.checkpoint import load_checkpoint, load_model_args, load_opt_state, sorted_leaves
from ..weights import params_from_numpy

# the corpus shipped with the repository (training data, seed windows for serving)
DEFAULT_TRAIN_FILE = "data/input/Piano-midi_all.pickle"


def dp_device_count(device: torch.device) -> int:
    """The devices a ``--dp`` run may spread over: the cards, or on the CPU
    its cores (a gloo rank a core)."""
    return torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)


def _dp_devices(args) -> list:
    """The devices of ``--dp N``: the first N cards, or the CPU N times with
    ``--device cpu``; raises, as the JAX package does, where N passes the
    devices there are."""
    dp, device = args.dp, resolve_device(getattr(args, "device", "cuda"))
    n_dev = dp_device_count(device)
    if dp > n_dev:
        raise ValueError(f"--dp {dp}: only {n_dev} devices available")
    return [torch.device("cuda", i) for i in range(dp)] if device.type == "cuda" else [device] * dp


def dp_mesh(args):
    """The mesh of ``--dp N`` (:func:`_dp_devices` on its data axis). The
    evaluate and serve CLIs split each batch over it in one process (from
    N = 2, as in the JAX package; the train CLIs from N = 1)."""
    from ..parallel import make_mesh

    return make_mesh(n_data=args.dp, n_model=1, devices=_dp_devices(args))


def check_dp(args):
    """``--dp N``'s errors, the JAX package's: more ranks than devices,
    ``N`` not dividing ``--batch_size``, and ``--dp`` with
    ``--streaming``."""
    dp = args.dp
    _dp_devices(args)
    if args.batch_size % dp != 0:
        raise ValueError(f"--dp {dp} must divide --batch_size {args.batch_size}")
    if getattr(args, "streaming", False):
        raise ValueError("--dp does not combine with --streaming (host-side batches)")


def make_dp_mesh(args, cfg, draw_apply_noise):
    """``--dp N`` plumbing shared by both train CLIs, as the JAX package's.

    Returns ``(mesh, noise_fn)`` for :class:`..train.Trainer`: a mesh of N
    devices on its ``data`` axis (the first N cards, or the CPU N times)
    and the model's global-batch noise hook, ``noise_fn(generator) =
    draw_apply_noise(generator, cfg, batch_size)``, which keeps a DP epoch
    the single-device one; ``(None, None)`` without ``--dp``. Raises as
    :func:`check_dp`. ``args.dp`` rides into args.json with the rest of the
    namespace."""
    if not getattr(args, "dp", 0):
        return None, None
    check_dp(args)
    noise_fn = lambda g: draw_apply_noise(g, cfg, args.batch_size)  # noqa: E731
    return dp_mesh(args), noise_fn


def _dp_rank(rank: int, rank_fn, args, store: str, result: str, threads: int):
    """One rank of :func:`spawn_dp`: its device (card ``rank``, or the
    CPU), its ``threads`` intra-op threads, the process group (NCCL on the
    card, gloo on the CPU) through the file store, then ``rank_fn(rank,
    args)``, whose value rank 0 saves to ``result``. Every rank but 0 prints
    nothing."""
    import sys

    import torch.distributed as dist

    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    device = resolve_device(args.device)
    torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="file://" + store, rank=rank, world_size=args.dp)
    try:
        out = rank_fn(rank, args)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def spawn_dp(rank_fn, args):
    """``--dp N``: run ``rank_fn(rank, args)`` in N processes of one
    ``torch.distributed`` world (``torch.multiprocessing.spawn``, a rank a
    device), which meet through a ``FileStore`` in ``--model_dir`` (no
    port, so parallel runs never race for one). The ranks split the
    parent's intra-op threads, so N CPU ranks share the parent's cores.
    Returns rank 0's value. A rank that raises ends the run with the
    others, and the exception reaches the caller."""
    import torch.multiprocessing as mp

    check_dp(args)
    os.makedirs(args.model_dir, exist_ok=True)
    base = os.path.join(os.path.abspath(args.model_dir), f".{args.run_name}.dp{os.getpid()}")
    store, result = base + ".store", base + ".result.pt"
    for f in (store, result):
        if os.path.exists(f):
            os.remove(f)
    try:
        threads = max(1, torch.get_num_threads() // args.dp)
        mp.spawn(_dp_rank, args=(rank_fn, args, store, result, threads),
                 nprocs=args.dp, join=True)
        return torch.load(result, weights_only=False)
    finally:
        for f in (store, result):
            if os.path.exists(f):
                os.remove(f)


def tree_to_cpu(tree):
    """A parameter tree's tensors moved to the CPU (column shards gathered
    whole there)."""
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    return gather_tree(tree, "cpu").detach().cpu()


def broadcast_params(params):
    """Rank 0's parameters on every rank (a DP run's replicas start equal)."""
    import torch.distributed as dist

    for leaf in sorted_leaves(params):
        buf = leaf.data.contiguous()  # NCCL takes contiguous tensors only
        dist.broadcast(buf, 0)
        if buf.data_ptr() != leaf.data.data_ptr():
            leaf.data.copy_(buf)


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


def seq_concat_mask(train_file: str, margs: dict) -> np.ndarray:
    """The pitch mask a seq-concat cl_vae run (``seq_length > 1``) pruned
    its corpus with: its training-time batching rebuilt, since the
    truncation to the batch size changes which windows vote."""
    y_next = margs.get("predict_next", False) or margs.get("use_x_prev", False)
    P = PianoData(train_file, batch_size=margs.get("batch_size", 100),
                  seq_length=margs["seq_length"], return_y_next=y_next, squeeze_x=True,
                  squeeze_y=True)
    return active_pitch_mask(P)


@dataclasses.dataclass(frozen=True)
class SeqConcat:
    """How a seq-concat cl_vae checkpoint sees piano rolls: each row it reads
    and generates is a window of ``seq_length`` frames of the ``mask``'s
    pitches, flattened step-major (:func:`prune_and_flatten_cl_vae`)."""

    mask: np.ndarray  # [88] bool
    seq_length: int

    @classmethod
    def of(cls, train_file: str, margs: dict) -> "SeqConcat | None":
        """The layout of a checkpoint's args, None unless seq-concat; raises
        if the corpus prunes to another width than the checkpoint's."""
        if margs.get("seq_length", 1) <= 1:
            return None
        layout = cls(seq_concat_mask(train_file, margs), margs["seq_length"])
        width = int(layout.mask.sum()) * layout.seq_length
        if width != margs["original_dim"]:
            raise ValueError(f"pruned width {width} != checkpoint original_dim "
                             f"{margs['original_dim']}: was the model trained on another "
                             "--train_file?")
        return layout

    def rows(self, rolls: np.ndarray) -> np.ndarray:
        """Rolls [..., T, 88] -> rows [..., D]: the last ``seq_length`` frames
        of each (zero frames before a shorter roll), pruned and flattened."""
        rolls = np.asarray(rolls, dtype=np.float32)
        pad = max(self.seq_length - rolls.shape[-2], 0)
        if pad:
            widths = [(0, 0)] * (rolls.ndim - 2) + [(pad, 0), (0, 0)]
            rolls = np.pad(rolls, widths)
        win = rolls[..., -self.seq_length :, :][..., self.mask]
        return np.ascontiguousarray(win.reshape(win.shape[:-2] + (-1,)))

    def rolls(self, rows: np.ndarray) -> np.ndarray:
        """Generated rows [n, t, D] -> piano rolls [n, t * seq_length, 88]."""
        n, t, _ = rows.shape
        out = np.zeros((n, t, self.seq_length, len(self.mask)), rows.dtype)
        out[..., self.mask] = rows.reshape(n, t, self.seq_length, -1)
        return out.reshape(n, t * self.seq_length, len(self.mask))


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
    as it is. Generation on the card always runs a CUDA kernel whatever the
    name, and the CPU its plain version; the name picks its precision as in
    JAX: a bf16 checkpoint with ``pallas`` samples in int8 where the JAX
    package's rule says int8 (``ops/cuda_generate.pick_mode``), so ``auto``
    samples it in bf16, as JAX does off a TPU."""
    if choice == "keep":
        return cfg
    return dataclasses.replace(cfg, lstm_backend="xla" if choice == "auto" else choice)


def resolve_gen_backend(cfg, choice: str = "auto"):
    """The cl_vae ``--gen_backend`` flag, parsed as the JAX package parses
    it: ``keep`` leaves the checkpoint's setting, ``auto`` resolves as it
    does off a TPU, to ``xla`` (the JAX gate to its kernel is a TPU
    measurement, which the port does not read), and an explicit name is
    taken as it is. Generation on the card always runs a CUDA kernel, whose
    f32 mode gives the same frames as the scan, and the CPU its plain
    version; the name picks its precision as in JAX: a bf16 checkpoint with
    ``pallas`` samples in int8 where the JAX package's rule says int8
    (``ops/cuda_generate_vae.pick_mode``), so ``auto`` samples it in bf16,
    as JAX does off a TPU."""
    if choice == "keep":
        return cfg
    return dataclasses.replace(cfg, gen_backend="xla" if choice == "auto" else choice)


def maybe_resume(args, ckpt_path: str, params):
    """``--resume``, as the JAX package's ``maybe_resume``: with the flag and
    an existing ``<run>.last.npz``, its parameters (on the device of
    ``params``) replace ``params``, and its ``.opt.npz``, where present,
    gives the optimizer state and the epoch to go on from. Returns (params,
    the keyword arguments of :func:`..train.loop.fit`). Both packages write
    these files alike, so a run resumes across them."""
    last = ckpt_path.replace(".npz", ".last.npz")
    opt_file = last.replace(".npz", ".opt.npz")
    if not getattr(args, "resume", False) or not os.path.exists(last):
        return params, {}
    params = params_from_numpy(load_checkpoint(last), sorted_leaves(params)[0].device)
    kwargs = {}
    if os.path.exists(opt_file):
        opt_state, epoch = load_opt_state(opt_file)
        kwargs = {"opt_state": opt_state, "initial_epoch": epoch}
        print(f"resuming from {last} at epoch {epoch}")
    return params, kwargs


def make_log_fn(args):
    """The ``--do_log`` sink, as the JAX package's: each epoch's logs as a
    line of ``<log_dir>/<run_name>.jsonl`` and as scalars of a TensorBoard
    event file under ``<log_dir>/<run_name>/`` (:mod:`..utils.tb_events`)."""
    from ..utils.tb_events import ScalarEventWriter

    os.makedirs(args.log_dir, exist_ok=True)
    f = open(os.path.join(args.log_dir, args.run_name + ".jsonl"), "a")
    tb = ScalarEventWriter(os.path.join(args.log_dir, args.run_name))

    def log_fn(epoch, logs):
        f.write(json.dumps({"epoch": epoch, **logs}) + "\n")
        f.flush()
        tb.add_scalars(epoch, {k: v for k, v in logs.items() if isinstance(v, (int, float))})

    return log_fn


def check_first_batch(loss_fn, params, train: dict, args):
    """``--check_numerics``: one loss and gradient evaluation on the first
    ``batch_size`` training rows (generator seeded 0, the full KL and w-KL
    weights, as the JAX CLIs), raising on any non-finite value."""
    from ..train.debug import check_first_batch as check

    first = {k: v[: args.batch_size] for k, v in train.items()}
    device = next(iter(train.values())).device
    check(loss_fn, params, first, torch.Generator(device=device).manual_seed(0), 1.0,
          float(np.float32(args.class_weight)), 1.0)
    print("check_numerics: first batch loss/grads finite")


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
