"""Training loop: eager minibatch steps inside host-driven epochs.

Counterpart of the JAX package's ``train/loop.py``. There an epoch is one
jitted program (on-device shuffle, a ``lax.scan`` of value_and_grad +
optimizer update, a scanned validation pass); here each minibatch is one
eager step (``loss_and_metrics``, ``backward()``, ``optimizer.step()``),
with the data, the shuffle and the metrics on the run's device, so the host
reads the device once per epoch. The semantics are the JAX package's: a
fresh permutation every epoch, the ``N % batch_size`` remainder dropped
after it, validation in order without shuffling.

:func:`fit` reproduces the reference driver: annealing, save-best
checkpointing and early stopping inert until ``min_epoch``, the Keras-style
history dict and best-epoch selection, and the JAX package's mid-training
resume (``opt_state``, ``initial_epoch``, ``save_last``), the per-epoch
``log_fn``, host streaming (``streaming``: :meth:`Trainer.train_epoch_streaming`)
and a profiler trace of one epoch (``trace_dir``). :meth:`Trainer.train_epochs`
runs E epochs in one call, as the JAX package's whole-run program does (here
a loop over the epoch bodies).

Data parallelism (``mesh``): one process a device under ``torch.distributed``,
each rank holding the data and the parameters (see :mod:`..parallel`). Every
rank draws the same permutation and, from the same generator calls as the
single-device epoch, the global batch's noise (``noise_fn``, the model's
``draw_apply_noise``); it keeps its rows of both, runs the model's loss on
them and averages the gradients over the ranks before the optimizer's step
(:func:`..parallel.shard_map_step.all_reduce_mean`). So a DP epoch equals
the single-device epoch up to the order of the gradient mean, as in JAX.

Tensor parallelism: parameters column-sharded over a mesh row's model
devices (``parallel.shard_params``; :class:`..parallel.ColumnShards`
leaves) train in every method as replicated ones do, in one process
without a mesh, or as each rank's share of a DP mesh whose model axis is
longer than 1 (:meth:`Trainer.place`). The optimizer takes each slice as a
parameter on its device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from ..parallel.columns import ColumnShards, tensor_leaves
from .callbacks import AnnealSchedule, CheckpointPolicy, EarlyStoppingAfterEpoch
from .checkpoint import save_checkpoint, sorted_leaves


def _stack_epochs(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def copy_params(tree, requires_grad: bool = False):
    """A deep copy of a parameter tree (detached; leaves optionally
    requiring grad; column shards copied slice by slice where they lie)."""
    if isinstance(tree, dict):
        return {k: copy_params(v, requires_grad) for k, v in tree.items()}
    copy = lambda t: t.detach().clone().requires_grad_(requires_grad)
    return tree.map(copy) if isinstance(tree, ColumnShards) else copy(tree)


def _mean(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


class Trainer:
    """Train and eval epochs for one model family.

    ``loss_fn(params, batch, generator, kl_w, class_w, w_kl_w) -> (loss,
    metrics)`` is the model's ``loss_and_metrics`` applied to its config;
    ``optimizer`` is a constructor taking the parameter tensors (the first
    element of :func:`..optim.init_optimizer`). Parameters are updated in
    place; ``generator`` (on the data's device) draws the shuffles and the
    model's noise.

    ``mesh`` (a :class:`..parallel.Mesh` whose data axis is the world of an
    initialised ``torch.distributed`` process group, this process one rank)
    makes the epochs data-parallel; ``noise_fn(generator) -> dict`` then
    draws the global batch's noise (the model's ``draw_apply_noise`` at the
    batch size), and the data axis must divide the batch size. With a
    model axis longer than 1 each rank's parameters are column-sharded over
    its row of the mesh (:meth:`place`).
    """

    def __init__(self, loss_fn: Callable, optimizer: Callable, batch_size: int, mesh=None,
                 noise_fn: Callable | None = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.mesh = mesh
        self.noise_fn = noise_fn
        if mesh is not None:
            from ..parallel import make_shard_map_train_step

            if noise_fn is None:
                raise ValueError("DP training needs the model's draw_apply_noise (noise_fn)")
            n_data = mesh.shape["data"]
            if batch_size % n_data != 0:
                raise ValueError(f"--dp {n_data} must divide batch_size {batch_size}")
            self._dp_step = make_shard_map_train_step(loss_fn, None, mesh)

    def init_optimizer(self, params) -> torch.optim.Optimizer:
        """The optimizer over every tensor of ``params`` (each column slice
        one parameter)."""
        return self.optimizer(tensor_leaves(params))

    def place(self, params):
        """``params`` placed for this process: with a mesh, this rank's row
        (its data device and, where the model axis is longer than 1, the
        column shards over its model devices; ``parallel.shard_params`` over
        that row alone); without one, as given."""
        if self.mesh is None:
            return params
        import torch.distributed as dist

        from ..parallel.mesh import Mesh, shard_params

        return shard_params(params, Mesh([self.mesh.devices[dist.get_rank()]]))[0]

    def train_step(self, params, opt, batch, generator, kl_w, class_w, w_kl_w) -> dict:
        opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(params, batch, generator, kl_w, class_w, w_kl_w)
        loss.backward()
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    def _rank_rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch (its shard of the data axis)."""
        import torch.distributed as dist

        b = batch_size // self.mesh.shape["data"]
        r = dist.get_rank()
        return slice(r * b, (r + 1) * b)

    def _dp_batch(self, data: dict, idx, generator) -> dict:
        """This rank's rows of the global batch ``idx`` and of the global
        batch's noise, drawn from ``generator`` where the single-device loss
        draws it."""
        noise = self.noise_fn(generator)
        mine = self._rank_rows(len(idx))
        local = {k: v.index_select(0, idx[mine]) for k, v in data.items()}
        return {**local, **{k: v[mine] for k, v in noise.items()}}

    def train_epoch(self, params, opt, data: dict, generator, kl_w, class_w, w_kl_w) -> dict:
        """One shuffled pass over ``data`` (dict of [N, ...] tensors); returns
        the mean of each metric, as device scalars (with a mesh: this rank's
        shard of each batch, the metrics averaged over the ranks)."""
        n = next(iter(data.values())).shape[0]
        perm = torch.randperm(n, generator=generator, device=generator.device)
        B = self.batch_size
        metrics = []
        for i in range(n // B):
            idx = perm[i * B:(i + 1) * B]
            if self.mesh is not None:
                batch = self._dp_batch(data, idx, generator)
                metrics.append(self._dp_step(params, opt, batch, None, kl_w, class_w, w_kl_w))
                continue
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            metrics.append(self.train_step(params, opt, batch, generator, kl_w, class_w,
                                           w_kl_w))
        return _mean(metrics)

    def train_epoch_streaming(self, params, opt, host_data: dict, generator, kl_w, class_w,
                              w_kl_w, rng: np.random.Generator, prefetch: int = 2) -> dict:
        """One epoch over host-side ``host_data`` (dict of [N, ...] NumPy
        arrays), for corpora that do not fit on the card: ``rng`` shuffles
        and slices the batches on the host (:mod:`..data.loader`), which
        stream to ``generator``'s device ``prefetch`` batches ahead; one
        :meth:`train_step` a batch, its noise from ``generator``. The
        semantics of :meth:`train_epoch`; only the data's residence and the
        shuffle's generator differ."""
        from ..data.loader import batch_iterator, device_prefetch

        batches = device_prefetch(batch_iterator(host_data, self.batch_size, rng), prefetch,
                                  generator.device)
        metrics = [self.train_step(params, opt, batch, generator, kl_w, class_w, w_kl_w)
                   for batch in batches]
        return _mean(metrics)

    @torch.no_grad()
    def eval_epoch(self, params, data: dict, generator, kl_w, class_w, w_kl_w) -> dict:
        """The batches of ``data`` in order; the mean of each metric (with a
        mesh: each rank's shard, the metrics averaged over the ranks)."""
        n = next(iter(data.values())).shape[0]
        B = self.batch_size
        metrics = []
        for i in range(n // B):
            if self.mesh is not None:
                idx = torch.arange(i * B, (i + 1) * B, device=generator.device)
                batch = self._dp_batch(data, idx, generator)
            else:
                batch = {k: v[i * B:(i + 1) * B] for k, v in data.items()}
            metrics.append(self.loss_fn(params, batch, generator, kl_w, class_w, w_kl_w)[1])
        m = _mean(metrics)
        if self.mesh is not None:
            from ..parallel.shard_map_step import average_metrics

            m = average_metrics(m)
        return m

    def train_epochs(self, params, opt, data: dict, val_data: dict, generator, kl_ws, class_w,
                     w_kl_ws):
        """E epochs in one call, E = ``len(kl_ws)``: each a training epoch
        (:meth:`train_epoch`) and a validation pass (:meth:`eval_epoch`) with
        that epoch's anneal weights ``kl_ws[e]``, ``w_kl_ws[e]``, their draws
        from ``generator`` in turn. Returns (params, opt, train metrics,
        validation metrics), each metric a [E] tensor; the parameters are
        updated in place. Best-epoch selection and early stopping stay with
        the caller, as in the JAX package's ``train_epochs``."""
        ms, vms = [], []
        for kl_w, w_kl_w in zip(kl_ws, w_kl_ws):
            kl_w, w_kl_w = float(kl_w), float(w_kl_w)
            ms.append(self.train_epoch(params, opt, data, generator, kl_w, class_w, w_kl_w))
            vms.append(self.eval_epoch(params, val_data, generator, kl_w, class_w, w_kl_w))
        return params, opt, _stack_epochs(ms), _stack_epochs(vms)


def _profiled(trace_dir: str, device: torch.device):
    """A ``torch.profiler.profile`` context that writes its Chrome trace
    into ``trace_dir`` when it closes."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir))


def fit(
    trainer: Trainer,
    params,
    train_data: dict,
    val_data: dict,
    num_epochs: int,
    generator: torch.Generator,
    kl_anneal: int = 0,
    w_kl_anneal: int = 0,
    class_weight: float = 1.0,
    patience: int = 5,
    min_epoch: int = 0,
    checkpoint_path: str | None = None,
    verbose: bool = True,
    log_fn: Callable | None = None,
    opt_state: list | None = None,
    initial_epoch: int = 0,
    save_last: bool = False,
    trace_dir: str | None = None,
    streaming: bool = False,
    stream_seed: int = 0,
):
    """Run the full training schedule; returns (params, best_params,
    history, best_loss).

    ``min_epoch`` gates checkpointing and early stopping (the CLI passes
    ``max(kl_anneal, w_kl_anneal) + 1``); the best epoch minimizes val_loss
    over epochs >= ``min_epoch``. The caller's ``params`` are not changed.

    Resume, as the JAX ``fit``: ``opt_state`` (the leaves that
    :func:`.checkpoint.load_opt_state` reads) and ``initial_epoch`` continue
    a run, whose epochs then run from ``initial_epoch`` to ``num_epochs``
    with the anneal schedules at those epochs; ``save_last`` writes
    ``<run>.last.npz`` and its ``.opt.npz`` (the epoch count reached) after
    every epoch. A resumed run draws its shuffles and noise from
    ``generator`` as the caller seeded it: the JAX package's keys cannot be
    replayed by a ``torch.Generator``, and a run resumed in either package
    draws other permutations and noise than the uninterrupted run would
    have (the CLIs seed a new generator from ``--seed``).

    ``log_fn(epoch, logs)`` is called once an epoch (``--do_log``).
    ``trace_dir`` profiles one epoch, the run's second (``initial_epoch +
    1``; the first carries the warm-up), with CPU activity and, on the
    card, CUDA activity, and writes its Chrome trace into ``trace_dir``
    (``tensorboard_trace_handler``: TensorBoard's profile view opens it).
    ``streaming`` trains through :meth:`Trainer.train_epoch_streaming`:
    ``train_data`` moves to host NumPy arrays and one NumPy generator seeded
    ``stream_seed`` shuffles every epoch, as in the JAX package.
    """
    params = copy_params(params, requires_grad=True)
    opt = trainer.init_optimizer(params)
    order = sorted_leaves(params)
    if opt_state is not None:
        opt.load_state_leaves(order, opt_state)
    kl_sched = AnnealSchedule(0.1, 1.0, kl_anneal)
    w_kl_sched = AnnealSchedule(0.0, 1.0, w_kl_anneal)
    stopper = EarlyStoppingAfterEpoch(min_epoch=min_epoch, patience=patience)
    ckpt = CheckpointPolicy(min_epoch=min_epoch)
    history: dict[str, list] = {}
    best_params = params
    stream_rng = np.random.default_rng(stream_seed) if streaming else None
    if streaming:
        train_data = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                      for k, v in train_data.items()}

    for epoch in range(initial_epoch, num_epochs):
        t0 = time.perf_counter()
        kl_w = float(np.float32(kl_sched(epoch)))
        w_kl_w = float(np.float32(w_kl_sched(epoch)))
        class_w = float(np.float32(class_weight))
        trace = trace_dir is not None and epoch == initial_epoch + 1
        with _profiled(trace_dir, generator.device) if trace else contextlib.nullcontext():
            if streaming:
                m = trainer.train_epoch_streaming(params, opt, train_data, generator, kl_w,
                                                  class_w, w_kl_w, stream_rng)
            else:
                m = trainer.train_epoch(params, opt, train_data, generator, kl_w, class_w,
                                        w_kl_w)
            vm = trainer.eval_epoch(params, val_data, generator, kl_w, class_w, w_kl_w)
            logs = {k: float(v) for k, v in m.items()}  # reads the device: the epoch's end
            logs.update({f"val_{k}": float(v) for k, v in vm.items()})
        for k, v in logs.items():
            history.setdefault(k, []).append(v)
        if verbose:
            print(f"epoch {epoch + 1}/{num_epochs} loss={logs['loss']:.3f} "
                  f"val_loss={logs['val_loss']:.3f} w_acc={logs.get('w_acc', 0):.3f} "
                  f"kl_w={kl_w:.2f} ({time.perf_counter() - t0:.2f}s)")
        if log_fn is not None:
            log_fn(epoch, logs)
        if ckpt.should_save(epoch, logs["val_loss"]):
            best_params = copy_params(params)
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, best_params)
        if save_last and checkpoint_path is not None:
            save_checkpoint(checkpoint_path.replace(".npz", ".last.npz"), params,
                            opt.state_leaves(order), epoch + 1)
        if patience > 0 and stopper.should_stop(epoch, logs["val_loss"]):
            break

    val_losses = history.get("val_loss", [])
    masked = [v if i >= min_epoch else np.inf for i, v in enumerate(val_losses)]
    best_ind = int(np.argmin(masked)) if masked else 0
    best_loss = {k: v[best_ind] for k, v in history.items() if v}
    return params, best_params, history, best_loss
