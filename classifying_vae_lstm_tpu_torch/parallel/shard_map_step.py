"""The data-parallel training step, written out per rank with its collective.

Counterpart of ``classifying_vae_lstm_tpu/parallel/shard_map_step.py``,
where ``jax.shard_map`` writes out the per-device program: the local
forward and backward on the device's batch shard, then ``pmean`` of the
gradients and metrics over the ``data`` axis. Here each device is a process
of a ``torch.distributed`` world (one rank a device; NCCL on the card, gloo
on the CPU), and the same program is the rank's: the model's ordinary loss
on its shard (which reaches the same kernel wrappers as a single-device
step), one ``all_reduce`` of the flattened gradients divided by the world
size, the same for the metrics, then the optimizer's step, which every rank
takes on equal gradients. No ``DistributedDataParallel`` wrapper: the
parameters are dict trees, not an ``nn.Module``. A rank whose parameters
are column-sharded over its model devices (:mod:`.columns`) averages every
slice's gradient: the slices are leaves like any other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .columns import tensor_leaves
from .mesh import Mesh, _replicate


def fold_in(seed: int, index: int) -> int:
    """A seed for shard ``index`` of a run seeded ``seed``: JAX's
    ``fold_in(key, axis_index)``, which gives each shard its own stream."""
    return (seed * 0x9E3779B1 + index + 1) % (1 << 63)


def all_reduce_mean(tensors: list) -> None:
    """Average ``tensors`` in place over the default process group: one
    ``all_reduce`` (sum) of their concatenation, then a division by the
    world size; JAX's ``pmean``. The buffer lies on the first tensor's
    device (a rank's data device; column slices on its other model devices
    are copied there and back)."""
    if not tensors:
        return
    dev = tensors[0].device
    flat = torch.cat([t.reshape(-1).to(dev) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def average_metrics(metrics: dict) -> dict:
    """``metrics`` (scalar tensors) averaged over the ranks."""
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in names])
    all_reduce_mean([vals])
    return dict(zip(names, vals.unbind()))


def _grad_leaves(params) -> list:
    """The gradients of every tensor of ``params``, column slices included."""
    return [t.grad for t in tensor_leaves(params) if t.grad is not None]


def make_shard_map_train_step(loss_fn, optimizer, mesh: Mesh):
    """The DP train step of one rank.

    ``loss_fn(params, batch, generator, kl_w, class_w, w_kl_w) -> (loss,
    metrics)``; ``optimizer`` the ``torch.optim.Optimizer`` over the leaves
    of ``params`` (a constructor's instance, as :meth:`..train.Trainer.
    init_optimizer` makes it). The step ``step(params, opt, batch,
    generator, kl_w, class_w, w_kl_w) -> metrics`` takes this rank's shard
    of the batch, its gradients and metrics averaged over the ranks (which
    must number ``mesh.shape["data"]``); ``opt`` is the optimizer over
    ``params`` (``optimizer`` where None). Every rank holds the same
    parameters and takes the same update.

    The noise: with a ``generator`` (in the same state on every rank) each
    rank draws its shard's noise from its own stream, seeded by one draw of
    ``generator`` folded with the rank (:func:`fold_in`), as the JAX step
    folds its key with the axis index; with ``generator=None`` the batch
    carries the noise of its rows (``eps_w``, ``eps_z``), as in
    :class:`..train.Trainer`'s mesh path, whose steps then equal the
    single-device ones.
    """
    n_data = mesh.shape["data"]

    def step(params, opt, batch, generator, kl_w, class_w, w_kl_w) -> dict:
        if dist.get_world_size() != n_data:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, the "
                             f"mesh's data axis {n_data}")
        opt = optimizer if opt is None else opt
        if generator is not None:
            seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                                     device=generator.device))
            generator = torch.Generator(device=generator.device).manual_seed(
                fold_in(seed, dist.get_rank()))
        opt.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, batch, generator, kl_w, class_w, w_kl_w)
        loss.backward()
        with torch.no_grad():
            all_reduce_mean(_grad_leaves(params))  # THE data-parallel collective
        opt.step()
        return average_metrics(metrics)

    return step


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` a data shard of ``mesh``, on its device (a
    repeated device shares one copy; a tree already on a device is not
    copied for it): JAX's ``device_put`` of a replicated tree."""
    return _replicate(tree, mesh)
