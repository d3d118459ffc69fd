"""Device meshes: the batch split over a ``data`` axis, the parameters'
columns over a ``model`` axis.

Counterpart of ``classifying_vae_lstm_tpu/parallel/mesh.py``. The JAX
package drives every device from one controller (``jax.sharding.Mesh``,
arrays placed with ``NamedSharding``s). The port splits that by PyTorch's
idiom:

* training runs one process per device under ``torch.distributed`` (NCCL
  on the card, gloo on the CPU): a rank owns its row shard of every global
  batch and averages the gradients with an explicit ``all_reduce``
  (:mod:`.shard_map_step`, :class:`..train.Trainer`'s mesh path);
* generation, evaluation and serving run in one process over the mesh's
  devices with zero collectives: each shard is one call of the
  single-device function on its device, the results gathered on the first;
* the ``model`` axis (tensor parallelism) lives inside the process that
  owns a data shard: a parameter whose placement JAX's rule column-shards
  becomes a :class:`.columns.ColumnShards`, slice j on the row's model
  device j; the plain products run column-parallel and the fused kernels
  take their weights gathered (:mod:`.columns`). No collective runs over
  the model axis, so one card repeated in a row stands in for it.

A :class:`Mesh` is the ``('data', 'model')`` grid of ``torch.device``s that
both read. Its device list may repeat a device, so a CPU or one card can
stand in for several. With ``n_model == 1`` (every CLI's mesh) the
parameters are replicated and the batch split along its first axis, as
JAX's rules give them.

Weight-norm interplay, as in JAX: the optimizer's g/V split reduces over
all-but-last axes of each kernel (``..optim.adamwn``), so a column slice's
update needs no other slice.
"""

from __future__ import annotations

import torch

from .columns import ColumnShards, column_sharded


class Mesh:
    """A grid of devices ``[n_data][n_model]`` with the axis names
    ``('data', 'model')``; ``shape`` maps each name to its size, as JAX's
    ``Mesh.shape`` does."""

    axis_names = ("data", "model")

    def __init__(self, devices):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or \
                len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def data_devices(self) -> list:
        """The device of each data shard (the first of its model axis)."""
        return [row[0] for row in self.devices]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[[str(d) for d in r] for r in self.devices]})"


def default_devices() -> list:
    """Every CUDA card of this machine; raises without one (the CPU stands
    in for a mesh only when named: ``make_mesh(devices=["cpu"] * n)``)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA card for a default mesh: torch.cuda.device_count() is 0; "
                           "pass devices=['cpu'] * n to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """Build a ``('data', 'model')`` mesh. ``devices`` defaults to every
    card (:func:`default_devices`) and may repeat a device; ``n_data``
    defaults to all of them on the data axis."""
    devices = list(devices) if devices is not None else default_devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"need {n_data}x{n_model} devices, have {len(devices)}")
    flat = devices[: n_data * n_model]
    return Mesh([flat[i * n_model:(i + 1) * n_model] for i in range(n_data)])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, data: dict) -> list:
    """Split [N, ...] tensors along their first axis over the mesh's data
    axis: one dict a shard, on the shard's device. N must divide by the
    data axis, as a ``NamedSharding`` of the batch requires."""
    n = next(iter(data.values())).shape[0]
    n_data = mesh.shape["data"]
    if n % n_data:
        raise ValueError(f"batch {n} not divisible by data axis {n_data}")
    b = n // n_data
    return [{k: torch.as_tensor(v)[i * b:(i + 1) * b].to(dev) for k, v in data.items()}
            for i, dev in enumerate(mesh.data_devices)]


def _placed(leaf, row, shard: bool):
    """One leaf on a mesh row (its model devices): column shards where
    ``shard`` and JAX's rule say so, else whole on the row's data device."""
    if isinstance(leaf, ColumnShards):
        if len(leaf.slices) == len(row):
            return ColumnShards(s.to(dev) for s, dev in zip(leaf.slices, row))
        leaf = leaf.gather(row[0])
    if not (torch.is_tensor(leaf) or hasattr(leaf, "shape")):
        return leaf
    leaf = torch.as_tensor(leaf)
    if shard and column_sharded(leaf.shape, len(row)):
        return ColumnShards.split(leaf, row)
    return leaf.to(row[0])


def param_sharding_rules(params, mesh: Mesh, shard_model_axis: bool = True):
    """The placement of each parameter, a tree of the parameters' shape:
    ``(None, ..., "model")`` (JAX's ``PartitionSpec``) for a leaf of rank
    >= 2 whose last dimension divides by the model axis, when that axis is
    longer than 1 and ``shard_model_axis``; ``"replicated"`` otherwise."""
    n_model = mesh.shape["model"] if shard_model_axis else 1
    return _tree_map(lambda p: (None,) * (len(p.shape) - 1) + ("model",)
                     if column_sharded(p.shape, n_model) else "replicated", params)


def _place(tree, mesh: Mesh, shard: bool) -> list:
    """One copy of ``tree`` a data shard, on the shard's row of the mesh
    (:func:`_placed`); rows of the same devices share one copy, and tensors
    already where they belong are not copied for it."""
    copies = {}
    for row in mesh.devices:
        key = tuple(row)
        if key not in copies:
            copies[key] = _tree_map(lambda a: _placed(a, row, shard), tree)
    return [copies[tuple(row)] for row in mesh.devices]


def _replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` a data shard, its plain tensors on the shard's
    device and its column shards on the shard's model devices."""
    return _place(tree, mesh, shard=False)


def shard_params(params, mesh: Mesh, shard_model_axis: bool = True) -> list:
    """Place ``params`` as :func:`param_sharding_rules` says: one copy a data
    shard, its column-sharded leaves :class:`.columns.ColumnShards` over the
    shard's model devices, the rest on the shard's device."""
    return _place(params, mesh, shard_model_axis)


def shard_opt_state(opt_state, mesh: Mesh) -> list:
    """Place an optimizer's state leaves (a tree or list of them, e.g.
    :meth:`..optim.adamwn.LeafOptimizer.state_leaves`) as JAX does: the
    moments have their parameters' shapes and the same rule applies, the
    rest (counts, per-column vectors) replicated."""
    return _place(opt_state, mesh, True)


def shard_training_state(mesh: Mesh, params, train_data: dict, val_data: dict,
                         shard_model_axis: bool = True):
    """A training run's inputs on ``mesh``: (params placed by
    :func:`shard_params`, train shards, val shards), as the JAX function
    returns them placed."""
    params = shard_params(params, mesh, shard_model_axis)
    return params, shard_batch(mesh, train_data), shard_batch(mesh, val_data)
