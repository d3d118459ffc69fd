"""Tensor-parallel column shards: one parameter split over a mesh's ``model`` axis.

Counterpart of the JAX package's column ``NamedSharding``
(``PartitionSpec(None, ..., "model")``, ``parallel/mesh.py``), where GSPMD
partitions every product with a column-sharded operand. The port keeps the
model axis inside one process: a :class:`ColumnShards` holds the ``n_model``
contiguous last-dimension slices of a parameter, slice j on model device j,
each slice a tensor of its own (a leaf that ``torch.optim`` and autograd see
as one parameter).

* :func:`matmul` / :func:`matmul_sum` are the column-parallel products: each
  slice's product runs on its device, the outputs are concatenated on the
  input's device (the all-gather GSPMD inserts). ``SHARD_PRODUCTS`` counts
  the slice products, as the kernel wrappers count their launches.
* :func:`gather_tree` gives a fused kernel its weights whole, as a
  ``pallas_call`` (which has no partitioning rule) receives them under
  JAX's TP: ``torch.cat`` over the slices, which autograd splits back into
  each slice's gradient.
* :meth:`ColumnShards.split` places a tensor by :func:`column_sharded`,
  JAX's rule word for word: rank >= 2 and a last dimension that divides by
  ``n_model``.
"""

from __future__ import annotations

import numpy as np
import torch

SHARD_PRODUCTS = 0  # slice products of matmul / matmul_sum


def column_sharded(shape, n_model: int) -> bool:
    """JAX's rule: a leaf of ``shape`` is column-sharded over ``n_model > 1``
    devices when its rank is >= 2 and its last dimension divides by them."""
    return n_model > 1 and len(shape) >= 2 and shape[-1] % n_model == 0


class ColumnShards:
    """The contiguous last-dimension slices of one tensor, each on its model
    device. Row indexing (``k[:n]``), ``.to(dtype)`` and :meth:`map` apply
    slice by slice and give a ``ColumnShards``; ``shape``, ``ndim``,
    ``dtype`` describe the whole tensor."""

    __slots__ = ("slices",)

    def __init__(self, slices):
        self.slices = list(slices)
        if not self.slices or len({s.shape[:-1] for s in self.slices}) != 1:
            raise ValueError("column shards need one or more slices of equal leading shape")

    @classmethod
    def split(cls, tensor, devices) -> "ColumnShards":
        """``tensor``'s columns in ``len(devices)`` equal contiguous slices,
        slice j a copy on ``devices[j]``; each slice is a leaf that requires
        grad where ``tensor`` does (a parameter of its own)."""
        n = len(devices)
        w = tensor.shape[-1] // n
        if w * n != tensor.shape[-1]:
            raise ValueError(f"last dimension {tensor.shape[-1]} does not divide by {n}")
        t, rg = tensor.detach(), tensor.requires_grad
        return cls(t[..., j * w:(j + 1) * w].to(dev, copy=True,
                                                memory_format=torch.contiguous_format)
                   .requires_grad_(rg) for j, dev in enumerate(devices))

    @property
    def shape(self) -> torch.Size:
        return torch.Size((*self.slices[0].shape[:-1], sum(self.widths)))

    @property
    def widths(self) -> list:
        return [s.shape[-1] for s in self.slices]

    @property
    def ndim(self) -> int:
        return self.slices[0].dim()

    @property
    def dtype(self):
        return self.slices[0].dtype

    @property
    def devices(self) -> list:
        return [s.device for s in self.slices]

    @property
    def device(self):
        """The first slice's device (the data device of the mesh row)."""
        return self.slices[0].device

    def map(self, fn) -> "ColumnShards":
        return ColumnShards(fn(s) for s in self.slices)

    def to(self, *args, **kwargs) -> "ColumnShards":
        return self.map(lambda s: s.to(*args, **kwargs))

    def __getitem__(self, rows) -> "ColumnShards":
        """Index the leading dimensions of every slice; the columns stay
        whole (``k[:n]`` is the first n rows of a kernel)."""
        if isinstance(rows, tuple) and (len(rows) >= self.ndim or Ellipsis in rows):
            raise IndexError("column shards index their leading dimensions only")
        return self.map(lambda s: s[rows])

    def columns(self, lo: int, hi: int) -> "ColumnShards":
        """Columns ``[lo, hi)``: the parts of the slices that cover them,
        each on its slice's device."""
        parts, start = [], 0
        for s in self.slices:
            a, b = max(lo, start), min(hi, start + s.shape[-1])
            if a < b:
                parts.append(s[..., a - start:b - start])
            start += s.shape[-1]
        return ColumnShards(parts)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first slice's by default):
        ``torch.cat`` over the last dimension, differentiable."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in self.slices], dim=-1)

    def numpy(self) -> np.ndarray:
        """The whole tensor as a NumPy array on the host."""
        return np.concatenate([s.detach().cpu().numpy() for s in self.slices], axis=-1)

    def __repr__(self):
        return (f"ColumnShards(shape={tuple(self.shape)}, widths={self.widths}, "
                f"devices={[str(d) for d in self.devices]})")


def matmul_sum(terms) -> torch.Tensor:
    """``sum_i a_i @ w_i`` for ``terms = [(a_i, w_i), ...]`` whose ``w_i``
    are :class:`ColumnShards` of one column split, or plain tensors (then
    ``torch.matmul`` as ever). Slice j's terms are multiplied and summed in
    order on its device; the slices' sums are concatenated on the first
    ``a``'s device."""
    global SHARD_PRODUCTS
    if not isinstance(terms[0][1], ColumnShards):
        out = None
        for a, w in terms:
            p = torch.matmul(a, w)
            out = p if out is None else out + p
        return out
    home = terms[0][0].device
    parts = []
    for j in range(len(terms[0][1].slices)):
        acc = None
        for a, w in terms:
            s = w.slices[j]
            p = torch.matmul(a.to(s.device), s)
            acc = p if acc is None else acc + p
            SHARD_PRODUCTS += 1
        parts.append(acc.to(home))
    return torch.cat(parts, dim=-1)


def matmul(a, w) -> torch.Tensor:
    """``a @ w``, column-parallel over ``w``'s slices where ``w`` is a
    :class:`ColumnShards` (:func:`matmul_sum` of one term)."""
    return matmul_sum([(a, w)])


def gather_tree(tree, device):
    """``tree`` with every :class:`ColumnShards` gathered whole on ``device``
    (other leaves as they are): the weights of a fused kernel."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return tree.gather(device) if isinstance(tree, ColumnShards) else tree


def tensor_leaves(tree) -> list:
    """The tensors of a parameter tree, depth first in dict order, each
    :class:`ColumnShards` contributing its slices: the leaves an optimizer
    updates and a data-parallel step averages."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    return list(tree.slices) if isinstance(tree, ColumnShards) else [tree]

