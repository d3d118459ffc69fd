"""Numerics debugging: fail fast on NaN/Inf with a named culprit.

Counterpart of ``classifying_vae_lstm_tpu/train/debug.py``.
:func:`check_first_batch` runs one loss and ``torch.autograd`` gradient
evaluation on the first batch (through the kernels of the model's route on
the card) and raises with the path of every parameter or tensor that went
non-finite; the train CLIs' ``--check_numerics`` calls it before training.
The messages are the JAX package's.
"""

from __future__ import annotations

import torch


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def assert_finite_pytree(tree, what: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming every non-finite leaf of a tree of
    dicts, lists and tensors (or arrays, or numbers)."""
    bad = []
    for path, leaf in _walk(tree):
        arr = torch.as_tensor(leaf)
        finite = torch.isfinite(arr)
        if not bool(finite.all()):
            n_bad = int((~finite).sum())
            bad.append(f"{path} ({n_bad}/{arr.numel()} non-finite)")
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: " + "; ".join(bad))


def _with_leaves(tree, leaves):
    """``tree``'s structure with its leaves, in :func:`_walk` order, replaced."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves) for k, v in tree.items()}
    return next(leaves)


def check_first_batch(loss_fn, params, batch, generator, *loss_args) -> dict:
    """Evaluate the loss and its parameter gradients once and assert that
    all are finite. ``loss_fn(params, batch, generator, *loss_args) ->
    (loss, metrics)``; ``params`` is not changed. Returns the metrics as
    floats."""
    assert_finite_pytree(params, "params")
    assert_finite_pytree(batch, "batch")
    leaves = [leaf.detach().clone().requires_grad_(True) for _, leaf in _walk(params)]
    p = _with_leaves(params, iter(leaves))
    loss, metrics = loss_fn(p, batch, generator, *loss_args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    assert_finite_pytree({"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}},
                         "loss/metrics")
    assert_finite_pytree(_with_leaves(params, iter(grads)), "gradients")
    return {k: float(v.detach()) for k, v in metrics.items()}
