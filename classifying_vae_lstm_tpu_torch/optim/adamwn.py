"""Weight-normalized optimizers (Salimans & Kingma) and Keras Adam / RMSprop.

The JAX package's ``optim/adamwn.py`` as ``torch.optim.Optimizer``
subclasses with per-parameter state:

* every rank >= 2 weight W is implicitly ``W = g * V / ||V||`` through a
  persistent per-column scaler ``v_scaler = g / ||V||`` (init ones); the
  gradient on W is split into ``(grad_g, grad_V)`` (:func:`_split_wn_grads`),
  the moments are kept for g (per column) and V (full shape), the update runs
  in (g, V) space and the new W is written back (:func:`_write_back`);
* rank-1 parameters (biases) get the plain update;
* Adam folds the Keras-2.0 bias correction into the learning rate,
  ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, computed in float32.

Every update is applied as ``p += update`` with ``update = new - p``, as
``optax.apply_updates`` does, so both packages round alike. A parameter
without a gradient is updated with a zero gradient, as the JAX
transformations see one. The ``*`` factory functions keep the JAX names and
hyper-defaults and return a constructor that takes the parameters.

Each optimizer maps its state to the leaves of the JAX optimizer's state
and back (:meth:`LeafOptimizer.state_leaves`, ``load_state_leaves``), the
layout of ``<run>.opt.npz``, so a training run resumes in either package.

A column-sharded parameter (``parallel.columns.ColumnShards``, tensor
parallelism) is one optimizer parameter per slice, its state on the slice's
device: every reduction of the g/V split runs over all-but-last axes, so a
slice's update is the whole update's columns. The ``.opt.npz`` layout stays
whole: saving concatenates the slices' state, loading splits it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.columns import ColumnShards


def _decayed_lr(lr, decay, step: int) -> float:
    """Keras's pre-increment decay, ``lr / (1 + decay * (t - 1))``, in float32."""
    if decay <= 0:
        return lr
    f = np.float32
    return float(f(lr) / (f(1.0) + f(decay) * (f(step) - f(1.0))))


def _keras_lr_t(lr, b1, b2, step: int) -> float:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32, as the JAX package
    computes it from its int32 step count."""
    t, one = np.float32(step), np.float32(1.0)
    return float(np.float32(lr) * np.sqrt(one - np.float32(b2) ** t)
                 / (one - np.float32(b1) ** t))


class LeafOptimizer(torch.optim.Optimizer):
    """Base of the port's optimizers: per-parameter state made by
    :meth:`_init_state`, one :meth:`_update` per parameter and step; the
    state's ``step`` counts the steps taken (the JAX ``count``).

    ``STATE_FIELDS`` lists the fields of the JAX optimizer's state in the
    order of ``jax.tree.leaves``: ``"count"`` (the int32 step count),
    ``"m_schedule"`` (Nadam's float32 scalar, the same in every parameter's
    state here), or the name of a per-parameter state entry, whose leaves
    follow the parameters in the JAX order."""

    STATE_FIELDS: tuple[str, ...] = ()
    _SCALARS = {"count": np.int32, "m_schedule": np.float32}

    def __init__(self, params, **defaults):
        super().__init__(params, defaults)

    def state_leaves(self, params: list) -> list[np.ndarray]:
        """The state as the leaves of the JAX optimizer's state, for
        ``params`` (this optimizer's parameter tensors, or column shards of
        them) in ``jax.tree.leaves`` order of their tree
        (:func:`..train.checkpoint.sorted_leaves`); a parameter without state
        yet contributes its initial state, column shards their slices'
        states concatenated over the last axis."""
        state = lambda p: self.state[p] or {"step": 0, **self._init_state(p)}
        states = [[state(s) for s in p.slices] if isinstance(p, ColumnShards) else [state(p)]
                  for p in params]
        host = lambda parts: np.concatenate([t.detach().cpu().numpy() for t in parts], -1)
        out = []
        for field in self.STATE_FIELDS:
            if field in self._SCALARS:
                value = states[0][0]["step"] if field == "count" else states[0][0][field]
                out.append(np.asarray(value, self._SCALARS[field]))
            else:
                out += [host([st[field] for st in sts]) for sts in states]
        return out

    def load_state_leaves(self, params: list, leaves: list) -> None:
        """Set the state from the leaves of :meth:`state_leaves` (or of the
        JAX optimizer's state, as ``<run>.opt.npz`` holds them). An
        optimizer whose JAX state has no ``count`` (RMSprop, Adagrad,
        Adadelta) reads no step count, and its ``step`` restarts at 0. A
        column-sharded parameter takes its whole-shape state split over its
        slices (a leaf given as column shards is gathered first)."""
        fields = self.STATE_FIELDS
        want = sum(1 if f in self._SCALARS else len(params) for f in fields)
        if len(leaves) != want:
            raise ValueError(f"{type(self).__name__} state has {want} leaves for "
                             f"{len(params)} parameters, got {len(leaves)}")
        it = iter(leaves)
        shared, per = {"step": 0}, {}
        for field in fields:
            if field == "count":
                shared["step"] = int(next(it))
            elif field in self._SCALARS:
                shared[field] = float(np.float32(next(it)))
            else:
                per[field] = [next(it) for _ in params]
        for i, p in enumerate(params):
            whole = {f: _host(values[i]) for f, values in per.items()}
            if isinstance(p, ColumnShards):
                cuts = np.cumsum(p.widths)[:-1]
                for j, s in enumerate(p.slices):
                    self._load_one(s, shared, {f: np.split(v, cuts, axis=-1)[j]
                                               for f, v in whole.items()}, i)
            else:
                self._load_one(p, shared, whole, i)

    def _load_one(self, p, shared: dict, fields: dict, i: int) -> None:
        init = self._init_state(p)
        st = dict(shared)
        for field, value in fields.items():
            v = torch.from_numpy(np.ascontiguousarray(value)).to(device=p.device, dtype=p.dtype)
            if v.shape != init[field].shape:
                raise ValueError(f"{field} of parameter {i}: shape {tuple(v.shape)}, "
                                 f"expected {tuple(init[field].shape)}")
            st[field] = v
        self.state[p] = st

    def _init_state(self, p) -> dict:
        raise NotImplementedError

    def _update(self, p, g, st: dict, group: dict) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st.update(step=0, **self._init_state(p))
                st["step"] += 1
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                self._update(p, g, st, group)
        return loss


def _host(leaf) -> np.ndarray:
    """A state leaf (array, tensor on any device, or column shards) as a
    whole NumPy array."""
    if isinstance(leaf, ColumnShards):
        return leaf.numpy()
    return leaf.detach().cpu().numpy().copy() if torch.is_tensor(leaf) else np.array(leaf)


def _g_shaped(p):
    return p.new_zeros((p.shape[-1],) if p.dim() > 1 else (0,))


def _scaler_init(p):
    return p.new_ones((p.shape[-1],)) if p.dim() > 1 else p.new_zeros((0,))


def _split_wn_grads(p, g, v_scaler):
    """W-space (param, grad) -> (V, V_norm, g_param, grad_g, grad_V)."""
    axes = tuple(range(p.dim() - 1))
    scaler = v_scaler.reshape((1,) * len(axes) + (-1,))
    V = p / scaler
    V_norm = torch.sqrt(torch.sum(torch.square(V), axes))
    g_param = v_scaler * V_norm
    grad_g = torch.sum(g * V, axes) / V_norm
    grad_V = scaler * (g - (grad_g / V_norm).reshape(scaler.shape) * V)
    return V, V_norm, g_param, grad_g, grad_V


def _write_back(new_V, new_g):
    """(V, g) -> (W, v_scaler)."""
    axes = tuple(range(new_V.dim() - 1))
    new_V_norm = torch.sqrt(torch.sum(torch.square(new_V), axes))
    new_scaler = new_g / new_V_norm
    return new_scaler.reshape((1,) * len(axes) + (-1,)) * new_V, new_scaler


class AdamWithWeightnorm(LeafOptimizer):
    """AdamWithWeightnorm with the Keras Adam hyper-defaults. State per
    parameter: ``m``, ``v`` (V-space for rank >= 2), ``m_g``, ``v_g`` (per
    column; empty for rank < 2) and ``v_scaler``."""

    STATE_FIELDS = ("count", "m", "v", "m_g", "v_g", "v_scaler")

    def __init__(self, params, lr=0.001, b1=0.9, b2=0.999, eps=1e-8, decay=0.0):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps, decay=decay)

    def _init_state(self, p):
        return dict(m=torch.zeros_like(p), v=torch.zeros_like(p), m_g=_g_shaped(p),
                    v_g=_g_shaped(p), v_scaler=_scaler_init(p))

    def _update(self, p, g, st, group):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        lr_t = _keras_lr_t(_decayed_lr(group["lr"], group["decay"], st["step"]), b1, b2,
                           st["step"])
        if p.dim() > 1:
            V, _, g_param, grad_g, grad_V = _split_wn_grads(p, g, st["v_scaler"])
            st["m_g"] = b1 * st["m_g"] + (1 - b1) * grad_g
            st["v_g"] = b2 * st["v_g"] + (1 - b2) * torch.square(grad_g)
            new_g = g_param - lr_t * st["m_g"] / (torch.sqrt(st["v_g"]) + eps)
            st["m"] = b1 * st["m"] + (1 - b1) * grad_V
            st["v"] = b2 * st["v"] + (1 - b2) * torch.square(grad_V)
            new_V = V - lr_t * st["m"] / (torch.sqrt(st["v"]) + eps)
            new_W, st["v_scaler"] = _write_back(new_V, new_g)
            p.add_(new_W - p)
        else:
            st["m"] = b1 * st["m"] + (1 - b1) * g
            st["v"] = b2 * st["v"] + (1 - b2) * torch.square(g)
            p.add_(-lr_t * st["m"] / (torch.sqrt(st["v"]) + eps))


class SGDWithWeightnorm(LeafOptimizer):
    """SGDWithWeightnorm. State per parameter: ``momentum`` (V-space for
    rank >= 2), ``momentum_g`` (per column) and ``v_scaler``."""

    STATE_FIELDS = ("count", "momentum", "momentum_g", "v_scaler")

    def __init__(self, params, lr=0.01, momentum=0.0, decay=0.0, nesterov=False):
        super().__init__(params, lr=lr, momentum=momentum, decay=decay, nesterov=nesterov)

    def _init_state(self, p):
        return dict(momentum=torch.zeros_like(p), momentum_g=_g_shaped(p),
                    v_scaler=_scaler_init(p))

    def _update(self, p, g, st, group):
        mu, nesterov = group["momentum"], group["nesterov"]
        lr = _decayed_lr(group["lr"], group["decay"], st["step"])
        if p.dim() > 1:
            V, _, g_param, grad_g, grad_V = _split_wn_grads(p, g, st["v_scaler"])
            v_g = mu * st["momentum_g"] - lr * grad_g
            new_g = g_param + mu * v_g - lr * grad_g if nesterov else g_param + v_g
            v_v = mu * st["momentum"] - lr * grad_V
            new_V = V + mu * v_v - lr * grad_V if nesterov else V + v_v
            new_W, st["v_scaler"] = _write_back(new_V, new_g)
            st["momentum"], st["momentum_g"] = v_v, v_g
            p.add_(new_W - p)
        else:
            v = mu * st["momentum"] - lr * g
            st["momentum"] = v
            p.add_(mu * v - lr * g if nesterov else v)


class KerasAdam(LeafOptimizer):
    """Plain Adam with Keras 2.0 semantics (lr-folded bias correction)."""

    STATE_FIELDS = ("count", "m", "v")

    def __init__(self, params, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps)

    def _init_state(self, p):
        return dict(m=torch.zeros_like(p), v=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        b1, b2 = group["b1"], group["b2"]
        lr_t = _keras_lr_t(group["lr"], b1, b2, st["step"])
        st["m"] = b1 * st["m"] + (1 - b1) * g
        st["v"] = b2 * st["v"] + (1 - b2) * torch.square(g)
        p.add_(-lr_t * st["m"] / (torch.sqrt(st["v"]) + group["eps"]))


class KerasRMSprop(LeafOptimizer):
    """RMSprop with Keras 2.0 defaults. State per parameter: ``acc``."""

    STATE_FIELDS = ("acc",)

    def __init__(self, params, lr=0.001, rho=0.9, eps=1e-8):
        super().__init__(params, lr=lr, rho=rho, eps=eps)

    def _init_state(self, p):
        return dict(acc=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        rho = group["rho"]
        st["acc"] = rho * st["acc"] + (1 - rho) * torch.square(g)
        p.add_(-group["lr"] * g / (torch.sqrt(st["acc"]) + group["eps"]))


def adam_with_weightnorm(learning_rate=0.001, b1=0.9, b2=0.999, eps=1e-8, decay=0.0):
    return functools.partial(AdamWithWeightnorm, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                             decay=decay)


def sgd_with_weightnorm(learning_rate=0.01, momentum=0.0, decay=0.0, nesterov=False):
    return functools.partial(SGDWithWeightnorm, lr=learning_rate, momentum=momentum,
                             decay=decay, nesterov=nesterov)


def keras_adam(learning_rate=0.001, b1=0.9, b2=0.999, eps=1e-8):
    return functools.partial(KerasAdam, lr=learning_rate, b1=b1, b2=b2, eps=eps)


def keras_rmsprop(learning_rate=0.001, rho=0.9, eps=1e-8):
    return functools.partial(KerasRMSprop, lr=learning_rate, rho=rho, eps=eps)
