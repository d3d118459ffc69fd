"""Plain Keras-2.0.0 optimizers: SGD, Adagrad, Adadelta, Adamax, Nadam.

The JAX package's ``optim/keras_optimizers.py`` as ``torch.optim.Optimizer``
subclasses (per-parameter state, ``p += update``), with the Keras 2.0.0
default hyperparameters and epsilon 1e-8: lr-folded bias correction,
pre-increment decay, Nadam's 0.96-schedule momentum cache. Together with
``KerasAdam`` / ``KerasRMSprop`` in :mod:`.adamwn` they cover every name
:func:`.factory.init_optimizer` resolves. ``STATE_FIELDS`` gives each the
field order of its JAX state (``<run>.opt.npz``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .adamwn import LeafOptimizer, _decayed_lr


class KerasSGD(LeafOptimizer):
    """v = mu*m - lr*g; p += mu*v - lr*g if nesterov else v."""

    STATE_FIELDS = ("count", "momentum")

    def __init__(self, params, lr=0.01, momentum=0.0, decay=0.0, nesterov=False):
        super().__init__(params, lr=lr, momentum=momentum, decay=decay, nesterov=nesterov)

    def _init_state(self, p):
        return dict(momentum=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        mu = group["momentum"]
        lr = _decayed_lr(group["lr"], group["decay"], st["step"])
        v = mu * st["momentum"] - lr * g
        st["momentum"] = v
        p.add_(mu * v - lr * g if group["nesterov"] else v)


class KerasAdagrad(LeafOptimizer):
    """a += g^2; p -= lr * g / (sqrt(a) + eps)."""

    STATE_FIELDS = ("acc",)

    def __init__(self, params, lr=0.01, eps=1e-8):
        super().__init__(params, lr=lr, eps=eps)

    def _init_state(self, p):
        return dict(acc=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        st["acc"] = st["acc"] + torch.square(g)
        p.add_(-group["lr"] * g / (torch.sqrt(st["acc"]) + group["eps"]))


class KerasAdadelta(LeafOptimizer):
    """RMS-ratio update with an accumulator of deltas."""

    STATE_FIELDS = ("acc", "delta_acc")

    def __init__(self, params, lr=1.0, rho=0.95, eps=1e-8):
        super().__init__(params, lr=lr, rho=rho, eps=eps)

    def _init_state(self, p):
        return dict(acc=torch.zeros_like(p), delta_acc=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        rho, eps = group["rho"], group["eps"]
        st["acc"] = rho * st["acc"] + (1 - rho) * torch.square(g)
        step = g * torch.sqrt(st["delta_acc"] + eps) / torch.sqrt(st["acc"] + eps)
        p.add_(-group["lr"] * step)
        st["delta_acc"] = rho * st["delta_acc"] + (1 - rho) * torch.square(step)


class KerasAdamax(LeafOptimizer):
    """Infinity-norm Adam, lr_t = lr / (1 - b1^t)."""

    STATE_FIELDS = ("count", "m", "u")

    def __init__(self, params, lr=0.002, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps)

    def _init_state(self, p):
        return dict(m=torch.zeros_like(p), u=torch.zeros_like(p))

    def _update(self, p, g, st, group):
        b1, b2 = group["b1"], group["b2"]
        t = np.float32(st["step"])
        lr_t = float(np.float32(group["lr"]) / (np.float32(1.0) - np.float32(b1) ** t))
        st["m"] = b1 * st["m"] + (1 - b1) * g
        st["u"] = torch.maximum(b2 * st["u"], torch.abs(g))
        p.add_(-lr_t * st["m"] / (st["u"] + group["eps"]))


class KerasNadam(LeafOptimizer):
    """Nesterov Adam with the 0.96^t momentum schedule. State per parameter:
    ``m``, ``v`` and ``m_schedule`` (the same product in every parameter)."""

    STATE_FIELDS = ("count", "m_schedule", "m", "v")

    def __init__(self, params, lr=0.002, b1=0.9, b2=0.999, eps=1e-8, schedule_decay=0.004):
        super().__init__(params, lr=lr, b1=b1, b2=b2, eps=eps, schedule_decay=schedule_decay)

    def _init_state(self, p):
        return dict(m=torch.zeros_like(p), v=torch.zeros_like(p), m_schedule=1.0)

    def _update(self, p, g, st, group):
        f = np.float32
        b1, b2, sd = f(group["b1"]), f(group["b2"]), f(group["schedule_decay"])
        t = f(st["step"])
        cache_t = b1 * (f(1.0) - f(0.5) * f(0.96) ** (t * sd))
        cache_t1 = b1 * (f(1.0) - f(0.5) * f(0.96) ** ((t + f(1.0)) * sd))
        m_schedule_new = f(st["m_schedule"]) * cache_t
        m_schedule_next = m_schedule_new * cache_t1
        st["m_schedule"] = float(m_schedule_new)
        st["m"] = group["b1"] * st["m"] + (1 - group["b1"]) * g
        st["v"] = group["b2"] * st["v"] + (1 - group["b2"]) * torch.square(g)
        g_prime = g / float(f(1.0) - m_schedule_new)
        m_t_prime = st["m"] / float(f(1.0) - m_schedule_next)
        v_t_prime = st["v"] / float(f(1.0) - b2 ** t)
        m_t_bar = float(f(1.0) - cache_t) * g_prime + float(cache_t1) * m_t_prime
        p.add_(-group["lr"] * m_t_bar / (torch.sqrt(v_t_prime) + group["eps"]))


def keras_sgd(learning_rate=0.01, momentum=0.0, decay=0.0, nesterov=False):
    return functools.partial(KerasSGD, lr=learning_rate, momentum=momentum, decay=decay,
                             nesterov=nesterov)


def keras_adagrad(learning_rate=0.01, eps=1e-8):
    return functools.partial(KerasAdagrad, lr=learning_rate, eps=eps)


def keras_adadelta(learning_rate=1.0, rho=0.95, eps=1e-8):
    return functools.partial(KerasAdadelta, lr=learning_rate, rho=rho, eps=eps)


def keras_adamax(learning_rate=0.002, b1=0.9, b2=0.999, eps=1e-8):
    return functools.partial(KerasAdamax, lr=learning_rate, b1=b1, b2=b2, eps=eps)


def keras_nadam(learning_rate=0.002, b1=0.9, b2=0.999, eps=1e-8, schedule_decay=0.004):
    return functools.partial(KerasNadam, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                             schedule_decay=schedule_decay)
