"""Optimizer-name resolution, as the JAX package's ``optim/factory.py``.

``'adam-wn'`` is AdamWithWeightnorm (lr 0.001, Keras Adam betas, epsilon
1e-8, no decay); ``'sgd-wn'`` SGDWithWeightnorm; every other name is one of
the Keras 2.0.0 ``optimizers.get`` names (sgd, rmsprop, adagrad, adadelta,
adam, adamax, nadam) with Keras defaults, and an unknown name raises
``ValueError`` where Keras would.
"""

from __future__ import annotations

from typing import Callable

from .adamwn import adam_with_weightnorm, keras_adam, keras_rmsprop, sgd_with_weightnorm
from .keras_optimizers import keras_adadelta, keras_adagrad, keras_adamax, keras_nadam, keras_sgd

_KERAS_NAMES = {
    "sgd": keras_sgd,
    "rmsprop": keras_rmsprop,
    "adagrad": keras_adagrad,
    "adadelta": keras_adadelta,
    "adam": keras_adam,
    "adamax": keras_adamax,
    "nadam": keras_nadam,
}


def init_optimizer(name: str) -> tuple[Callable, bool]:
    """Resolve an optimizer name; returns (constructor taking the
    parameters, was_adam_wn)."""
    if name == "adam-wn":
        return adam_with_weightnorm(learning_rate=0.001, b1=0.9, b2=0.999, eps=1e-8,
                                    decay=0.0), True
    if name == "sgd-wn":
        return sgd_with_weightnorm(), False
    fn = _KERAS_NAMES.get(name.lower())
    if fn is None:
        raise ValueError(f"Could not interpret optimizer identifier: {name!r}")
    return fn(), False
