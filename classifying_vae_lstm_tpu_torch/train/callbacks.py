"""Host-side training callbacks: annealing, early stopping, save-best.

Copies of the JAX package's ``train/callbacks.py`` (which imports no JAX):
annealing is a function of the epoch index, early stopping and the
checkpoint policy are plain objects the epoch loop consults.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AnnealSchedule:
    """Loss-weight annealing: linear (or sigmoid if ``slope > 0``) ramp from
    ``start_value`` to ``final_value`` over ``n_epochs``; ``final_value``
    throughout when ``n_epochs == 0``."""

    start_value: float = 0.1
    final_value: float = 1.0
    n_epochs: int = 0
    slope: float = 0.0

    def __call__(self, epoch: int) -> float:
        if self.n_epochs <= 0:
            return self.final_value
        if epoch >= self.n_epochs:
            return self.final_value
        x = epoch / self.n_epochs
        frac = 1.0 / (1.0 + np.exp(-self.slope * (x - 0.5))) if self.slope > 0 else x
        return float(self.start_value + frac * (self.final_value - self.start_value))


class EarlyStoppingAfterEpoch:
    """Patience-based early stopping on val_loss, inert until ``min_epoch``."""

    def __init__(self, min_epoch=0, min_delta=0.0, patience=0, mode="min"):
        self.min_epoch = min_epoch
        self.min_delta = abs(min_delta) * (1 if mode == "max" else -1)
        self.patience = patience
        self.better = np.greater if mode == "max" else np.less
        self.best = -np.inf if mode == "max" else np.inf
        self.wait = 0
        self.stopped_epoch = 0

    def should_stop(self, epoch: int, current: float) -> bool:
        if epoch < self.min_epoch:
            return False
        if self.better(current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
            return False
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            return True
        self.wait += 1
        return False


class CheckpointPolicy:
    """Save-best-only on val_loss, inert until ``min_epoch``."""

    def __init__(self, min_epoch=0, mode="min"):
        self.min_epoch = min_epoch
        self.better = np.greater if mode == "max" else np.less
        self.best = -np.inf if mode == "max" else np.inf

    def should_save(self, epoch: int, current: float) -> bool:
        if epoch < self.min_epoch:
            return False
        if self.better(current, self.best):
            self.best = current
            return True
        return False
