"""Offline NLL numerics (pure NumPy).

Copy of ``classifying_vae_lstm_tpu/utils/numerics.py``: the reference's
importance-sampling helpers (``utils/model_utils.py:9-17,169-170``).
"""

from __future__ import annotations

import numpy as np


def bincrossentropy(x, xhat):
    """Per-element log-likelihood of binary x under Bernoulli(xhat)."""
    xhat = np.asarray(xhat)
    return x * np.log(np.maximum(1e-15, xhat)) + (1 - x) * np.log(np.maximum(1e-15, 1 - xhat))


def logmeanexp(vs, axis=0):
    m = np.amax(vs, axis=axis)
    return m + np.log(np.mean(np.exp(vs - np.expand_dims(m, axis)), axis=axis))


def logsumexp(vs, axis=0):
    m = np.amax(vs, axis=axis)
    return m + np.log(np.sum(np.exp(vs - np.expand_dims(m, axis)), axis=axis))


def LL_frame(y, yhat):
    """88 * mean BCE: nats per frame (reference utils/model_utils.py:169-170)."""
    y = np.asarray(y)
    yhat = np.clip(np.asarray(yhat), 1e-7, 1 - 1e-7)
    bce = -(y * np.log(yhat) + (1 - y) * np.log(1 - yhat)).mean(axis=-1)
    return 88 * bce
