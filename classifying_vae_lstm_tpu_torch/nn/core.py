"""Core layers as plain functions over parameter dicts.

Kernels are ``[in, out]`` and activations ``[batch..., features]``, as in the
JAX package, so ``x @ kernel`` is the whole dense layer. Initializers wait for
the training slice.
"""

from __future__ import annotations

import torch


def dense(params, x, activation=None):
    """y = act(x @ kernel + bias) in float32."""
    y = torch.matmul(x, params["kernel"]) + params["bias"]
    if activation is not None:
        y = activation(y)
    return y


def hard_sigmoid(x):
    """Keras 2.0 default recurrent activation: clip(0.2x + 0.5, 0, 1).

    Not the logistic sigmoid, which is why ``torch.nn.LSTM`` and cuDNN's
    LSTM cannot stand in for this model's cells.
    """
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)
