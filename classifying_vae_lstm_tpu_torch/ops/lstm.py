"""The Keras-2.0 LSTM cell as plain tensor code.

Gate order (i, f, c, o), ``tanh`` activation, hard-sigmoid recurrent
activation. This is the plain twin of the cells inside the CUDA kernels; the
sequence form waits for the training slice.
"""

from __future__ import annotations

import torch

from ..nn.core import hard_sigmoid


def _gates(z, c_prev, hidden_dim, recurrent_activation=hard_sigmoid, activation=torch.tanh):
    H = hidden_dim
    i = recurrent_activation(z[..., :H])
    f = recurrent_activation(z[..., H : 2 * H])
    g = activation(z[..., 2 * H : 3 * H])
    o = recurrent_activation(z[..., 3 * H :])
    c = f * c_prev + i * g
    return o * activation(c), c


def lstm_step(params, x, h_prev, c_prev, recurrent_activation=hard_sigmoid,
              activation=torch.tanh):
    """One LSTM cell step: x [B, in], h/c [B, H] -> (h, c)."""
    z = (torch.matmul(x, params["kernel"])
         + torch.matmul(h_prev, params["recurrent_kernel"])
         + params["bias"])
    return _gates(z, c_prev, h_prev.shape[-1], recurrent_activation, activation)
