"""Core layers and their Keras-2.0 initializers as plain functions.

Kernels are ``[in, out]`` and activations ``[batch..., features]``, as in the
JAX package, so ``x @ kernel`` is the whole dense layer. Initializers draw
from an explicit ``torch.Generator`` on the generator's device; they match
the Keras 2.0 defaults in distribution (the JAX package's draws themselves
cannot be reproduced from a seed).
"""

from __future__ import annotations

import math

import torch

from ..parallel.columns import matmul


def dense(params, x, activation=None, dtype=None):
    """y = act(x @ kernel + bias) in float32.

    ``dtype=torch.bfloat16`` rounds x, the kernel and the bias to bf16 and
    multiplies in f32, as the JAX ``dense(dtype=bf16)`` does with
    ``preferred_element_type=f32`` (a CPU bf16 matmul would round its output
    to bf16). A column-sharded kernel (``parallel.columns.ColumnShards``)
    multiplies slice by slice on its devices, the outputs gathered on x's
    device before the bias and the activation (column parallelism)."""
    kernel, bias = params["kernel"], params["bias"]
    if dtype is not None:
        op = lambda a: a.to(dtype).to(torch.float32)
        x, kernel, bias = op(x), op(kernel), op(bias)
    y = matmul(x, kernel) + bias
    if activation is not None:
        y = activation(y)
    return y


def hard_sigmoid(x):
    """Keras 2.0 default recurrent activation: clip(0.2x + 0.5, 0, 1).

    Not the logistic sigmoid, which is why ``torch.nn.LSTM`` and cuDNN's
    LSTM cannot stand in for this model's cells.
    """
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def glorot_uniform(generator: torch.Generator, shape, dtype=torch.float32):
    """Keras 2.0 default kernel initializer: U(-l, l), l = sqrt(6/(fan_in+fan_out))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)
    return (2.0 * u - 1.0) * limit


def orthogonal(generator: torch.Generator, shape, dtype=torch.float32):
    """Keras 2.0 recurrent initializer: orthogonal via QR of a standard normal.

    The QR runs in float64 (init time only; a float32 QR loses orthogonality
    at the 1e-3 level) on the generator's device: the matrix is 4H square, and
    at H=2,048 a host's LAPACK takes tens of seconds over it. Column signs
    follow ``diag(r)``.
    """
    n_rows, n_cols = shape
    big = max(n_rows, n_cols)
    a = torch.randn((big, big), generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a.double())
    q = q * torch.sign(torch.diagonal(r))
    return q[:n_rows, :n_cols].to(dtype)


def random_normal_init(stddev=0.1):
    """The explicit RandomNormal(0, stddev) head initializer of the cl_vrnn model."""

    def init(generator: torch.Generator, shape, dtype=torch.float32):
        return stddev * torch.randn(shape, generator=generator, device=generator.device,
                                    dtype=dtype)

    return init


def init_dense(generator: torch.Generator, in_dim, out_dim, kernel_init=glorot_uniform):
    return {
        "kernel": kernel_init(generator, (in_dim, out_dim)),
        "bias": torch.zeros((out_dim,), device=generator.device),
    }


def init_lstm(generator: torch.Generator, in_dim, hidden_dim, unit_forget_bias=True):
    """LSTM parameters in Keras layout: fused kernels [in, 4H] / [H, 4H].

    Gate order (i, f, c, o); the forget-gate bias starts at 1 (Keras
    ``unit_forget_bias``).
    """
    bias = torch.zeros((4 * hidden_dim,), device=generator.device)
    if unit_forget_bias:
        bias[hidden_dim : 2 * hidden_dim] = 1.0
    return {
        "kernel": glorot_uniform(generator, (in_dim, 4 * hidden_dim)),
        "recurrent_kernel": orthogonal(generator, (hidden_dim, 4 * hidden_dim)),
        "bias": bias,
    }
