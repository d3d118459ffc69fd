"""Reference-shaped sampler helpers.

Counterpart of ``classifying_vae_lstm_tpu/sampling/samplers.py``: the
reference's module-level ``sample_x`` / ``sample_w`` / ``sample_z`` /
``sample_w_discrete`` (``cl_vae/model.py:44-74``, ``cl_vrnn/model.py:62-96``),
each drawing from a ``torch.Generator``, over the noise-explicit forms of
:mod:`..nn.distributions` (and :func:`sample_x_from_u` here), which take
their draws from the caller.
"""

from __future__ import annotations

import torch

from ..nn.distributions import logistic_normal_from_eps, sample_gaussian, sample_w_discrete


def sample_x_from_u(u, x_mean):
    """x = (u < x_mean) as float: the Bernoulli draw given uniforms ``u``."""
    return (u < x_mean).to(x_mean.dtype)


def sample_x(generator: torch.Generator, x_mean):
    """x ~ Bernoulli(x_mean), as float (reference cl_vae/model.py:44-45)."""
    u = torch.rand(x_mean.shape, generator=generator, device=x_mean.device,
                   dtype=x_mean.dtype)
    return sample_x_from_u(u, x_mean)


def sample_w(generator: torch.Generator, args, add_noise: bool = True):
    """(w_mean, w_log_var) -> simplex point w (reference cl_vae/model.py:47-66)."""
    w_mean, w_log_var = args
    eps = (torch.randn(w_mean.shape, generator=generator, device=w_mean.device,
                       dtype=w_mean.dtype) if add_noise else None)
    return logistic_normal_from_eps(w_mean, w_log_var, eps, add_noise=add_noise)


def sample_z(generator: torch.Generator, args):
    """(z_mean, z_log_var) -> z (reference cl_vae/model.py:68-74)."""
    z_mean, z_log_var = args
    return sample_gaussian(generator, z_mean, z_log_var)


__all__ = ["sample_w", "sample_w_discrete", "sample_x", "sample_x_from_u", "sample_z"]
