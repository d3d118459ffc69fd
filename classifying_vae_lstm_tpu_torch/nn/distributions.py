"""Reparameterized samplers and KL terms.

The Logistic-Normal key latent: a (K-1)-dim Gaussian, a zero logit
appended, softmax onto the K-simplex. The ``*_from_eps`` / ``*_from_u``
forms take their draws from the caller (NumPy in the tests, a
``torch.Generator`` in the engine), so both packages can be fed the same
numbers; the ``sample_*`` forms draw from a ``torch.Generator`` themselves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _randn_like(generator: torch.Generator, t):
    return torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype)


def sample_gaussian(generator: torch.Generator, mean, log_var):
    """z = mean + exp(log_var/2) * eps, eps ~ N(0, I)."""
    return mean + torch.exp(log_var / 2) * _randn_like(generator, mean)


def sample_logistic_normal(generator: torch.Generator, mean, log_var, add_noise=True):
    """w on the K-simplex from a logit-Normal with K-1 free logits;
    ``add_noise=False`` gives the mean-logit point."""
    eps = _randn_like(generator, mean) if add_noise else None
    return logistic_normal_from_eps(mean, log_var, eps, add_noise=add_noise)


def logistic_normal_from_eps(mean, log_var, eps, add_noise=True):
    """Point on the K-simplex from ``mean + exp(log_var/2) * eps`` logits."""
    w_norm = mean + torch.exp(log_var / 2) * eps if add_noise else mean
    zeros = torch.zeros(w_norm.shape[:-1] + (1,), dtype=w_norm.dtype, device=w_norm.device)
    return torch.softmax(torch.cat([w_norm, zeros], dim=-1), dim=-1)


def sample_w_discrete_from_u(u, w):
    """One-hot inverse-CDF draw from the categorical ``w`` given uniform ``u``.

    ``searchsorted(cumsum(p), u, side='right')``, clamped to the last class:
    with the same uniform, the same index as ``np.random.choice(len(w), p=p)``.
    ``u`` has the shape of ``w`` without its last axis.
    """
    p = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(p, dim=-1)
    u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device)
    idx = torch.searchsorted(cdf, u[..., None], right=True)[..., 0]
    idx = torch.clamp(idx, max=w.shape[-1] - 1)
    return F.one_hot(idx, w.shape[-1]).to(w.dtype)


def sample_w_discrete(generator: torch.Generator, w):
    """One-hot categorical draw from w (reference cl_vrnn/model.py:65-69)."""
    u = torch.rand(w.shape[:-1], generator=generator, device=w.device, dtype=w.dtype)
    return sample_w_discrete_from_u(u, w)


def gaussian_kl(mean, log_var):
    """KL(N(mean, exp(log_var)) || N(0, I)), summed over the last axis."""
    return -0.5 * torch.sum(1 + log_var - torch.square(mean) - torch.exp(log_var), dim=-1)


def logistic_normal_kl(mean, log_var, log_var_prior=0.0):
    """KL of the logit-Normal posterior against N(0, exp(log_var_prior) I),
    summed over the K-1 logits (the same sum as ``losses.w_kl_loss``)."""
    prior = torch.exp(torch.as_tensor(log_var_prior, dtype=mean.dtype, device=mean.device))
    vs = 1 - log_var_prior + log_var - torch.exp(log_var) / prior - torch.square(mean) / prior
    return -0.5 * torch.sum(vs, dim=-1)
