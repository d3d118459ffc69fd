"""Reparameterized samplers with the random draws passed in.

The Logistic-Normal key latent: a (K-1)-dim Gaussian, a zero logit
appended, softmax onto the K-simplex. The draws come from the caller (NumPy
in the tests, a ``torch.Generator`` in the engine), so both packages can be
fed the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
