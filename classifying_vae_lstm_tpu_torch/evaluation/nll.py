"""Importance-sampled test NLL (IWAE-style bound), nats per frame.

Counterpart of ``classifying_vae_lstm_tpu/evaluation/nll.py`` for the
cl_vrnn family. Estimator, per datapoint:

    log p(x) >= logmeanexp_s [ log p(x | z_s, w_s) + log p(z_s) + log p(u_s)
                               - log q(z_s | x, w_s) - log q(u_s | x) ]

where u is the (K-1)-dim logit-space Gaussian behind the Logistic-Normal w
(prior N(0, e^{w_log_var_prior} I)) and p(z) is N(0, I). Reported as the
negative log-likelihood per frame (divided by seq_length).

Where the JAX package ``vmap``s the S importance samples, the port writes
them out as S·B rows: the key head runs once per window, then each LSTM runs
once over all S·B rows (on the card, one launch of the whole-sequence
inference kernel per LSTM when the backend is ``pallas``). Noise comes from
a ``torch.Generator`` (:func:`iw_nll_cl_vrnn`) or is given explicitly
(:func:`iw_nll_cl_vrnn_noise`), for parity with the JAX package's draws.
"""

from __future__ import annotations

import math

import torch

from ..models import cl_vrnn

_LOG2PI = math.log(2 * math.pi)
CL_VAE_TODO = ("iw_nll_cl_vae is not ported yet: it comes with the cl_vae training slice "
               "(ROADMAP Queue 1 item 11)")
DP_TODO = "data-parallel evaluation is not ported yet (ROADMAP Queue 1 item 14)"


def _log_normal(x, mean, log_var):
    """Sum of independent Gaussian log-densities over the last axis."""
    return -0.5 * torch.sum(_LOG2PI + log_var + (x - mean) ** 2 / torch.exp(log_var), dim=-1)


def _log_bernoulli(x, p):
    p = torch.clamp(p, 1e-7, 1 - 1e-7)
    return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p), dim=-1)


def iw_nll_cl_vrnn_noise(params, cfg: cl_vrnn.Config, x, y, eps_u, eps_z, x_prev=None):
    """IW test NLL for a cl_vrnn batch with explicit noise: x, y (and x_prev)
    ``[B, T, D]``, eps_u ``[S, B, K-1]``, eps_z ``[S, B, T, L]``; returns
    ``[B]`` nats per frame."""
    S, B = eps_u.shape[:2]
    T, L = x.shape[1], cfg.latent_dim
    rows = lambda a: a.unsqueeze(0).expand(S, *a.shape).reshape(S * B, *a.shape[1:])
    w_mean, w_log_var = cl_vrnn.encode_w(params, cfg, x)  # once per window
    u = w_mean + torch.exp(w_log_var / 2) * eps_u         # [S, B, K-1]
    zeros = u.new_zeros(u.shape[:-1] + (1,))
    w = torch.softmax(torch.cat([u, zeros], dim=-1), dim=-1).reshape(S * B, -1)
    z_mean, z_log_var, _ = cl_vrnn.encode_z_sequence(params, cfg, rows(x), w)
    z = z_mean + torch.exp(z_log_var / 2) * eps_z.reshape(S * B, T, L)
    x_hat, _ = cl_vrnn.decode_sequence(params, cfg, z, w,
                                       rows(x_prev) if x_prev is not None else None)
    zero_z = torch.zeros_like(z)
    log_w_z = (torch.sum(_log_bernoulli(rows(y), x_hat), dim=-1)
               + torch.sum(_log_normal(z, zero_z, zero_z), dim=-1))
    log_w_u = _log_normal(u, torch.zeros_like(u), torch.full_like(u, cfg.w_log_var_prior))
    log_w = (log_w_z.reshape(S, B) + log_w_u
             - torch.sum(_log_normal(z, z_mean, z_log_var), dim=-1).reshape(S, B)
             - _log_normal(u, w_mean, w_log_var))
    m = torch.max(log_w, dim=0).values
    ll = m + torch.log(torch.mean(torch.exp(log_w - m[None, :]), dim=0))
    return -ll / cfg.seq_length


def iw_nll_cl_vrnn(params, cfg: cl_vrnn.Config, x, y, generator: torch.Generator,
                   n_samples: int = 64, x_prev=None):
    """IW test NLL for a cl_vrnn batch, noise drawn from ``generator`` (eps_u
    ``[S, B, K-1]``, then eps_z ``[S, B, T, L]``); returns ``[B]``
    nats/frame."""
    B, T = x.shape[:2]
    dev = generator.device
    eps_u = torch.randn((n_samples, B, cfg.n_classes - 1), generator=generator, device=dev)
    eps_z = torch.randn((n_samples, B, T, cfg.latent_dim), generator=generator, device=dev)
    return iw_nll_cl_vrnn_noise(params, cfg, x, y, eps_u, eps_z, x_prev)


def iw_nll_cl_vae(*args, **kwargs):
    raise NotImplementedError(CL_VAE_TODO)


def iw_nll_dataset(params, cfg, data: dict, generator: torch.Generator, n_samples: int,
                   batch_size: int, family: str = "cl_vae"):
    """Whole-test-set NLL, batch by batch under ``torch.no_grad()``.

    ``data`` holds ``x``/``y`` (and optionally ``x_prev``) tensors [N, ...].
    The final partial batch is padded with wrap-around indices and the pad
    rows dropped afterwards, so the returned [N] per-example NLLs cover the
    whole split."""
    if family != "cl_vrnn":
        raise NotImplementedError(CL_VAE_TODO)
    n = data["x"].shape[0]
    nb = -(-n // batch_size)  # ceil: last batch padded, not dropped
    idx = torch.arange(nb * batch_size, device=data["x"].device) % n
    nlls = []
    with torch.no_grad():
        for i in range(nb):
            batch = {k: v.index_select(0, idx[i * batch_size:(i + 1) * batch_size])
                     for k, v in data.items()}
            nlls.append(iw_nll_cl_vrnn(params, cfg, batch["x"], batch["y"], generator,
                                       n_samples, batch.get("x_prev")))
    return torch.cat(nlls)[:n]


def iw_nll_dataset_dp(*args, **kwargs):
    raise NotImplementedError(DP_TODO)
