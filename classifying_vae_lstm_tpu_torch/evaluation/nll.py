"""Importance-sampled test NLL (IWAE-style bound), nats per frame.

Counterpart of ``classifying_vae_lstm_tpu/evaluation/nll.py``, both
families. Estimator, per datapoint:

    log p(x) >= logmeanexp_s [ log p(x | z_s, w_s) + log p(z_s) + log p(u_s)
                               - log q(z_s | x, w_s) - log q(u_s | x) ]

where u is the (K-1)-dim logit-space Gaussian behind the Logistic-Normal w
(prior N(0, e^{w_log_var_prior} I)) and p(z) is N(0, I). Reported as the
negative log-likelihood per frame (cl_vrnn divides by seq_length; a cl_vae
datapoint is one frame).

Where the JAX package ``vmap``s the S importance samples, the port writes
them out as S·B rows: the key head runs once per window, then the rest of
the model once over all S·B rows (for cl_vrnn on the card, one launch of the
whole-sequence inference kernel per LSTM when the backend is ``pallas``; the
cl_vae estimator, like the JAX one, runs the plain dense layers). Noise
comes from a ``torch.Generator`` (:func:`iw_nll_cl_vrnn`,
:func:`iw_nll_cl_vae`) or is given explicitly (the ``*_noise`` forms), for
parity with the JAX package's draws. :func:`iw_nll_dataset_dp` splits each
batch over a mesh's devices.
"""

from __future__ import annotations

import math

import torch

from ..models import cl_vae, cl_vrnn
from ..parallel import make_mesh, replicate

_LOG2PI = math.log(2 * math.pi)


def _log_normal(x, mean, log_var):
    """Sum of independent Gaussian log-densities over the last axis."""
    return -0.5 * torch.sum(_LOG2PI + log_var + (x - mean) ** 2 / torch.exp(log_var), dim=-1)


def _log_bernoulli(x, p):
    p = torch.clamp(p, 1e-7, 1 - 1e-7)
    return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p), dim=-1)


def _logmeanexp_neg(log_w):
    """-log mean_s exp(log_w[s]) over the leading sample axis."""
    m = torch.max(log_w, dim=0).values
    return -(m + torch.log(torch.mean(torch.exp(log_w - m[None, :]), dim=0)))


def _draw_batch_noise(cfg, family: str, x, generator, n_samples: int):
    """A batch's (eps_u, eps_z), drawn as :func:`iw_nll_cl_vrnn` /
    :func:`iw_nll_cl_vae` draw them."""
    B, dev = x.shape[0], generator.device
    eps_u = torch.randn((n_samples, B, cfg.n_classes - 1), generator=generator, device=dev)
    z_shape = (n_samples, B) + ((x.shape[1],) if family != "cl_vae" else ()) + (cfg.latent_dim,)
    return eps_u, torch.randn(z_shape, generator=generator, device=dev)


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
    return _logmeanexp_neg(log_w) / cfg.seq_length


def iw_nll_cl_vrnn(params, cfg: cl_vrnn.Config, x, y, generator: torch.Generator,
                   n_samples: int = 64, x_prev=None):
    """IW test NLL for a cl_vrnn batch, noise drawn from ``generator`` (eps_u
    ``[S, B, K-1]``, then eps_z ``[S, B, T, L]``); returns ``[B]``
    nats/frame."""
    eps_u, eps_z = _draw_batch_noise(cfg, "cl_vrnn", x, generator, n_samples)
    return iw_nll_cl_vrnn_noise(params, cfg, x, y, eps_u, eps_z, x_prev)


def iw_nll_cl_vae_noise(params, cfg: cl_vae.Config, x, y, eps_u, eps_z, x_prev=None):
    """IW test NLL for a cl_vae batch with explicit noise: x, y (and x_prev)
    ``[B, D]``, eps_u ``[S, B, K-1]``, eps_z ``[S, B, L]``; returns ``[B]``
    nats per frame."""
    S, B = eps_u.shape[:2]
    rows = lambda a: a.unsqueeze(0).expand(S, *a.shape).reshape(S * B, *a.shape[1:])
    w_mean, w_log_var = cl_vae.encode_w(params, x)   # once per datapoint
    u = w_mean + torch.exp(w_log_var / 2) * eps_u    # [S, B, K-1]
    zeros = u.new_zeros(u.shape[:-1] + (1,))
    w = torch.softmax(torch.cat([u, zeros], dim=-1), dim=-1).reshape(S * B, -1)
    z_mean, z_log_var = cl_vae.encode_z(params, cfg, rows(x), w)
    z = z_mean + torch.exp(z_log_var / 2) * eps_z.reshape(S * B, -1)
    x_hat = cl_vae.decode(params, cfg, w, z, rows(x_prev) if x_prev is not None else None)
    log_w_z = (_log_bernoulli(rows(y), x_hat) + _log_normal(z, torch.zeros_like(z),
                                                             torch.zeros_like(z))
               - _log_normal(z, z_mean, z_log_var))
    log_w_u = (_log_normal(u, torch.zeros_like(u), torch.full_like(u, cfg.w_log_var_prior))
               - _log_normal(u, w_mean, w_log_var))
    return _logmeanexp_neg(log_w_z.reshape(S, B) + log_w_u)


def iw_nll_cl_vae(params, cfg: cl_vae.Config, x, y, generator: torch.Generator,
                  n_samples: int = 64, x_prev=None):
    """IW test NLL for a cl_vae batch, noise drawn from ``generator`` (eps_u
    ``[S, B, K-1]``, then eps_z ``[S, B, L]``); returns ``[B]`` nats/frame."""
    eps_u, eps_z = _draw_batch_noise(cfg, "cl_vae", x, generator, n_samples)
    return iw_nll_cl_vae_noise(params, cfg, x, y, eps_u, eps_z, x_prev)


def iw_nll_dataset(params, cfg, data: dict, generator: torch.Generator, n_samples: int,
                   batch_size: int, family: str = "cl_vae"):
    """Whole-test-set NLL, batch by batch under ``torch.no_grad()``.

    ``data`` holds ``x``/``y`` (and optionally ``x_prev``) tensors [N, ...].
    The final partial batch is padded with wrap-around indices and the pad
    rows dropped afterwards, so the returned [N] per-example NLLs cover the
    whole split. :func:`iw_nll_dataset_dp` on a one-device mesh (the data's
    device, ``params`` where they lie)."""
    return iw_nll_dataset_dp([params], cfg, data, generator, n_samples, batch_size, family,
                             make_mesh(1, devices=[data["x"].device]))


def iw_nll_dataset_dp(params, cfg, data: dict, generator: torch.Generator, n_samples: int,
                      batch_size: int, family: str = "cl_vae", mesh=None):
    """:func:`iw_nll_dataset` with each batch split over ``mesh``'s data
    axis, in one process and with zero collectives (the estimator is
    independent per window): the batch's noise is drawn globally from
    ``generator``, as the single-device call draws it, then every shard's
    windows and noise go to its device, which runs the estimator on them
    (``params`` replicated once a device, or already a list of the
    replicas ``parallel.replicate`` gives), and the per-window NLLs are
    gathered on the mesh's first device and trimmed to N. The same
    numbers as :func:`iw_nll_dataset` for the same generator.

    ``batch_size`` must divide by the data axis. Each shard keeps the
    checkpoint's route: a cl_vrnn with ``lstm_backend == "pallas"`` runs the
    whole-sequence inference kernel on every card (the JAX package forces
    ``xla`` under ``--dp`` only because XLA cannot partition its Pallas
    call)."""
    n_data = mesh.shape["data"]
    if batch_size % n_data != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {n_data}")
    noise_fn = iw_nll_cl_vae_noise if family == "cl_vae" else iw_nll_cl_vrnn_noise
    devices = mesh.data_devices
    reps = params if isinstance(params, list) else replicate(params, mesh)
    n, b = data["x"].shape[0], batch_size // n_data
    nb = -(-n // batch_size)  # ceil: last batch padded, not dropped
    idx = torch.arange(nb * batch_size, device=data["x"].device) % n
    nlls = []
    with torch.no_grad():
        for i in range(nb):
            batch = {k: v.index_select(0, idx[i * batch_size:(i + 1) * batch_size])
                     for k, v in data.items()}
            eps_u, eps_z = _draw_batch_noise(cfg, family, batch["x"], generator, n_samples)
            parts = []
            for r, dev in enumerate(devices):
                rows = slice(r * b, (r + 1) * b)
                shard = {k: v[rows].to(dev) for k, v in batch.items()}
                parts.append(noise_fn(reps[r], cfg, shard["x"], shard["y"],
                                      eps_u[:, rows].to(dev), eps_z[:, rows].to(dev),
                                      shard.get("x_prev")))
            nlls.append(torch.cat([p.to(devices[0]) for p in parts]))
    return torch.cat(nlls)[:n]
