"""Batched autoregressive cl_vrnn generation with explicit noise.

Counterpart of the cl_vrnn half of ``classifying_vae_lstm_tpu/sampling/generate.py``.
The sampler is a pure function of its draws: ``eps [B, total, L]`` Gaussian
for z and ``u [B, total, D]`` uniforms for the Bernoulli frames
(``x_t = (u_t < x_mean)``). :func:`draw_generation_noise` makes them with a
``torch.Generator``; the tests make them with NumPy and hand the same arrays
to both packages.

The key latent w is the mean of Logistic-Normal points over seq_length-sized
chunks of the seed's time axis.
"""

from __future__ import annotations

import torch

from ..models import cl_vrnn
from ..nn.distributions import logistic_normal_from_eps, sample_w_discrete_from_u
from ..ops.cuda_generate import generate_cl_vrnn_batch_cuda


def draw_generation_noise(generator: torch.Generator, B: int, total: int, latent_dim: int,
                          D: int, device=None):
    """(eps [B, total, L], u [B, total, D]) for the noise-explicit samplers,
    drawn from ``generator`` on ``device`` (the generator's device by default)."""
    device = generator.device if device is None else device
    eps = torch.randn((B, total, latent_dim), generator=generator, device=device)
    u = torch.rand((B, total, D), generator=generator, device=device)
    return eps, u


def _seed_chunks(cfg, x_seed):
    """[..., T, D] -> [..., n_chunks, seq_length, D] (time-axis chunks)."""
    n_chunks = max(x_seed.shape[-2] // cfg.seq_length, 1)
    x = x_seed[..., : n_chunks * cfg.seq_length, :]
    return x.reshape(x.shape[:-2] + (n_chunks, cfg.seq_length, x.shape[-1]))


def infer_w_cl_vrnn(params, cfg: cl_vrnn.Config, x_seed, generator=None,
                    w_sample: bool = False, w_discrete: bool = False):
    """Key simplex point w from seed roll(s) ``[..., T, D]`` -> ``[..., K]``.

    Without ``w_sample`` each chunk contributes its deterministic mean-logit
    point and ``generator`` is not used; ``w_sample`` adds the Gaussian logit
    noise and ``w_discrete`` makes w a one-hot draw, both from ``generator``.
    """
    lead = tuple(x_seed.shape[:-2])
    n_chunks = max(x_seed.shape[-2] // cfg.seq_length, 1)
    eps = u = None
    if w_sample:
        eps = torch.randn(lead + (n_chunks, cfg.n_classes - 1), generator=generator,
                          device=x_seed.device)
    if w_discrete:
        u = torch.rand(lead, generator=generator, device=x_seed.device)
    return infer_w_cl_vrnn_noise(params, cfg, x_seed, eps, w_sample, w_discrete, u)


def infer_w_cl_vrnn_noise(params, cfg: cl_vrnn.Config, x_seed, eps_w_chunks,
                          w_sample: bool = False, w_discrete: bool = False,
                          u_discrete=None):
    """:func:`infer_w_cl_vrnn` with the draws passed in: ``eps_w_chunks
    [..., n_chunks, K-1]`` Gaussian logit noise, ``u_discrete [...]`` the
    uniform of the one-hot inverse-CDF draw."""
    w_mean, w_log_var = cl_vrnn.encode_w(params, cfg, _seed_chunks(cfg, x_seed))
    ws = logistic_normal_from_eps(w_mean, w_log_var, eps_w_chunks, add_noise=w_sample)
    w = torch.mean(ws, dim=-2)
    if w_discrete:
        w = sample_w_discrete_from_u(u_discrete, w)
    return w


def generate_cl_vrnn_batch_noise(params, cfg: cl_vrnn.Config, x_seeds, nsteps: int,
                                 eps, u, ws, return_probs: bool = False):
    """Batched generation with explicit noise, through the model's step
    functions (the plain reference of the sampler).

    Teacher-forces ``x_seeds [B, Tseed, D]``, then free-runs ``nsteps``
    frames; returns ``[B, nsteps, D]`` (probabilities with ``return_probs``).
    """
    B, Tseed, D = x_seeds.shape
    H = params["encoder_h"]["recurrent_kernel"].shape[0]
    h_e = c_e = h_d = c_d = x_seeds.new_zeros((B, H))
    x_prev = x_seeds.new_zeros((B, D))
    outs = []
    for t in range(Tseed + nsteps):
        x_in = x_seeds[:, t] if t < Tseed else x_prev
        z_mean, z_log_var, h_e, c_e = cl_vrnn.encode_z_step(params, x_in, ws, h_e, c_e)
        z = z_mean + torch.exp(z_log_var / 2) * eps[:, t]
        x_mean, h_d, c_d = cl_vrnn.decode_step(
            params, cfg, z, ws, h_d, c_d, x_prev=x_in if cfg.use_x_prev else None)
        x_prev = (u[:, t] < x_mean).to(x_mean.dtype)
        if t >= Tseed:
            outs.append(x_mean if return_probs else x_prev)
    return torch.stack(outs, dim=1)


def generate_cl_vrnn_batch(params, cfg: cl_vrnn.Config, x_seeds, nsteps: int,
                           generator: torch.Generator, ws):
    """Batched generation: [N, Tseed, D] -> [N, nsteps, D] binary frames.

    Draws the noise from ``generator`` (on the seeds' device), then runs the
    whole-generation sampler: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors.
    """
    B, Tseed, D = x_seeds.shape
    eps, u = draw_generation_noise(generator, B, Tseed + nsteps, cfg.latent_dim, D,
                                   device=x_seeds.device)
    return generate_cl_vrnn_batch_cuda(params, cfg, x_seeds, nsteps, eps, u, ws)
