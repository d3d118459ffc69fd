"""Batched autoregressive generation with explicit noise, both families.

Counterpart of ``classifying_vae_lstm_tpu/sampling/generate.py``. Each
sampler is a pure function of its draws: ``eps`` Gaussian for z and ``u``
uniforms for the Bernoulli frames (``x_t = (u_t < x_mean)``).
:func:`draw_generation_noise` makes them with a ``torch.Generator``; the
tests make them with NumPy and hand the same arrays to both packages.

cl_vrnn: the seed is a window, teacher-forced, and the key latent w is the
mean of Logistic-Normal points over seq_length-sized chunks of its time
axis. cl_vae: the seed is one frame, w is inferred once from it (the
deterministic mean-logit point unless ``w_sample``), and the decoder's
history input lags one step.

The per-song samplers (:func:`generate_cl_vrnn`, :func:`generate_cl_vae`)
are the JAX package's per-song scans: plain PyTorch on whatever device
their inputs are on (no kernel: the JAX scans never reach Pallas), each a
``torch.Generator`` wrapper over a noise-explicit core.

The ``*_batch_dp`` samplers split the songs over a mesh's devices
(:mod:`..parallel`): one process, zero collectives, each shard one call of
the generation kernel on its device. Column-sharded parameters (tensor
parallelism) reach the generation kernels gathered on the seeds' device,
once a call.
"""

from __future__ import annotations

import torch

from ..models import cl_vae, cl_vrnn
from ..nn.distributions import logistic_normal_from_eps, sample_w_discrete_from_u
from ..ops.cuda_generate import generate_cl_vrnn_batch_cuda
from ..ops.cuda_generate_vae import generate_cl_vae_batch_cuda
from ..parallel import gather_tree, replicate


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
    return generate_cl_vrnn_batch_cuda(gather_tree(params, x_seeds.device), cfg, x_seeds,
                                       nsteps, eps, u, ws)


def generate_cl_vae_batch_noise(params, cfg: cl_vae.Config, x_seeds, nsteps: int, eps, u, ws,
                                use_z_prior: bool = False, return_probs: bool = False):
    """Batched cl_vae generation with explicit noise, through the model's
    ``encode_z``/``decode`` (the model-function reference of the sampler).

    ``x_seeds [B, D]``, ``eps [B, nsteps, L]`` Gaussian draws for z (the
    prior sample itself under ``use_z_prior``), ``u [B, nsteps, D]``,
    ``ws [B, K]``; returns ``[B, nsteps, D]`` (probabilities with
    ``return_probs``). The decoder's history input is one step behind.
    """
    if eps.shape[1] != nsteps or u.shape[1] != nsteps:
        raise ValueError(f"noise drawn for {eps.shape[1]}/{u.shape[1]} steps, nsteps={nsteps}")
    x_prev = x_prev_t = x_seeds
    outs = []
    for s in range(nsteps):
        z_mean, z_log_var = cl_vae.encode_z(params, cfg, x_prev, ws)
        z = eps[:, s] if use_z_prior else z_mean + torch.exp(z_log_var / 2) * eps[:, s]
        x_mean = cl_vae.decode(params, cfg, ws, z, x_prev_t if cfg.use_x_prev else None)
        x_t = (u[:, s] < x_mean).to(x_mean.dtype)
        x_prev_t, x_prev = x_prev, x_t
        outs.append(x_mean if return_probs else x_t)
    return torch.stack(outs, dim=1)


def infer_w_cl_vae(params, x_seeds):
    """The deterministic mean-logit key point of seed frames ``[..., D]`` ->
    ``[..., K]``: what the JAX sampler uses when no w is given (its
    ``w_sample=False`` default, and its serving engine's w-inference)."""
    w_mean, w_log_var = cl_vae.encode_w(params, x_seeds)
    return logistic_normal_from_eps(w_mean, w_log_var, None, add_noise=False)


def generate_cl_vae_batch(params, cfg: cl_vae.Config, x_seeds, nsteps: int,
                          generator: torch.Generator, w_vals=None, use_z_prior: bool = False,
                          w_sample: bool = False, return_probs: bool = False):
    """Batched cl_vae generation: [N, D] -> [N, nsteps, D] binary frames.

    ``w_vals [N, K]`` conditions each song (one-hot true keys, or simplex
    points); ``None`` infers w from each seed frame — the mean-logit point,
    or with ``w_sample`` a Logistic-Normal draw whose logit noise comes from
    ``generator``. Then draws eps and u for the ``nsteps`` steps (the seed is
    one frame, so it takes no draws) and runs the whole-generation sampler:
    the CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    """
    B, D = x_seeds.shape
    params = gather_tree(params, x_seeds.device)
    if w_vals is None:
        w_mean, w_log_var = cl_vae.encode_w(params, x_seeds)
        eps_w = (torch.randn(w_mean.shape, generator=generator, device=x_seeds.device)
                 if w_sample else None)
        w_vals = logistic_normal_from_eps(w_mean, w_log_var, eps_w, add_noise=w_sample)
    eps, u = draw_generation_noise(generator, B, nsteps, cfg.latent_dim, D,
                                   device=x_seeds.device)
    return generate_cl_vae_batch_cuda(params, cfg, x_seeds, nsteps, eps, u, w_vals,
                                      use_z_prior=use_z_prior, return_probs=return_probs)


def generate_cl_vrnn_noise(params, cfg: cl_vrnn.Config, x_seed, nsteps: int, eps, u, w,
                           return_probs: bool = False):
    """One song with explicit noise: teacher-force ``x_seed [Tseed, D]``,
    then free-run ``nsteps`` frames; ``eps [Tseed + nsteps, L]`` Gaussian
    draws for z, ``u [Tseed + nsteps, D]`` uniforms for the frames, ``w
    [K]`` a simplex point (one-hot true key, or :func:`infer_w_cl_vrnn`).
    Returns ``[nsteps, D]``, the post-seed frames (probabilities with
    ``return_probs``)."""
    return generate_cl_vrnn_batch_noise(params, cfg, x_seed[None], nsteps, eps[None], u[None],
                                        w[None], return_probs)[0]


def generate_cl_vrnn(params, cfg: cl_vrnn.Config, x_seed, nsteps: int,
                     generator: torch.Generator, w, return_probs: bool = False):
    """:func:`generate_cl_vrnn_noise` with its draws from ``generator`` (on
    the seed's device)."""
    total, D = x_seed.shape[0] + nsteps, x_seed.shape[-1]
    eps = torch.randn((total, cfg.latent_dim), generator=generator, device=x_seed.device)
    u = torch.rand((total, D), generator=generator, device=x_seed.device)
    return generate_cl_vrnn_noise(params, cfg, x_seed, nsteps, eps, u, w, return_probs)


def generate_cl_vae_noise(params, cfg: cl_vae.Config, x_seed, nsteps: int, eps, u,
                          w_val=None, eps_w=None, use_z_prior: bool = False,
                          w_sample: bool = False, return_probs: bool = False):
    """One song from one seed frame ``x_seed [D]`` with explicit noise:
    ``eps [nsteps, L]`` Gaussian draws for z (the prior sample itself under
    ``use_z_prior``), ``u [nsteps, D]`` uniforms for the frames. ``w_val
    [K]`` conditions the song; ``None`` infers w from the seed frame, the
    mean-logit point, or with ``w_sample`` the Logistic-Normal point of the
    logit noise ``eps_w [K-1]``. Returns ``[nsteps, D]``."""
    if w_val is None:
        w_mean, w_log_var = cl_vae.encode_w(params, x_seed[None])
        w = logistic_normal_from_eps(w_mean, w_log_var, eps_w[None] if w_sample else None,
                                     add_noise=w_sample)
    else:
        w = w_val[None]
    return generate_cl_vae_batch_noise(params, cfg, x_seed[None], nsteps, eps[None], u[None], w,
                                       use_z_prior=use_z_prior, return_probs=return_probs)[0]


def generate_cl_vae(params, cfg: cl_vae.Config, x_seed, nsteps: int,
                    generator: torch.Generator, w_val=None, use_z_prior: bool = False,
                    w_sample: bool = False, return_probs: bool = False):
    """:func:`generate_cl_vae_noise` with its draws from ``generator`` (on
    the seed's device)."""
    dev, D = x_seed.device, x_seed.shape[-1]
    eps_w = (torch.randn((cfg.n_classes - 1,), generator=generator, device=dev)
             if w_val is None and w_sample else None)
    eps = torch.randn((nsteps, cfg.latent_dim), generator=generator, device=dev)
    u = torch.rand((nsteps, D), generator=generator, device=dev)
    return generate_cl_vae_noise(params, cfg, x_seed, nsteps, eps, u, w_val, eps_w,
                                 use_z_prior, w_sample, return_probs)


def _dp_shards(x_seeds, mesh, params):
    """(the mesh's data devices, the parameters' replica on each, rows a
    shard); raises unless the songs divide by the data axis."""
    B, n_data = x_seeds.shape[0], mesh.shape["data"]
    if B % n_data != 0:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")
    reps = params if isinstance(params, list) else replicate(params, mesh)
    return mesh.data_devices, reps, B // n_data


def _run_shards(kernel, reps, devices, b, cfg, nsteps: int, x_seeds, eps, u, ws):
    """``kernel(replica, cfg, seeds, nsteps, eps, u, ws)`` on each shard's
    ``b`` rows, moved to its device; the frames gathered on the first
    device."""
    parts = []
    for r, dev in enumerate(devices):
        rows = slice(r * b, (r + 1) * b)
        seeds_r, eps_r, u_r, ws_r = (t[rows].to(dev).contiguous() for t in (x_seeds, eps, u, ws))
        parts.append(kernel(gather_tree(reps[r], dev), cfg, seeds_r, nsteps, eps_r, u_r, ws_r))
    return torch.cat([p.to(devices[0]) for p in parts])


def generate_cl_vrnn_batch_dp(params, cfg: cl_vrnn.Config, x_seeds, nsteps: int,
                              generator: torch.Generator, ws, mesh):
    """Data-parallel batched generation over ``mesh``'s data axis.

    The sampler is independent per song, so the songs split over the
    mesh's devices with zero collectives, in one process: the noise is
    drawn for all B songs from ``generator`` (on the seeds' device), as
    :func:`generate_cl_vrnn_batch` draws it, and split with them; each
    shard runs the generation kernel on its device (its plain version on
    the CPU) with the parameters' replica there (``params`` a tree, copied
    once a device, or the list ``parallel.replicate`` gave); the frames are
    gathered on the mesh's first device. So the output is the single-device
    sampler's for the same generator. ``x_seeds.shape[0]`` must divide by
    the data axis.
    """
    B, Tseed, D = x_seeds.shape
    devices, reps, b = _dp_shards(x_seeds, mesh, params)
    eps, u = draw_generation_noise(generator, B, Tseed + nsteps, cfg.latent_dim, D,
                                   device=x_seeds.device)
    return _run_shards(generate_cl_vrnn_batch_cuda, reps, devices, b, cfg, nsteps,
                       x_seeds, eps, u, ws)


def generate_cl_vae_batch_dp(params, cfg: cl_vae.Config, x_seeds, nsteps: int,
                             generator: torch.Generator, ws, mesh):
    """Data-parallel cl_vae batched generation over ``mesh``'s data axis,
    as :func:`generate_cl_vrnn_batch_dp`: the noise drawn for all B songs
    (as :func:`generate_cl_vae_batch` draws it) and split with them, each
    shard one call of the generation kernel on its device, the frames
    gathered on the first device; exactly the single-device sampler's for
    the same generator. ``ws=None`` infers each seed's deterministic
    mean-logit key point (the sampler's ``w_vals=None``). ``x_seeds.shape[0]``
    must divide by the data axis."""
    B, D = x_seeds.shape
    devices, reps, b = _dp_shards(x_seeds, mesh, params)
    if ws is None:
        ws = infer_w_cl_vae(reps[0], x_seeds.to(devices[0])).to(x_seeds.device)
    eps, u = draw_generation_noise(generator, B, nsteps, cfg.latent_dim, D,
                                   device=x_seeds.device)
    return _run_shards(generate_cl_vae_batch_cuda, reps, devices, b, cfg, nsteps,
                       x_seeds, eps, u, ws)
