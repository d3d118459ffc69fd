"""The port's per-song samplers and sampler helpers vs the JAX package's.

``generate_cl_vrnn`` and ``generate_cl_vae`` (one song, a scan that draws
its noise step by step from split keys in JAX): the port's noise-explicit
cores are given the noise the JAX scans draw, rebuilt here from the same
key splits (``normal(kz)`` for z, ``uniform(kx)`` for the Bernoulli frame,
``normal(kw)`` for a sampled w); frames equal exactly, probabilities within
rtol 1e-5 / atol 1e-6 (f32 products in another summation order). The
``torch.Generator`` wrappers equal their cores on the draws they make.
``sampling.samplers``: each helper equals its noise-explicit form on the
same draws, and ``sample_w_discrete`` returns one-hot rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.models import cl_vrnn as jvrnn
from classifying_vae_lstm_tpu.sampling import generate as jgen
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tvrnn
from classifying_vae_lstm_tpu_torch.nn.distributions import (logistic_normal_from_eps,
                                                              sample_w_discrete_from_u)
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.sampling import samplers
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(a):
    return torch.from_numpy(np.array(a))


def _step_noise(key, n, L, D):
    """The per-step draws of the JAX scans: normal(kz) [L], uniform(kx) [D]."""
    eps, u = [], []
    for k in jax.random.split(key, n):
        kz, kx = jax.random.split(k)
        eps.append(jax.random.normal(kz, (1, L))[0])
        u.append(jax.random.uniform(kx, (1, D))[0])
    return _t(jnp.stack(eps)), _t(jnp.stack(u))


def _check(got, want, probs):
    if probs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("probs", [False, True], ids=["frames", "probs"])
@pytest.mark.parametrize("use_x_prev", [True, False], ids=["x_prev", "no_x_prev"])
def test_generate_cl_vrnn_matches_jax(probs, use_x_prev):
    D, H, L, K, T, Tseed, n = 12, 16, 3, 4, 4, 6, 20
    jcfg = jvrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                        n_classes=K, use_x_prev=use_x_prev)
    tcfg = tvrnn.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    raw = jax.tree.map(np.asarray, jvrnn.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    seed = (rng.random((Tseed, D)) < 0.3).astype(np.float32)
    w = np.array([0.1, 0.6, 0.2, 0.1], np.float32)
    key = jax.random.PRNGKey(3)
    want = jgen.generate_cl_vrnn(raw, jcfg, seed, n, key, w, return_probs=probs)
    eps, u = _step_noise(key, Tseed + n, L, D)
    got = tgen.generate_cl_vrnn_noise(params_from_numpy(raw, "cpu"), tcfg, _t(seed), n, eps, u,
                                      _t(w), return_probs=probs)
    assert got.shape == (n, D)
    _check(got, want, probs)


VAE_CASES = {  # w_val given?, w_sample, use_z_prior, hidden width
    "w_val": (True, False, False, 16),
    "infer_w": (False, False, False, 16),
    "sample_w": (False, True, False, 16),
    "z_prior": (True, False, True, 16),
    "no_hidden": (False, False, False, 0),
}


@pytest.mark.parametrize("probs", [False, True], ids=["frames", "probs"])
@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_generate_cl_vae_matches_jax(case, probs):
    has_w, w_sample, z_prior, H = VAE_CASES[case]
    D, L, K, n = 12, 3, 4, 20
    jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L, intermediate_class_dim=10,
                       n_classes=K, use_x_prev=True)
    tcfg = tvae.Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    raw = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(0), jcfg))
    seed = (np.random.default_rng(2).random(D) < 0.3).astype(np.float32)
    w = np.eye(K, dtype=np.float32)[2] if has_w else None
    key = jax.random.PRNGKey(4)
    want = jgen.generate_cl_vae(raw, jcfg, seed, n, key, w_val=None if w is None else w,
                                use_z_prior=z_prior, w_sample=w_sample, return_probs=probs)
    key, kw = jax.random.split(key)
    eps, u = _step_noise(key, n, L, D)
    eps_w = _t(jax.random.normal(kw, (1, K - 1))[0])
    got = tgen.generate_cl_vae_noise(params_from_numpy(raw, "cpu"), tcfg, _t(seed), n, eps, u,
                                     None if w is None else _t(w), eps_w, use_z_prior=z_prior,
                                     w_sample=w_sample, return_probs=probs)
    assert got.shape == (n, D)
    _check(got, want, probs)


def test_generator_wrappers_equal_their_cores():
    vcfg = tvrnn.Config(original_dim=8, intermediate_dim=6, latent_dim=2, seq_length=4,
                        n_classes=3, use_x_prev=True)
    vp = tvrnn.init(torch.Generator().manual_seed(0), vcfg)
    seed = (torch.rand((5, 8), generator=torch.Generator().manual_seed(1)) < 0.3).float()
    w = torch.tensor([0.2, 0.5, 0.3])
    got = tgen.generate_cl_vrnn(vp, vcfg, seed, 7, torch.Generator().manual_seed(2), w)
    g = torch.Generator().manual_seed(2)
    eps = torch.randn((12, 2), generator=g)
    want = tgen.generate_cl_vrnn_noise(vp, vcfg, seed, 7, eps, torch.rand((12, 8), generator=g),
                                       w)
    assert torch.equal(got, want)

    acfg = tvae.Config(original_dim=8, intermediate_dim=6, latent_dim=2,
                       intermediate_class_dim=5, n_classes=3, use_x_prev=True)
    ap = tvae.init(torch.Generator().manual_seed(0), acfg)
    got = tgen.generate_cl_vae(ap, acfg, seed[0], 7, torch.Generator().manual_seed(3),
                               w_sample=True, return_probs=True)
    g = torch.Generator().manual_seed(3)
    eps_w = torch.randn((2,), generator=g)
    eps = torch.randn((7, 2), generator=g)
    want = tgen.generate_cl_vae_noise(ap, acfg, seed[0], 7, eps, torch.rand((7, 8), generator=g),
                                      eps_w=eps_w, w_sample=True, return_probs=True)
    assert torch.equal(got, want)


def test_samplers_equal_their_noise_explicit_forms():
    mean = torch.tensor([[0.3, -1.0], [2.0, 0.5]])
    log_var = torch.tensor([[0.1, -0.4], [0.0, 1.2]])
    p = torch.rand((3, 5), generator=torch.Generator().manual_seed(0))

    def draws(fn, *shapes):
        g = torch.Generator().manual_seed(7)
        return [fn(s, generator=g) for s in shapes]

    (u,) = draws(torch.rand, (3, 5))
    assert torch.equal(samplers.sample_x(torch.Generator().manual_seed(7), p),
                       samplers.sample_x_from_u(u, p))
    (e,) = draws(torch.randn, (2, 2))
    assert torch.equal(samplers.sample_z(torch.Generator().manual_seed(7), (mean, log_var)),
                       mean + torch.exp(log_var / 2) * e)
    assert torch.equal(samplers.sample_w(torch.Generator().manual_seed(7), (mean, log_var)),
                       logistic_normal_from_eps(mean, log_var, e))
    assert torch.equal(samplers.sample_w(None, (mean, log_var), add_noise=False),
                       logistic_normal_from_eps(mean, log_var, None, add_noise=False))
    w = torch.tensor([[0.2, 0.5, 0.3], [0.9, 0.05, 0.05]])
    (uw,) = draws(torch.rand, (2,))
    onehot = samplers.sample_w_discrete(torch.Generator().manual_seed(7), w)
    assert torch.equal(onehot, sample_w_discrete_from_u(uw, w))
    assert torch.equal(onehot.sum(-1), torch.ones(2))
