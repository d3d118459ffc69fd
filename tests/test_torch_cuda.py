"""The whole-generation CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel has no CPU mode)
and skip without one. They cover what ``chip_smoke.py`` does not: ragged
song tiles (B not a multiple of the block's tile), no ``use_x_prev``, a
hidden width that takes two passes of the gate stages, a one-frame seed,
and the input checks on CUDA tensors. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which a machine
for the port need not have). Tolerances: f32 probabilities within 1e-5
(same f32 products, other summation order) and frames exactly equal at
these fixed seeds; bf16 probabilities with u=1 within 2e-3 (bf16 rounding
at the same places, other summation order).
"""

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu_torch.models import cl_vrnn
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _problem(dev, B, Tseed, nsteps, H, use_x_prev=True, D=12, L=3, K=3, seed=0,
             bf16=False):
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=4,
                         n_classes=K, use_x_prev=use_x_prev, bf16_compute=bf16)
    rng = np.random.default_rng(seed)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    n_xp = D if use_x_prev else 0
    raw = {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": rng.normal(0, 0.1, 4 * H).astype(np.float32)},
        "decoder_h": {"kernel": glorot(n_xp + L + K, 4 * H),
                      "recurrent_kernel": glorot(H, 4 * H),
                      "bias": rng.normal(0, 0.1, 4 * H).astype(np.float32)},
        "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.full(D, -1.0, np.float32)},
    }
    total = Tseed + nsteps
    T = lambda a: torch.from_numpy(a).to(dev)
    arrays = (T((rng.random((B, Tseed, D)) < 0.3).astype(np.float32)), nsteps,
              T(rng.standard_normal((B, total, L)).astype(np.float32)),
              T(rng.random((B, total, D)).astype(np.float32)),
              T(np.eye(K, dtype=np.float32)[np.arange(B) % K]))
    return params_from_numpy(raw, dev), cfg, arrays


CASES = {
    "one_song": dict(B=1, Tseed=3, nsteps=20, H=40),
    "ragged_no_x_prev": dict(B=5, Tseed=4, nsteps=16, H=40, use_x_prev=False),
    "two_unit_passes": dict(B=20, Tseed=1, nsteps=12, H=300, seed=1),
    "full_tiles": dict(B=16, Tseed=6, nsteps=10, H=64, seed=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_f32(dev, case):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, **CASES[case])
    u1 = torch.ones_like(u)
    before = cg.LAUNCHES
    pk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True)
    fk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    pp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u1, ws,
                                         return_probs=True)
    fp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u, ws)
    assert pk.shape == fk.shape == (seeds.shape[0], nsteps, cfg.original_dim)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-5)
    assert 0 < fk.mean().item() < 1
    torch.testing.assert_close(fk, fp, rtol=0, atol=0)


def test_kernel_matches_plain_bf16(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, B=6, Tseed=5, nsteps=16, H=64,
                                                        seed=3, bf16=True)
    u1 = torch.ones_like(u)
    pk = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True)
    pp = cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, u1, ws,
                                         return_probs=True)
    torch.testing.assert_close(pk, pp, rtol=0, atol=2e-3)
    # bf16 really ran: the f32 kernel gives other probabilities
    pf = cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u1, ws,
                                        return_probs=True, mode="f32")
    assert (pk - pf).abs().max().item() > 1e-6


def test_wrapper_raises_instead_of_falling_back(dev):
    params, cfg, (seeds, nsteps, eps, u, ws) = _problem(dev, B=4, Tseed=2, nsteps=4, H=16)
    before = cg.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps.cpu(), u, ws)
    with pytest.raises(ValueError, match="contiguous"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u.transpose(0, 1)
                                       .contiguous().transpose(0, 1), ws)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws, mode="int8")
    assert cg.LAUNCHES == before
