"""Port's whole-generation sampler (plain version of the CUDA kernel) vs the
JAX package: the Pallas kernel in interpret mode and the noise-explicit scan.

Both sides get the same weights (the JAX init, as NumPy arrays) and the same
noise from ``np.random.default_rng``. f32: frames exactly equal (fixed seeds,
so the test is deterministic) and probabilities within rtol 1e-5, atol 1e-6 —
both sides compute the same f32 products and only the summation order
differs. bf16: probabilities with u=1, which pins every fed-back frame to 0 so
that the feedback cannot amplify a difference, within atol 2e-3 — bf16
rounding happens at the same places (weights, x and h operands) and only the
summation order differs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.ops import pallas_generate
from classifying_vae_lstm_tpu.sampling.generate import generate_cl_vrnn_batch_noise as jax_noise
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import cuda_generate
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy


def _setup(use_x_prev=True, B=8, Tseed=6, nsteps=10, H=16, D=12, L=2, K=3, seed=0):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=4,
                      n_classes=K, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    total = Tseed + nsteps
    arrays = {
        "seeds": (rng.random((B, Tseed, D)) < 0.3).astype(np.float32),
        "ws": np.eye(K, dtype=np.float32)[np.arange(B) % K],
        "eps": rng.standard_normal((B, total, L)).astype(np.float32),
        "u": rng.random((B, total, D)).astype(np.float32),
    }
    tcfg = tcl.Config(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, params_from_numpy(params, "cpu"), arrays, nsteps


def _t(a):
    return torch.from_numpy(a)


def _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp, pallas=True, mode=None, u=None):
    u = a["u"] if u is None else u
    args = (a["seeds"], nsteps, a["eps"], u, a["ws"])
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(u), _t(a["ws"]))
    out = {
        "jax_noise": np.asarray(jax_noise(params, jcfg, *args, return_probs=rp)),
        "plain": cuda_generate.generate_cl_vrnn_batch_plain(
            tparams, tcfg, *targs, return_probs=rp, mode=mode).numpy(),
        "port_noise": tgen.generate_cl_vrnn_batch_noise(
            tparams, tcfg, *targs, return_probs=rp).numpy(),
    }
    if pallas:
        out["jax_pallas"] = np.asarray(pallas_generate.generate_cl_vrnn_batch_pallas(
            params, jcfg, *args, return_probs=rp, mode=mode))
    return out


CASES = {
    "x_prev": dict(use_x_prev=True),
    "no_x_prev": dict(use_x_prev=False),
    "padded_batch": dict(B=20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_and_scan(case):
    jcfg, params, tcfg, tparams, a, nsteps = _setup(**CASES[case])
    frames = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=False)
    assert frames["plain"].shape == (a["seeds"].shape[0], nsteps, a["seeds"].shape[2])
    for name in ("jax_pallas", "jax_noise", "port_noise"):
        np.testing.assert_array_equal(frames["plain"], frames[name], err_msg=name)
    probs = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True)
    for name in ("jax_pallas", "jax_noise", "port_noise"):
        np.testing.assert_allclose(probs["plain"], probs[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("Tseed,nsteps", [(1, 12), (13, 3), (6, 1)])
def test_seed_boundary_inside_the_run(Tseed, nsteps):
    """The teacher-forced/free-running boundary anywhere in the run: the
    first free step reads the sample drawn at the last seed step."""
    jcfg, params, tcfg, tparams, a, nsteps = _setup(Tseed=Tseed, nsteps=nsteps, seed=3)
    frames = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=False, pallas=False)
    np.testing.assert_array_equal(frames["plain"], frames["jax_noise"])
    np.testing.assert_array_equal(frames["port_noise"], frames["jax_noise"])
    probs = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True, pallas=False)
    np.testing.assert_allclose(probs["plain"], probs["jax_noise"], rtol=1e-5, atol=1e-6)


def test_bf16_mode_matches_jax_pallas_bf16():
    jcfg, params, tcfg, tparams, a, nsteps = _setup(B=8, Tseed=6, nsteps=12, H=32, seed=1)
    u1 = np.ones_like(a["u"])
    probs = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True, mode="bf16", u=u1)
    np.testing.assert_allclose(probs["plain"], probs["jax_pallas"], rtol=0, atol=2e-3)
    # bf16 really ran: the f32 sampler gives other probabilities
    assert np.abs(probs["plain"] - probs["jax_noise"]).max() > 1e-6


def test_wrapper_takes_plain_version_for_cpu_tensors():
    jcfg, params, tcfg, tparams, a, nsteps = _setup()
    before = cuda_generate.LAUNCHES
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(a["u"]), _t(a["ws"]))
    got = cuda_generate.generate_cl_vrnn_batch_cuda(tparams, tcfg, *targs, return_probs=True)
    ref = cuda_generate.generate_cl_vrnn_batch_plain(tparams, tcfg, *targs, return_probs=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cuda_generate.LAUNCHES == before  # no kernel launch on the CPU
    # the engine's entry point draws noise from a generator, same function
    g = torch.Generator().manual_seed(0)
    out = tgen.generate_cl_vrnn_batch(tparams, tcfg, _t(a["seeds"]), nsteps, g, _t(a["ws"]))
    assert out.shape == (8, nsteps, 12)
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}


def test_modes_and_kernel_input_checks():
    jcfg, params, tcfg, tparams, a, nsteps = _setup()
    assert cuda_generate.pick_mode(tcfg) == "f32"
    assert cuda_generate.pick_mode(dataclasses.replace(tcfg, bf16_compute=True)) == "bf16"
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(a["u"]), _t(a["ws"]))
    # int8 on CPU tensors: the plain int8 version, 0/1 frames other than bf16's
    before = cuda_generate.INT8_LAUNCHES
    f8 = cuda_generate.generate_cl_vrnn_batch_cuda(tparams, tcfg, *targs, mode="int8")
    f16 = cuda_generate.generate_cl_vrnn_batch_cuda(tparams, tcfg, *targs, mode="bf16")
    assert cuda_generate.INT8_LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(
        f8, cuda_generate.generate_cl_vrnn_batch_plain(tparams, tcfg, *targs, mode="int8"),
        rtol=0, atol=0)
    assert set(torch.unique(f8).tolist()) <= {0.0, 1.0}
    assert not torch.equal(f8, f16)
    with pytest.raises(ValueError, match="unknown mode"):
        cuda_generate.generate_cl_vrnn_batch_cuda(tparams, tcfg, *targs, mode="int4")
    # what the wrapper checks before a launch (the launch itself needs a card)
    cuda_generate._check(tparams, tcfg, *targs)
    with pytest.raises(ValueError, match="eps"):
        cuda_generate._check(tparams, tcfg, targs[0], nsteps, targs[2][:, :-1], *targs[3:])
    with pytest.raises(ValueError, match="float32"):
        cuda_generate._check(tparams, tcfg, targs[0], nsteps, targs[2].double(), *targs[3:])
    with pytest.raises(ValueError, match="contiguous"):
        u_t = _t(np.ascontiguousarray(a["u"].transpose(1, 0, 2))).transpose(0, 1)
        cuda_generate._check(tparams, tcfg, targs[0], nsteps, targs[2], u_t, targs[4])
    assert cuda_generate.fits(tcl.Config(intermediate_dim=2048))
    assert cuda_generate.fits(tcl.Config(intermediate_dim=4096))
    assert not cuda_generate.fits(tcl.Config(intermediate_dim=100_000))
