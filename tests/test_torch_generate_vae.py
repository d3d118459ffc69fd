"""The port's cl_vae whole-generation sampler (the plain version of its CUDA
kernels, and the model-function reference) against the JAX package: the
Pallas kernel in interpret mode and the noise-explicit scan. The cases cover
the shared-memory kernel's widths, the wide kernel's (hidden 256 and 512 at
D=88, where f32 weights overflow one block's shared memory) and configs
without hidden layers, which the JAX kernel refuses and its scan samples.

Both sides get the same weights (the JAX init or a trained checkpoint, as
NumPy arrays) and the same noise from ``np.random.default_rng``. f32: frames
exactly equal (fixed seeds, so the test is deterministic; no |u - p| of
these runs comes near the 1e-6 where another summation order could flip a
frame) and probabilities within 1e-5 — both sides compute the same f32
products and only the summation order differs. bf16: probabilities within
max 2e-2 / mean 2e-3 of the JAX bf16 kernel (bf16 rounding at the same
places, another summation order) and within the JAX test's own bounds of
its f32 kernel (max 0.06, mean 0.01).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.nn.distributions import logistic_normal_from_eps as j_ln
from classifying_vae_lstm_tpu.ops import pallas_generate_vae
from classifying_vae_lstm_tpu.sampling.generate import generate_cl_vae_batch_noise as jax_noise
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy


def _setup(use_x_prev=True, B=8, nsteps=10, H=16, D=12, L=2, K=3, seed=0, ckpt=None):
    if ckpt:
        params, jcfg, _ = jcommon.load_model(f"artifacts/{ckpt}.npz", "cl_vae")
        params = jax.tree.map(np.asarray, params)
        D, K, L = jcfg.original_dim, jcfg.n_classes, jcfg.latent_dim
    else:
        jcfg = jvae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                           intermediate_class_dim=H, n_classes=K, use_x_prev=use_x_prev)
        params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    arrays = {
        "seeds": (rng.random((B, D)) < 0.2).astype(np.float32),
        "ws": np.eye(K, dtype=np.float32)[np.arange(B) % K],
        "eps": rng.standard_normal((B, nsteps, L)).astype(np.float32),
        "u": rng.random((B, nsteps, D)).astype(np.float32),
    }
    tcfg = tvae.Config(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, params_from_numpy(params, "cpu"), arrays, nsteps


def _t(a):
    return torch.from_numpy(a)


def _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp, zp=False, mode=None):
    args = (a["seeds"], nsteps, a["eps"], a["u"], a["ws"])
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(a["u"]), _t(a["ws"]))
    kw = dict(use_z_prior=zp, return_probs=rp)
    out = {
        "plain": cgv.generate_cl_vae_batch_plain(tparams, tcfg, *targs, mode=mode, **kw).numpy()}
    if jcfg.has_hidden:  # the JAX kernel refuses configs without hidden layers
        out["jax_pallas"] = np.asarray(pallas_generate_vae.generate_cl_vae_batch_pallas(
            params, jcfg, *args, mode=mode, **kw))
    if mode is None:
        out["jax_noise"] = np.asarray(jax_noise(params, jcfg, *args, **kw))
        out["port_noise"] = tgen.generate_cl_vae_batch_noise(tparams, tcfg, *targs, **kw).numpy()
    return out


CASES = {
    "x_prev": dict(use_x_prev=True),
    "x_prev_z_prior": dict(use_x_prev=True, zp=True),
    "no_x_prev": dict(use_x_prev=False),
    "no_x_prev_z_prior": dict(use_x_prev=False, zp=True),
    "vanilla_k1": dict(K=1, use_x_prev=False),
    "ragged_batch": dict(B=11, seed=1),  # not a multiple of the kernel's 2-song tile
    "jsbcs_vae": dict(ckpt="jsbcs_vae", B=5, nsteps=8, seed=2),
    # the wide kernel's widths (f32 weights past one block's shared memory)
    "wide_h256": dict(D=88, H=256, L=4, K=13, B=4, nsteps=8, seed=4),
    "wide_h512": dict(D=88, H=512, L=4, K=13, B=4, nsteps=8, seed=5),
    # no hidden layers: the JAX package samples these through its scan only
    "no_hidden": dict(D=88, H=0, L=4, K=13, B=4, nsteps=8, seed=6),
    "no_hidden_no_x_prev": dict(D=12, H=0, L=2, K=3, use_x_prev=False, seed=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_and_scan(case):
    kw = dict(CASES[case])
    zp = kw.pop("zp", False)
    jcfg, params, tcfg, tparams, a, nsteps = _setup(**kw)
    frames = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=False, zp=zp)
    assert frames["plain"].shape == (a["seeds"].shape[0], nsteps, a["seeds"].shape[1])
    assert 0 < frames["plain"].mean() < 1
    refs = [n for n in ("jax_pallas", "jax_noise", "port_noise") if n in frames]
    assert len(refs) == (3 if jcfg.has_hidden else 2)
    for name in refs:
        np.testing.assert_array_equal(frames["plain"], frames[name], err_msg=name)
    probs = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True, zp=zp)
    for name in refs:
        np.testing.assert_allclose(probs["plain"], probs[name], rtol=0, atol=1e-5, err_msg=name)


def test_bf16_mode_matches_jax_bf16_kernel():
    jcfg, params, tcfg, tparams, a, nsteps = _setup(H=32, nsteps=12, seed=3)
    bf16 = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True, mode="bf16")
    d = np.abs(bf16["plain"] - bf16["jax_pallas"])
    assert d.max() <= 2e-2 and d.mean() <= 2e-3, (d.max(), d.mean())
    f32 = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=True, mode="f32")
    d32 = np.abs(bf16["plain"] - f32["jax_pallas"])
    assert d32.max() < 0.06 and d32.mean() < 0.01, (d32.max(), d32.mean())
    assert d32.max() > 0.0  # bf16 really ran
    frames = _run_all(jcfg, params, tcfg, tparams, a, nsteps, rp=False, mode="bf16")
    assert set(np.unique(frames["plain"])) <= {0.0, 1.0}


def test_bf16_wide_mode_matches_jax_bf16_kernel():
    """bf16 at hidden 512 (D=88, L=4, K=13), the width of a bf16 checkpoint
    whose weights one block does not hold (the cluster kernel takes it on
    two): probabilities with u=1 within max 2e-2 / mean 2e-3 of the JAX bf16
    kernel, as at the narrow width."""
    jcfg, params, tcfg, tparams, a, nsteps = _setup(D=88, H=512, L=4, K=13, B=4, nsteps=8,
                                                    seed=8)
    bcfg = dataclasses.replace(tcfg, bf16_compute=True)
    assert cgv.kernel_for(bcfg) == "generate_cl_vae_cluster"
    assert cgv.cluster_plan(bcfg, 4)["C"] == 2
    a["u"] = np.ones_like(a["u"])
    bf16 = _run_all(jcfg, params, bcfg, tparams, a, nsteps, rp=True, mode="bf16")
    d = np.abs(bf16["plain"] - bf16["jax_pallas"])
    assert d.max() <= 2e-2 and d.mean() <= 2e-3, (d.max(), d.mean())
    f32 = cgv.generate_cl_vae_batch_plain(tparams, tcfg, _t(a["seeds"]), nsteps, _t(a["eps"]),
                                          _t(a["u"]), _t(a["ws"]), return_probs=True).numpy()
    assert np.abs(bf16["plain"] - f32).max() > 0.0  # bf16 really ran


@pytest.mark.parametrize("ckpt", ["jsball_vae", "jsball_vanilla"])
def test_infer_w_matches_the_jax_engine(ckpt):
    """The mean-logit key point of the JAX engine's w-inference
    (``serving/engine.py:386-392``) and of its sampler's ``w_vals=None``."""
    jcfg, params, tcfg, tparams, a, _ = _setup(ckpt=ckpt, B=7)
    w_mean, w_log_var = jvae.encode_w(params, a["seeds"])
    ref = np.asarray(j_ln(w_mean, w_log_var, None, add_noise=False))
    got = tgen.infer_w_cl_vae(tparams, _t(a["seeds"])).numpy()
    assert got.shape == (7, tcfg.n_classes)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    jcfg, params, tcfg, tparams, a, nsteps = _setup()
    before = cgv.LAUNCHES
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(a["u"]), _t(a["ws"]))
    got = cgv.generate_cl_vae_batch_cuda(tparams, tcfg, *targs, use_z_prior=True,
                                         return_probs=True)
    ref = cgv.generate_cl_vae_batch_plain(tparams, tcfg, *targs, use_z_prior=True,
                                          return_probs=True)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cgv.LAUNCHES == before  # no kernel launch on the CPU
    # the engine's and the CLI's entry point: noise from a generator, w given,
    # inferred, or drawn
    for w_vals, w_sample in ((_t(a["ws"]), False), (None, False), (None, True)):
        g = torch.Generator().manual_seed(0)
        out = tgen.generate_cl_vae_batch(tparams, tcfg, _t(a["seeds"]), nsteps, g,
                                         w_vals=w_vals, w_sample=w_sample)
        assert out.shape == (8, nsteps, 12)
        assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    # w_vals=None is the mean-logit point unless w_sample
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    ws = tgen.infer_w_cl_vae(tparams, _t(a["seeds"]))
    torch.testing.assert_close(
        tgen.generate_cl_vae_batch(tparams, tcfg, _t(a["seeds"]), nsteps, g1, return_probs=True),
        tgen.generate_cl_vae_batch(tparams, tcfg, _t(a["seeds"]), nsteps, g2, w_vals=ws,
                                   return_probs=True), rtol=0, atol=0)


def test_modes_and_kernel_input_checks():
    jcfg, params, tcfg, tparams, a, nsteps = _setup()
    targs = (_t(a["seeds"]), nsteps, _t(a["eps"]), _t(a["u"]), _t(a["ws"]))
    assert cgv.pick_mode(tcfg) == "f32"
    assert cgv.pick_mode(dataclasses.replace(tcfg, bf16_compute=True)) == "bf16"
    # int8 on CPU tensors: the plain int8 version, 0/1 frames other than bf16's
    before = cgv.INT8_LAUNCHES
    f8 = cgv.generate_cl_vae_batch_cuda(tparams, tcfg, *targs, mode="int8")
    f16 = cgv.generate_cl_vae_batch_cuda(tparams, tcfg, *targs, mode="bf16")
    assert cgv.INT8_LAUNCHES == before  # no kernel launch on the CPU
    torch.testing.assert_close(
        f8, cgv.generate_cl_vae_batch_plain(tparams, tcfg, *targs, mode="int8"), rtol=0, atol=0)
    assert set(torch.unique(f8).tolist()) <= {0.0, 1.0}
    assert not torch.equal(f8, f16)
    with pytest.raises(ValueError, match="unknown mode"):
        cgv.generate_cl_vae_batch_cuda(tparams, tcfg, *targs, mode="int4")
    # no hidden layers: the cluster kernel, in f32 as the JAX scan samples them
    no_hidden = dataclasses.replace(tcfg, intermediate_dim=0)
    assert cgv.fits(no_hidden) and cgv.kernel_for(no_hidden) == "generate_cl_vae_cluster"
    assert cgv.pick_mode(dataclasses.replace(no_hidden, bf16_compute=True)) == "f32"
    _, _, _, nh_params, nh, _ = _setup(H=0)
    nh_args = (_t(nh["seeds"]), nsteps, _t(nh["eps"]), _t(nh["u"]), _t(nh["ws"]))
    cgv._check(nh_params, no_hidden, *nh_args, "f32")
    got = cgv.generate_cl_vae_batch_cuda(nh_params, no_hidden, *nh_args)
    assert got.shape == (8, nsteps, 12)
    for mode in ("bf16", "int8"):  # a config without hidden layers samples in f32
        with pytest.raises(ValueError, match="need hidden layers"):
            cgv.generate_cl_vae_batch_cuda(nh_params, no_hidden, *nh_args, mode=mode)
    # what the wrapper checks before a launch (the launch itself needs a card)
    assert cgv.kernel_for(tcfg) == "generate_cl_vae_cluster"
    cgv._check(tparams, tcfg, *targs, "f32")
    with pytest.raises(ValueError, match="eps"):
        cgv._check(tparams, tcfg, targs[0], nsteps, targs[2][:, :-1], *targs[3:], "f32")
    with pytest.raises(ValueError, match=r"\[B, D\]"):
        cgv._check(tparams, tcfg, targs[0][:, None], nsteps, *targs[2:], "f32")
    with pytest.raises(ValueError, match="float32"):
        cgv._check(tparams, tcfg, targs[0], nsteps, targs[2].double(), *targs[3:], "f32")
    with pytest.raises(ValueError, match="contiguous"):
        u_t = _t(np.ascontiguousarray(a["u"].transpose(1, 0, 2))).transpose(0, 1)
        cgv._check(tparams, tcfg, targs[0], nsteps, targs[2], u_t, targs[4], "f32")
    # shared memory: the cluster kernel holds f32 weights on one block to H
    # = 200 at D=88, L=4, and on up to 8 blocks to H = 1,600; bf16 to 336 and
    # 2,624; wider models take the cooperative kernel; the wide kernel keeps
    # what neither takes, its per-song state in shared memory up to D + H ~
    # 14,000, past it in a global scratch
    wide = lambda h: tvae.Config(original_dim=88, intermediate_dim=h, latent_dim=4,
                                 n_classes=10, use_x_prev=True)
    blocks = lambda h, mode: cgv.cluster_plan(wide(h), 1, mode)["C"]
    assert [blocks(h, "f32") for h in (200, 208, 400, 408, 808, 816, 1600)] == [1, 2, 2, 4, 4, 8, 8]
    assert [blocks(h, "bf16") for h in (336, 344, 1336, 1344, 2624)] == [1, 2, 4, 8, 8]
    assert not cgv.fits(wide(1608)) and not cgv.fits(wide(2632), "bf16")
    for h, mode, kernel in ((200, "f32", "generate_cl_vae_cluster"),
                            (210, "f32", "generate_cl_vae_cluster"),
                            (512, "f32", "generate_cl_vae_cluster"),
                            (1608, "f32", "generate_cl_vae_coop"),
                            (400, "bf16", "generate_cl_vae_cluster"),
                            (4096, "bf16", "generate_cl_vae_coop")):
        assert cgv.kernel_for(wide(h), mode) == kernel, (h, mode)
    assert cgv._wide_smem_bytes(88, 4096, 4, True, True) <= cgv._SMEM_LIMIT
    assert cgv._wide_smem_bytes(88, 16384, 4, True, True) > cgv._SMEM_LIMIT
    w4096 = dataclasses.replace(tcfg, intermediate_dim=4096)  # D=12: 4 blocks hold it
    assert cgv.kernel_for(w4096) == "generate_cl_vae_cluster"
    with pytest.raises(ValueError, match=r"kernel must be \(4096, 2\)"):
        cgv._check(tparams, w4096, *targs, "f32")
