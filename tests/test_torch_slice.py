"""The whole serving slice on the CPU: the trained ``artifacts/jsball_vrnn4``
weights, Piano-midi_all seed windows, w inference, then generation — port vs
JAX with the same noise.

Frames are compared over a 16-step horizon, where they must be equal; the
probabilities within rtol 1e-5, atol 1e-5 (f32 on both sides, only the
summation order differs; atol 1e-5 because the 256-wide products of the
trained model carry a few ulps more than the small-model tests).
"""

import dataclasses

import numpy as np
import torch

from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.sampling import generate as jgen
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.data import PianoData
from classifying_vae_lstm_tpu_torch.ops import cuda_generate
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy


def test_slice_on_trained_weights_matches_jax():
    jparams, jcfg, _ = jcommon.load_model("artifacts/jsball_vrnn4.npz", "cl_vrnn")
    raw, tcfg, _ = tcommon.load_model("artifacts/jsball_vrnn4.npz", "cl_vrnn")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tparams = params_from_numpy(raw, "cpu")
    P = PianoData("data/input/Piano-midi_all.pickle", batch_size=1, seq_length=32,
                  squeeze_x=False)
    rng = np.random.default_rng(0)
    B, nsteps = 8, 16
    seeds = P.x_test[rng.choice(len(P.x_test), size=B, replace=False)]
    Tseed = seeds.shape[1]
    n_chunks = Tseed // tcfg.seq_length
    eps_w = rng.standard_normal((B, n_chunks, tcfg.n_classes - 1)).astype(np.float32)
    eps = rng.standard_normal((B, Tseed + nsteps, tcfg.latent_dim)).astype(np.float32)
    u = rng.random((B, Tseed + nsteps, tcfg.original_dim)).astype(np.float32)
    T = torch.from_numpy

    # w: the mean of Logistic-Normal points over the seed's 16-frame chunks
    ws_j = np.stack([np.asarray(jgen.infer_w_cl_vrnn_noise(jparams, jcfg, seeds[i], eps_w[i],
                                                           w_sample=True))
                     for i in range(B)])
    ws_t = tgen.infer_w_cl_vrnn_noise(tparams, tcfg, T(seeds), T(eps_w), w_sample=True)
    np.testing.assert_allclose(ws_t.numpy(), ws_j, rtol=1e-5, atol=1e-6)

    for rp in (False, True):
        ref = np.asarray(jgen.generate_cl_vrnn_batch_noise(jparams, jcfg, seeds, nsteps, eps, u,
                                                           ws_j, return_probs=rp))
        targs = (T(seeds), nsteps, T(eps), T(u), ws_t)
        got = {
            "port_noise": tgen.generate_cl_vrnn_batch_noise(tparams, tcfg, *targs,
                                                            return_probs=rp).numpy(),
            "kernel_plain": cuda_generate.generate_cl_vrnn_batch_cuda(
                tparams, tcfg, *targs, return_probs=rp).numpy(),
        }
        for name, g in got.items():
            assert g.shape == (B, nsteps, 88)
            if rp:
                np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(g, ref, err_msg=name)
                assert 0 < g.mean() < 0.5  # real music: sparse, not silent
