"""The port's int8 cl_vrnn generation against the JAX package, on the CPU.

The plain version of the int8 kernel (``ops/cuda_generate.py``) against JAX
``generate_cl_vrnn_batch_pallas(mode="int8")`` in interpret mode, on the
same weights and the same NumPy noise; the port's quantization and its
precision rule against JAX's own functions; and the entry points (the
serving engine) that reach int8 where the JAX package does.

Tolerances. Every int8 product is exact on both sides, so at the JAX tests'
size frames and probabilities are equal. On the trained champion the f32
operations around the products (tanh, the gates, the bf16 z head) may round
an ulp apart; with u = 1 (every fed-back frame 0) the probabilities stay
within 1e-6. Free-running, an ulp of h on a rounding tie of h * 127 moves
one int8 code by a step, and the step persists: frames equal in >= 99.9% of
entries and probabilities within 1e-4 on average, no tighter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.cli import common as jcommon
from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu.ops import pallas_generate
from classifying_vae_lstm_tpu.sampling.generate import draw_generation_noise
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.serving import GenerationEngine
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

FT = "artifacts/jsball_vrnn4_ft.npz"
T = torch.from_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread is faster than several workers'
    threads contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def glorot_params(rng, D, H, L, K, seq_length, use_x_prev):
    """Seeded glorot-scale cl_vrnn weights (NumPy), every leaf of the tree."""

    def dense(i, o, bias=0.0):
        lim = np.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": np.full(o, bias, np.float32)}

    def lstm(i):
        d = dense(i, 4 * H)
        d["recurrent_kernel"] = dense(H, 4 * H)["kernel"]
        return d

    return {"hW": dense(seq_length * D, D), "Wargs": dense(D, 2 * (K - 1)),
            "encoder_h": lstm(D + K), "Z_mean": dense(H, L), "Z_log_var": dense(H, L),
            "decoder_h": lstm(L + K + (D if use_x_prev else 0)),
            "X_decoded_mean": dense(H, D, -2.0)}


def _inputs(rng, B, Tseed, nsteps, D, L, K):
    total = Tseed + nsteps
    return ((rng.random((B, Tseed, D)) < 0.2).astype(np.float32),
            rng.standard_normal((B, total, L)).astype(np.float32),
            rng.random((B, total, D)).astype(np.float32),
            np.eye(K, dtype=np.float32)[np.arange(B) % K])


def _both(params, jcfg, tcfg, seeds, nsteps, eps, u, ws, rp):
    """(JAX int8 kernel, port plain int8) on the same arrays."""
    j = np.asarray(pallas_generate.generate_cl_vrnn_batch_pallas(
        params, jcfg, seeds, nsteps, eps, u, ws, return_probs=rp, mode="int8"))
    p = cg.generate_cl_vrnn_batch_plain(params_from_numpy(params, "cpu"), tcfg, T(seeds), nsteps,
                                        T(eps), T(u), T(ws), return_probs=rp, mode="int8")
    return j, p.numpy()


def _ft_weights():
    params, _, _ = jcommon.load_model(FT, "cl_vrnn")
    return jax.tree.map(np.asarray, params)


QUANT_CASES = ["random", "zero_column", "encoder_h/kernel", "encoder_h/recurrent_kernel",
               "decoder_h/kernel", "decoder_h/recurrent_kernel", "X_decoded_mean/kernel"]


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_cols_bit_equal_to_jax(case):
    """Codes and scales bit for bit: on random weights (one column all
    zero, which takes the 1e-12 floor) and on every big weight of the
    trained champion (the x rows of the kernels, as the samplers split them)."""
    if case in ("random", "zero_column"):
        w = np.random.default_rng(0).standard_normal((37, 50)).astype(np.float32)
        if case == "zero_column":
            w[:, 7] = 0.0
    else:
        layer, leaf = case.split("/")
        w = _ft_weights()[layer][leaf]
        w = w[:88] if leaf == "kernel" and layer != "X_decoded_mean" else w
    qj, sj = pallas_generate._quant_cols(jnp.asarray(w))
    qt, st = cg._quant_cols(T(np.array(w)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj)[0])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [512, 1024, 1232, 1240, 1536, 1752, 1760, 2048])
def test_pick_mode_follows_jax(H, bf16, backend):
    """JAX's answer where the config selects the kernel path (``pallas``)
    and JAX gives a mode; the checkpoint's numerics everywhere else."""
    kw = dict(intermediate_dim=H, bf16_compute=bf16, lstm_backend=backend)
    want = pallas_generate.pick_mode(jcl.Config(**kw))
    if backend != "pallas" or want is None:
        want = "bf16" if bf16 else "f32"
    assert cg.pick_mode(tcl.Config(**kw)) == want
    assert cg._jax_precision(tcl.Config(**kw)) == pallas_generate.pick_mode(jcl.Config(**kw))


@pytest.mark.parametrize("use_x_prev", [True, False])
def test_plain_int8_equals_jax_int8_kernel(use_x_prev):
    """The JAX tests' size (H=16, 8 songs x (6 + 10) steps): equal frames and
    equal probabilities."""
    jcfg = jcl.Config(original_dim=12, intermediate_dim=16, latent_dim=2, seq_length=4,
                      n_classes=3, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(0), jcfg))
    tcfg = tcl.Config(**dataclasses.asdict(jcfg))
    seeds, eps, u, ws = _inputs(np.random.default_rng(0), 8, 6, 10, 12, 2, 3)
    for rp in (False, True):
        j, p = _both(params, jcfg, tcfg, seeds, 10, eps, u, ws, rp)
        np.testing.assert_array_equal(p, j)
    # int8 really ran: the f32 sampler gives other probabilities
    f32 = cg.generate_cl_vrnn_batch_plain(params_from_numpy(params, "cpu"), tcfg, T(seeds), 10,
                                          T(eps), T(u), T(ws), return_probs=True)
    assert np.abs(p - f32.numpy()).max() > 1e-6


def test_plain_int8_on_the_trained_champion():
    """``jsball_vrnn4_ft`` (H=256) at 4 songs x (16 + 24) steps, on the JAX
    int8 test's own inputs (``tests/test_pallas_generate.py``
    ``test_int8_mode_on_trained_champion``). The u = 1 bound holds because
    no h * 127 of these inputs lands within an ulp of a rounding tie; on
    other inputs one can, and a code flip then moves the probabilities by up
    to ~4e-3 even with u = 1."""
    params, jcfg, _ = jcommon.load_model(FT, "cl_vrnn")
    params = jax.tree.map(np.asarray, params)
    _, tcfg, _ = tcommon.load_model(FT, "cl_vrnn")
    assert jcfg.intermediate_dim == 256
    B, Tseed, nsteps = 4, 16, 24
    rng = np.random.RandomState(0)
    seeds = (rng.rand(B, Tseed, jcfg.original_dim) < 0.1).astype(np.float32)
    ws = np.eye(jcfg.n_classes, dtype=np.float32)[np.arange(B) % jcfg.n_classes]
    eps, u = (np.array(a) for a in draw_generation_noise(
        jax.random.PRNGKey(3), B, Tseed + nsteps, jcfg.latent_dim, jcfg.original_dim))
    j, p = _both(params, jcfg, tcfg, seeds, nsteps, eps, np.ones_like(u), ws, True)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
    jf, pf = _both(params, jcfg, tcfg, seeds, nsteps, eps, u, ws, False)
    assert set(np.unique(pf)) <= {0.0, 1.0}
    assert (jf == pf).mean() >= 0.999
    jp, pp = _both(params, jcfg, tcfg, seeds, nsteps, eps, u, ws, True)
    assert np.abs(jp - pp).mean() <= 1e-4


def test_plain_int8_in_the_band():
    """H=1,240, the narrowest width JAX samples in int8 at D=88, L=2: 2 songs
    x (2 + 4) steps on seeded glorot weights, equal to the JAX kernel."""
    D, H, L, K = 88, 1240, 2, 3
    jcfg = jcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=2,
                      n_classes=K, use_x_prev=True, bf16_compute=True, lstm_backend="pallas")
    assert pallas_generate.pick_mode(jcfg) == "int8"
    assert cg.pick_mode(tcl.Config(**dataclasses.asdict(jcfg))) == "int8"
    rng = np.random.default_rng(1)
    params = glorot_params(rng, D, H, L, K, 2, True)
    seeds, eps, u, ws = _inputs(rng, 2, 2, 4, D, L, K)
    tcfg = tcl.Config(**dataclasses.asdict(jcfg))
    jf, pf = _both(params, jcfg, tcfg, seeds, 4, eps, u, ws, False)
    np.testing.assert_array_equal(pf, jf)
    jp, pp = _both(params, jcfg, tcfg, seeds, 4, eps, u, ws, True)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-6)


def test_engine_samples_in_int8_where_jax_does():
    """The serving engine, built from the bf16 config the JAX package's
    ``--lstm_backend auto`` writes at H=1,240 (``pallas``, ``bf16_compute``),
    samples in int8 (``serve --lstm_backend keep``): one request equals the
    plain int8 sampler with the engine's noise. ``serve``'s default ``auto``
    resolves to ``xla`` and samples the same checkpoint in bf16, as JAX does
    off a TPU."""
    D, H, L, K, Tseed = 88, 1240, 2, 3, 4
    cfg = tcl.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=Tseed,
                     n_classes=K, use_x_prev=True, bf16_compute=True, lstm_backend="pallas",
                     fusion=(True, True, True), two_cell=False)
    rng = np.random.default_rng(3)
    raw = glorot_params(rng, D, H, L, K, Tseed, True)
    bank = (rng.random((5, Tseed, D)) < 0.2).astype(np.float32)
    eng = GenerationEngine(raw, tcommon.resolve_lstm_backend(cfg, "keep"), bank, device="cpu")
    assert eng.mode == "int8"
    got = eng.generate(n=1, nsteps=3, seed_indices=[2])
    # the engine's path: bucket (1, 32), w inferred, noise from its generator
    g = torch.Generator().manual_seed(0)
    eps, u = tgen.draw_generation_noise(g, 1, Tseed + 32, L, D)
    seeds = T(bank[[2]])
    ws = tgen.infer_w_cl_vrnn(eng.params, cfg, seeds)
    ref = cg.generate_cl_vrnn_batch_plain(eng.params, cfg, seeds, 32, eps, u, ws, mode="int8")
    np.testing.assert_array_equal(got, ref[:, :3].numpy())
    auto = GenerationEngine(raw, tcommon.resolve_lstm_backend(cfg, "auto"), bank, device="cpu")
    assert auto.cfg.lstm_backend == "xla" and auto.mode == "bf16"
