"""The port's int8 cl_vae generation against the JAX package, on the CPU.

The plain version of the int8 kernel (``ops/cuda_generate_vae.py``) against
JAX ``generate_cl_vae_batch_pallas(mode="int8")`` in interpret mode, on the
same weights and noise; the port's precision rule against JAX's; and the
entry points that reach int8 where the JAX package does: ``serve
--gen_backend pallas`` and ``cl_vae_sample --gen_backend pallas`` of a bf16
seq-concat checkpoint (D=1,024, the committed corpus's 64 active pitches x 16
steps), at H=4,160, the narrowest width JAX samples in int8 there.

Tolerances: every int8 product is exact on both sides; the f32 operations
around them (the sigmoid, the bf16 z heads' sums) may round an ulp apart, so
frames are equal and probabilities within 1e-6.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.models import cl_vae as jvae
from classifying_vae_lstm_tpu.ops import pallas_generate_vae
from classifying_vae_lstm_tpu.sampling.generate import draw_generation_noise
from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, common, serve
from classifying_vae_lstm_tpu_torch.data import PianoData, read_midi_roll
from classifying_vae_lstm_tpu_torch.models import cl_vae as tvae
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
from classifying_vae_lstm_tpu_torch.sampling import generate as tgen
from classifying_vae_lstm_tpu_torch.serving import GenerationEngine
from classifying_vae_lstm_tpu_torch.train.checkpoint import save_checkpoint
from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

CORPUS = "data/input/Piano-midi_all.pickle"
T = torch.from_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """Small products: one intra-op thread is faster than several workers'
    threads contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("H", [1024, 4096, 4160, 5120, 7936, 8000, 12288])
@pytest.mark.parametrize("D", [88, 976, 1024])
def test_pick_mode_follows_jax(D, H, bf16, backend):
    """JAX's answer where the config selects the kernel path (``pallas``)
    and JAX gives a mode; the checkpoint's numerics everywhere else."""
    kw = dict(original_dim=D, intermediate_dim=H, latent_dim=16, n_classes=13, use_x_prev=True,
              bf16_compute=bf16, gen_backend=backend)
    want = pallas_generate_vae.pick_mode(jvae.Config(**kw))
    if backend != "pallas" or want is None:
        want = "bf16" if bf16 else "f32"
    assert cgv.pick_mode(tvae.Config(**kw)) == want
    assert cgv._jax_precision(tvae.Config(**kw)) == pallas_generate_vae.pick_mode(
        jvae.Config(**kw))


@pytest.mark.parametrize("use_z_prior", [False, True])
@pytest.mark.parametrize("use_x_prev", [True, False])
def test_plain_int8_equals_jax_int8_kernel(use_x_prev, use_z_prior):
    """The JAX int8 test's setup (``tests/test_pallas_generate_vae.py``: H=16,
    8 songs x 10 steps): equal frames, probabilities within 1e-6, with u
    drawn and with u = 1."""
    cfg = jvae.Config(original_dim=12, intermediate_dim=16, latent_dim=2,
                      intermediate_class_dim=16, n_classes=3, use_x_prev=use_x_prev)
    params = jax.tree.map(np.asarray, jvae.init(jax.random.PRNGKey(0), cfg))
    seeds = np.asarray((jax.random.uniform(jax.random.PRNGKey(1), (8, 12)) < 0.2), np.float32)
    ws = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
    eps, u = (np.array(a) for a in draw_generation_noise(jax.random.PRNGKey(2), 8, 10, 2, 12))
    tcfg = tvae.Config(**dataclasses.asdict(cfg))
    tp = params_from_numpy(params, "cpu")
    for uu in (u, np.ones_like(u)):
        for rp in (False, True):
            j = np.asarray(pallas_generate_vae.generate_cl_vae_batch_pallas(
                params, cfg, seeds, 10, eps, uu, ws, use_z_prior=use_z_prior, return_probs=rp,
                mode="int8"))
            p = cgv.generate_cl_vae_batch_plain(tp, tcfg, T(seeds), 10, T(eps), T(uu), T(ws),
                                                use_z_prior=use_z_prior, return_probs=rp,
                                                mode="int8").numpy()
            if rp:
                np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(p, j)


def test_seq_concat_layout_is_the_training_pruning():
    """A seq-concat checkpoint's rows: the test windows pruned and
    flattened as training prunes them, and back to 88-pitch frames."""
    layout = common.SeqConcat.of(CORPUS, {"seq_length": 16, "batch_size": 100,
                                          "original_dim": 1024})
    assert layout.mask.sum() == 64
    P = PianoData(CORPUS, batch_size=1, seq_length=16, squeeze_x=True, return_y_next=False)
    rows = layout.rows(P.x_test)
    assert common.prune_and_flatten_cl_vae(P, 16, layout.mask) == 1024
    np.testing.assert_array_equal(rows, P.x_test)
    back = layout.rolls(rows[None, :5])  # five windows in a row: 80 frames
    assert back.shape == (1, 80, 88)
    np.testing.assert_array_equal(layout.rows(back[0].reshape(5, 16, 88)), rows[:5])
    # a short roll is front-padded with silent frames
    assert layout.rows(np.ones((3, 88), np.float32)).sum() == 3 * 64
    with pytest.raises(ValueError, match="original_dim"):
        common.SeqConcat.of(CORPUS, {"seq_length": 16, "batch_size": 100, "original_dim": 976})


def _seq_concat_checkpoint(tmp_path, H):
    """A bf16 seq-concat cl_vae (D=1,024, the committed corpus's 13 keys,
    seeded Keras init) as cl_vae_train writes it: args.json + weights."""
    margs = {"run_name": "seq", "batch_size": 100, "original_dim": 1024, "intermediate_dim": H,
             "latent_dim": 16, "seq_length": 16, "intermediate_class_dim": 256, "n_classes": 13,
             "use_x_prev": False, "predict_next": False, "bf16_compute": True,
             "train_backend": "xla", "w_log_var_prior": 0.0}
    cfg = common.cl_vae_config_from_args(margs)
    params = tvae.init(torch.Generator().manual_seed(0), cfg)
    params["x_decoded_mean"]["bias"] -= 2.0  # sparse frames, as the trained models give
    save_checkpoint(str(tmp_path / "seq.npz"), params)
    with open(tmp_path / "seq.json", "w") as f:
        json.dump(margs, f)
    return str(tmp_path / "seq.npz")


def test_seq_concat_checkpoint_serves_and_samples_in_int8(tmp_path):
    """``serve --gen_backend pallas`` of the bf16 seq-concat checkpoint at
    H=4,160 reports int8, answers /generate with 88-pitch rolls (t windows
    of 16 frames), and one request equals the plain int8 sampler with the
    engine's noise; ``auto`` (xla) samples it in bf16, as JAX does off a TPU;
    ``cl_vae_sample --gen_backend pallas`` writes its MIDI files."""
    ckpt = _seq_concat_checkpoint(tmp_path, 4160)
    args = serve.build_parser().parse_args(
        ["-i", ckpt, "--train_file", CORPUS, "--device", "cpu", "--warmup", "off", "--port", "0",
         "--gen_backend", "pallas"])
    eng, _, layout = serve.build_engine(args)
    assert eng.mode == "int8" and eng.seed_bank.shape[1] == 1024 and layout.seq_length == 16
    got = eng.generate(n=1, nsteps=2, seed_indices=[3])
    # the engine's path: bucket (1, 32), w inferred inside the sampler, noise
    # from its generator
    g = torch.Generator().manual_seed(0)
    seeds = T(eng.seed_bank[[3]])
    ws = tgen.infer_w_cl_vae(eng.params, seeds)
    eps, u = tgen.draw_generation_noise(g, 1, 32, 16, 1024)
    ref = cgv.generate_cl_vae_batch_plain(eng.params, eng.cfg, seeds, 32, eps, u, ws,
                                          mode="int8")
    np.testing.assert_array_equal(got, ref[:, :2].numpy())
    auto = GenerationEngine(eng.params, common.resolve_gen_backend(eng.cfg, "auto"),
                            eng.seed_bank, device="cpu")
    assert auto.cfg.gen_backend == "xla" and auto.mode == "bf16"
    # the HTTP frontend: 88-pitch rolls of t x 16 frames, the mode in /stats
    httpd = serve.Server(("127.0.0.1", 0), serve.make_handler(eng, {"C": 0}, False, layout))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        req = urllib.request.Request(f"{url}/generate",
                                     data=json.dumps({"n": 1, "t": 2}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            rolls = np.asarray(json.load(r)["rolls"])
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert rolls.shape == (1, 32, 88) and set(np.unique(rolls)) <= {0, 1}
    assert stats["mode"] == "int8" and stats["gen_backend"] == "pallas"
    assert stats["int8_launches"] == 0  # the plain version, on the CPU
    out = cl_vae_sample.sample(cl_vae_sample.build_parser().parse_args(
        ["seq", "-i", ckpt, "--train_file", CORPUS, "-n", "2", "-t", "2", "--gen_backend",
         "pallas", "--device", "cpu", "--sample_dir", str(tmp_path / "smp")]))
    assert out.shape == (2, 32, 88) and set(np.unique(out)) <= {0.0, 1.0}
    files = sorted(os.listdir(tmp_path / "smp"))
    assert files == ["seq_0.mid", "seq_1.mid"]
    got_roll = read_midi_roll(str(tmp_path / "smp" / "seq_0.mid"))
    np.testing.assert_array_equal(got_roll, np.repeat(out[0], 2, axis=0)[: len(got_roll)])
