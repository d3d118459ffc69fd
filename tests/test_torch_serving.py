"""The port's serving engine and HTTP frontend on the CPU (plain samplers of
both families), and its data pipeline against the JAX package's."""

import base64
import json
import socket
import tempfile
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.data import PianoData as JPianoData
from classifying_vae_lstm_tpu.data.midi import MidiWriter as JMidiWriter
from classifying_vae_lstm_tpu.data.midi import roll_from_smf_bytes as j_roll_from_smf_bytes
from classifying_vae_lstm_tpu.models import cl_vrnn as jcl
from classifying_vae_lstm_tpu_torch.cli import common, serve
from classifying_vae_lstm_tpu_torch.data import MidiWriter, PianoData, roll_from_smf_bytes
from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.serving import GenerationEngine
from classifying_vae_lstm_tpu_torch.serving.engine import _bucket


def _engine(dynamic_batching=False, window_ms=25.0, D=16):
    jcfg = jcl.Config(original_dim=D, intermediate_dim=12, latent_dim=2, seq_length=4,
                      n_classes=3)
    params = jax.tree.map(np.asarray, jcl.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    bank = (rng.random((6, 8, D)) < 0.2).astype(np.float32)
    cfg = tcl.Config(original_dim=D, intermediate_dim=12, latent_dim=2, seq_length=4,
                     n_classes=3)
    return GenerationEngine(params, cfg, bank, np.arange(6) % 3, device="cpu",
                            dynamic_batching=dynamic_batching, batch_window_ms=window_ms)


def _binary(a):
    return set(np.unique(a).tolist()) <= {0.0, 1.0}


def test_bucketing_and_shapes():
    assert _bucket(1, (1, 4, 16)) == 1 and _bucket(3, (1, 4, 16)) == 4
    assert _bucket(17, (1, 4, 16)) == 16
    eng = _engine()
    out = eng.generate(n=3, nsteps=40)  # pads to bucket (4, 64), slices back
    assert out.shape == (3, 40, 16) and _binary(out)
    assert eng.stats["requests"] == 1 and eng.stats["songs"] == 3
    assert eng.generate(n=2, nsteps=32, infer_w=False).shape == (2, 32, 16)
    assert eng.generate(n=2, nsteps=32, key_name_index=1).shape == (2, 32, 16)
    assert eng.generate(n=2, nsteps=32, seed_indices=[0, 3]).shape == (2, 32, 16)
    with pytest.raises(ValueError):
        eng.generate(n=1, nsteps=32, key_name_index=99)
    roll = np.zeros((5, 16), np.float32)
    roll[:, 3] = 1.0
    assert eng.generate(n=2, nsteps=16, seed_rolls=roll, key_name_index=1).shape == (2, 16, 16)


def test_warmup_covers_the_bucket_grid_and_chunks_oversized_requests():
    eng = _engine()
    eng.BATCH_BUCKETS = (1, 2)
    eng.STEP_BUCKETS = (8, 16)
    eng.warmup()
    assert eng.stats["warm_buckets"] == 4  # the full grid
    out = eng.generate(n=5, nsteps=16)  # > largest bucket: chunked 2 + 2 + 1
    assert out.shape == (5, 16, 16) and _binary(out)
    # each chunk is a request of its own, on a warm bucket
    assert eng.stats["warm_buckets"] == 4 and eng.stats["requests"] == 3
    th = _engine().warmup(batch_buckets=(1,), step_buckets=(8,), background=True)
    th.join(timeout=120)
    assert not th.is_alive()


def test_dynamic_batching_coalesces_a_burst():
    eng = _engine(dynamic_batching=True, window_ms=2000.0)
    eng.warmup(step_buckets=(32,))
    eng._batcher.max_songs = 8  # four 2-song requests complete a group
    results, errors = [None] * 5, []
    barrier = threading.Barrier(5)

    def client(i):
        try:
            barrier.wait(timeout=30)
            results[i] = eng.generate(n=2, nsteps=32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    for r in results:
        assert r.shape == (2, 32, 16) and _binary(r)
    # at most one request bypasses solo; the rest coalesce into groups
    assert eng.stats["batches"] >= 1
    assert eng.stats["batched_songs"] > 2 * eng.stats["batches"]
    ls = eng.latency_stats()
    assert ls["p95_ms"] > 0 and ls["songs_per_sec"] is not None


def test_dynamic_batching_mixed_step_buckets_and_solo_bypass():
    eng = _engine(dynamic_batching=True, window_ms=10.0)
    outs = {}
    a = threading.Thread(target=lambda: outs.setdefault("a", eng.generate(n=2, nsteps=20)))
    b = threading.Thread(target=lambda: outs.setdefault("b", eng.generate(n=2, nsteps=60)))
    a.start(); b.start(); a.join(timeout=120); b.join(timeout=120)
    assert outs["a"].shape == (2, 20, 16) and outs["b"].shape == (2, 60, 16)
    base = eng.stats["batches"]
    eng.generate(n=2, nsteps=20)  # warm bucket, empty queue: bypasses the batcher
    assert eng.stats["batches"] == base


def _post(port, body, raw=False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=body if raw else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_frontend_on_an_ephemeral_port(tmp_path):
    eng = _engine()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve.make_handler(eng, {"C": 0, "E-": 1}, True))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r)["ok"]
        code, out = _post(port, {"n": 2, "t": 16})
        assert code == 200 and np.asarray(out["rolls"]).shape == (2, 16, 16)
        code, out = _post(port, {"n": 1, "t": 8, "format": "midi_base64", "key": "C"})
        assert code == 200 and base64.b64decode(out["midi_base64"][0])[:4] == b"MThd"
        roll = np.zeros((6, 88), np.float32)
        roll[:, [39, 43]] = 1.0
        MidiWriter().dump_sequence_to_midi(roll, str(tmp_path / "s.mid"))
        seed_b64 = base64.b64encode((tmp_path / "s.mid").read_bytes()).decode()
        assert _post(port, {"n": 1, "t": 8, "seed_midi_base64": seed_b64})[0] == 200
        assert _post(port, {"n": 1, "t": 8, "seed_midi_base64": "bm90IG1pZGk="})[0] == 400
        assert _post(port, {"n": 0, "t": 8})[0] == 400
        assert _post(port, {"n": 1, "t": 99999})[0] == 400
        assert _post(port, {"n": 1, "t": 8, "format": "nope"})[0] == 400
        assert _post(port, {"n": 1, "t": 8, "key": "Q"})[0] == 400
        assert _post(port, b"{not json", raw=True)[0] == 400
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 3 and stats["p50_ms"] > 0
        assert stats["device"] == "cpu" and stats["gen_path"] == "plain"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_listen_backlog_holds_a_burst():
    """32 clients connect before the server accepts any, and none is dropped
    (with socketserver's backlog of 5 the 7th connection request is dropped,
    and its client retries only after 1 s)."""
    httpd = serve.Server(("127.0.0.1", 0), BaseHTTPRequestHandler)
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(httpd.server_address, timeout=0.5))
    finally:
        for s in socks:
            s.close()
        httpd.server_close()


def test_make_server_on_the_trained_checkpoint():
    """The CLI entry point end to end on the CPU: jsball_vrnn4 behind the
    HTTP server, Piano-midi_all seeds."""
    args = serve.build_parser().parse_args(
        ["-i", "artifacts/jsball_vrnn4.npz", "--train_file", "data/input/Piano-midi_all.pickle",
         "--device", "cpu", "--warmup", "off", "--port", "0"])
    httpd, eng = serve.make_server(args)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, out = _post(port, {"n": 1, "t": 8, "key": "C"})
        assert code == 200
        rolls = np.asarray(out["rolls"])
        assert rolls.shape == (1, 8, 88) and _binary(rolls)
        assert eng.seed_bank.shape == (4180, 32, 88)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_pianodata_and_midi_match_jax():
    kw = dict(batch_size=1, seq_length=32, squeeze_x=False)
    got = PianoData("data/input/Piano-midi_Cs.pickle", **kw)
    ref = JPianoData("data/input/Piano-midi_Cs.pickle", **kw)
    for split in ("train", "valid", "test"):
        for attr in (f"x_{split}", f"y_{split}", f"{split}_song_inds", f"{split}_song_keys"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr), err_msg=attr)
    assert got.key_map == ref.key_map
    roll = (np.random.default_rng(0).random((12, 88)) < 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        MidiWriter().dump_sequence_to_midi(roll, f"{d}/a.mid")
        JMidiWriter().dump_sequence_to_midi(roll, f"{d}/b.mid")
        with open(f"{d}/a.mid", "rb") as fa, open(f"{d}/b.mid", "rb") as fb:
            a, b = fa.read(), fb.read()
    assert a == b  # byte-identical MIDI files
    np.testing.assert_array_equal(roll_from_smf_bytes(a), j_roll_from_smf_bytes(a))


# ---- the cl_vae family: the trained jsball_vae (K=10) and jsbcs_vae (K=2)

_VAE_BANKS = {}


def _vae_engine(name="jsball_vae", corpus="data/input/Piano-midi_all.pickle", **kw):
    """A CPU engine over a trained cl_vae checkpoint, seeded from the first
    frames of the corpus's test windows (as ``cli.serve`` seeds it)."""
    if corpus not in _VAE_BANKS:
        P = PianoData(corpus, batch_size=1, seq_length=32, squeeze_x=True)
        _VAE_BANKS[corpus] = (P.x_test[:, 0], P.test_song_keys, dict(P.key_map))
    bank, keys, key_map = _VAE_BANKS[corpus]
    params, cfg, _ = common.load_model(f"artifacts/{name}.npz", "cl_vae")
    return GenerationEngine(params, cfg, bank, keys, device="cpu", **kw), key_map


def test_cl_vae_engine_requests():
    """jsball_vae on Piano-midi_all: inferred-w, key-filtered and
    user-seeded requests (its 10 key classes cannot one-hot the corpus's 13
    keys, so true-key requests go to jsbcs_vae below)."""
    eng, key_map = _vae_engine()
    assert eng.family == "cl_vae" and eng.mode == "f32"
    assert eng.seed_bank.shape == (4180, 88)
    before = cuda_generate_vae.LAUNCHES
    out = eng.generate(n=3, nsteps=40)  # pads to bucket (4, 64), slices back
    assert out.shape == (3, 40, 88) and _binary(out) and out.any()
    out = eng.generate(n=2, nsteps=16, key_name_index=key_map["C"])
    assert out.shape == (2, 16, 88) and _binary(out)
    roll = np.zeros((5, 88), np.float32)
    roll[-1, [39, 43, 46]] = 1.0
    assert eng._coerce_seed_rolls(roll).shape == (1, 88)
    np.testing.assert_array_equal(eng._coerce_seed_rolls(roll)[0], roll[-1])
    assert eng.generate(n=2, nsteps=8, seed_rolls=roll).shape == (2, 8, 88)
    assert eng.generate(n=1, nsteps=8, seed_rolls=roll, key_name_index=3).shape == (1, 8, 88)
    assert eng.stats["requests"] == 4 and eng.stats["songs"] == 8
    assert cuda_generate_vae.LAUNCHES == before  # the plain version, on the CPU
    # the engine's w-inference is the sampler's mean-logit point
    seeds = torch.from_numpy(eng.seed_bank[:3])
    ws = eng._infer_ws(seeds, 3)
    assert ws.shape == (3, 10)
    torch.testing.assert_close(ws.sum(-1), torch.ones(3))


def test_cl_vae_true_key_conditioning():
    """jsbcs_vae on Piano-midi_Cs, whose keys (C, E-) are the model's two:
    true-key requests condition on each seed's key; seeded requests and a
    warm-up over a small grid, explicit-w and inferred-w entries alike."""
    eng, _ = _vae_engine("jsbcs_vae", "data/input/Piano-midi_Cs.pickle")
    eng.BATCH_BUCKETS = (1, 4)
    eng.STEP_BUCKETS = (8, 16)
    calls = []
    real_run = eng._run
    eng._run = lambda seeds, t, ws: calls.append(ws is None) or real_run(seeds, t, ws)
    eng.warmup()
    assert eng.stats["warm_buckets"] == 4 and sorted(calls) == [False] * 4 + [True] * 4
    out = eng.generate(n=3, nsteps=16, infer_w=False)
    assert out.shape == (3, 16, 88) and _binary(out)
    out = eng.generate(n=2, nsteps=8, infer_w=False, seed_indices=[0, 5])
    assert out.shape == (2, 8, 88)
    with pytest.raises(ValueError):
        eng.generate(n=1, nsteps=8, key_name_index=7)  # no seed has key 7


def test_cl_vae_dynamic_batching_coalesces_a_burst():
    eng, _ = _vae_engine(dynamic_batching=True, batch_window_ms=2000.0)
    eng.warmup(batch_buckets=(1, 4, 16), step_buckets=(32,))
    eng._batcher.max_songs = 8  # four 2-song requests complete a group
    results, errors = [None] * 5, []
    barrier = threading.Barrier(5)

    def client(i):
        try:
            barrier.wait(timeout=30)
            results[i] = eng.generate(n=2, nsteps=32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    for r in results:
        assert r.shape == (2, 32, 88) and _binary(r)
    assert eng.stats["batches"] >= 1
    assert eng.stats["batched_songs"] > 2 * eng.stats["batches"]


@pytest.mark.parametrize("hidden", [256, 0])
def test_cl_vae_engine_takes_wide_and_no_hidden_checkpoints(tmp_path, hidden, monkeypatch):
    """A cl_vae checkpoint whose weights one block does not hold (hidden 256
    in f32: the cluster kernel on two blocks), or without hidden layers,
    serves on the CPU, and on a card the engine does not refuse it before
    any request (the cl_vrnn engine still refuses a model too wide for its
    kernel: past H ~ 80,000, where a block's unit groups no longer hold 16
    songs' state)."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate
    from classifying_vae_lstm_tpu_torch.serving import engine as engine_mod

    corpus = "data/input/Piano-midi_Cs.pickle"
    cl_vae_train.train(cl_vae_train.build_parser().parse_args(
        ["w", "--device", "cpu", "--train_file", corpus, "--intermediate_dim", str(hidden),
         "--intermediate_class_dim", "16", "--latent_dim", "2", "--batch_size", "2000",
         "--num_epochs", "2", "--patience", "0", "--use_x_prev", "--model_dir", str(tmp_path)]))
    args = serve.build_parser().parse_args(
        ["-i", str(tmp_path / "w.npz"), "--train_file", corpus, "--device", "cpu",
         "--warmup", "off", "--port", "0"])
    httpd, eng = serve.make_server(args)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert eng.family == "cl_vae"
        assert cuda_generate_vae.kernel_for(eng.cfg) == "generate_cl_vae_cluster"
        assert cuda_generate_vae.cluster_plan(eng.cfg, 2)["C"] == (2 if hidden else 1)
        code, out = _post(port, {"n": 2, "t": 8, "key": "C", "infer_w": False})
        assert code == 200 and np.asarray(out["rolls"]).shape == (2, 8, 88)
        assert _binary(np.asarray(out["rolls"]))
    finally:
        httpd.shutdown()
        httpd.server_close()
    # on a card: the engine gets past its width check (and here, without a
    # card, fails only where it moves the weights to the device)
    monkeypatch.setattr(engine_mod, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(Exception) as e:
        GenerationEngine(eng.params, eng.cfg, eng.seed_bank, device="cuda")
    assert "too wide" not in str(e.value)
    wide_vrnn = tcl.Config(original_dim=88, intermediate_dim=100_000, latent_dim=2, n_classes=2)
    assert not cuda_generate.fits(wide_vrnn)
    with pytest.raises(ValueError, match="too wide"):
        GenerationEngine({}, wide_vrnn, eng.seed_bank, device="cuda")


def test_make_server_on_the_trained_cl_vae_checkpoint(tmp_path):
    """``cli.serve --family auto --device cpu`` on jsball_vae answers
    /generate with rolls and with MIDI, seeded by the bank or by MIDI."""
    args = serve.build_parser().parse_args(
        ["-i", "artifacts/jsball_vae.npz", "--train_file", "data/input/Piano-midi_all.pickle",
         "--device", "cpu", "--warmup", "off", "--port", "0", "--family", "auto"])
    httpd, eng = serve.make_server(args)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert eng.family == "cl_vae" and eng.seed_bank.shape == (4180, 88)
        code, out = _post(port, {"n": 2, "t": 8, "key": "C"})
        assert code == 200
        rolls = np.asarray(out["rolls"])
        assert rolls.shape == (2, 8, 88) and _binary(rolls)
        code, out = _post(port, {"n": 2, "t": 12, "format": "midi_base64"})
        assert code == 200 and len(out["midi_base64"]) == 2
        assert all(base64.b64decode(m)[:4] == b"MThd" for m in out["midi_base64"])
        roll = np.zeros((6, 88), np.float32)
        roll[:, [39, 43]] = 1.0
        MidiWriter().dump_sequence_to_midi(roll, str(tmp_path / "s.mid"))
        seed_b64 = base64.b64encode((tmp_path / "s.mid").read_bytes()).decode()
        assert _post(port, {"n": 1, "t": 8, "seed_midi_base64": seed_b64})[0] == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["family"] == "cl_vae" and stats["gen_backend"] == "xla"
        assert stats["requests"] == 3 and stats["gen_path"] == "plain"
    finally:
        httpd.shutdown()
        httpd.server_close()
