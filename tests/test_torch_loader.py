"""The port's host runtime, streamed batches and profiler trace.

* ``runtime.native``: ``build()`` is called here (never skipped), and
  ``sliding_window_native``, ``song_to_roll_native`` and ``gather_rows``
  equal, exactly, the JAX package's NumPy semantics (its NumPy windowing
  and song-to-roll with the native path switched off; plain indexing),
  quirk Q1 and the octave shifts included. Six processes whose first call
  builds the library into one empty directory all succeed, and leave one
  library and no temporary file: the build is atomic.
* ``data.loader.batch_iterator``: the same batches as the JAX package's for
  the same NumPy generator state, shuffled (native gather) or not (NumPy
  order), with and without the remainder; ``device_prefetch`` on the CPU
  passes the arrays through as tensors that share their memory.
* ``Trainer.train_epoch_streaming`` equals a ``train_step`` loop over those
  batches (bitwise: the same steps); ``fit(streaming=True)`` and the train
  CLIs' ``--streaming`` train through it.
* ``--trace_dir``: one epoch, the second, is profiled, and its Chrome trace
  written into the directory.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.data import loader as jloader
from classifying_vae_lstm_tpu.data import pianoroll as jpr
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.data import loader as tloader
from classifying_vae_lstm_tpu_torch.models import cl_vrnn as tcl
from classifying_vae_lstm_tpu_torch.optim import init_optimizer
from classifying_vae_lstm_tpu_torch.runtime import native
from classifying_vae_lstm_tpu_torch.train import loop
from classifying_vae_lstm_tpu_torch.train.loop import Trainer, copy_params, fit

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = "data/input/Piano-midi_Cs.pickle"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture
def jax_numpy_path(monkeypatch):
    """The JAX package's data pipeline with its native path switched off."""
    monkeypatch.setattr(jpr, "_native", lambda: None)


def test_build_returns_the_library():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR and path.suffix == ".so"
    assert native.build() == path


@pytest.mark.parametrize("seq,step", [(1, 1), (2, 1), (16, 1), (16, 4), (17, 3), (299, 1),
                                      (300, 1), (400, 2)])
def test_sliding_window_matches_jax_numpy(jax_numpy_path, seq, step):
    rng = np.random.default_rng(0)
    roll = (rng.random((300, 88)) < 0.1).astype(np.float32)
    got, want = native.sliding_window_native(roll, seq, step), jpr.sliding_window(roll, seq, step)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_song_to_roll_matches_jax_numpy(jax_numpy_path):
    import pickle

    with open(CORPUS, "rb") as f:
        songs = pickle.load(f, encoding="latin1")["train"][:6]
    rng = np.random.default_rng(1)
    for lo, hi in ((15, 96), (40, 116)):  # shifted an octave down, and up
        songs.append([sorted(rng.choice(np.arange(lo, hi), size=4, replace=False).tolist())
                      for _ in range(90)] + [[lo, hi - 1]])
    for song in songs:
        want = jpr.song_to_pianoroll(song)
        got = native.song_to_roll_native(song)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_gather_rows_matches_indexing():
    rng = np.random.default_rng(2)
    src = rng.random((500, 16, 88)).astype(np.float32)
    perm = rng.permutation(500)[:333]
    np.testing.assert_array_equal(native.gather_rows(src, perm), src[perm])
    np.testing.assert_array_equal(native.gather_rows(src[:, 0, :2], perm), src[perm, 0, :2])


_CONCURRENT = """
import sys
from pathlib import Path

import numpy as np

from classifying_vae_lstm_tpu_torch.runtime import native

native.BUILD_DIR = Path(sys.argv[1])
src = np.arange(24, dtype=np.float32).reshape(6, 4)
assert (native.gather_rows(src, np.array([5, 0, 3])) == src[[5, 0, 3]]).all()
print(native.build())
"""


def test_six_concurrent_first_builds_all_succeed(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT, str(tmp_path / "build")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    paths = {o.strip().splitlines()[-1] for o in outs}
    assert len(paths) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        ".build.lock", pathlib.Path(paths.pop()).name]


def _data(n=57):
    rng = np.random.default_rng(3)
    return {"x": rng.random((n, 4, 5)).astype(np.float32),
            "w": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop", [True, False])
def test_batch_iterator_matches_jax(shuffle, drop):
    data = _data()
    rng = lambda: np.random.default_rng(11) if shuffle else None
    got = list(tloader.batch_iterator(data, 10, rng(), drop_remainder=drop))
    want = list(jloader.batch_iterator(data, 10, rng(), drop_remainder=drop))
    perm = np.arange(57)
    if shuffle:
        np.random.default_rng(11).shuffle(perm)
    assert len(got) == len(want) == (5 if drop else 6)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == set(data)
        for k in data:
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], data[k][perm[i * 10:(i + 1) * 10]])


def test_device_prefetch_passes_through_on_the_cpu():
    data = _data()
    batches = list(tloader.batch_iterator(data, 10))
    out = list(tloader.device_prefetch(iter(batches), prefetch=2, device="cpu"))
    assert len(out) == len(batches)
    for b, t in zip(batches, out):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in t.values())
        assert t["x"].data_ptr() == b["x"].ctypes.data


def _model(B=20):
    cfg = tcl.Config(original_dim=6, intermediate_dim=8, latent_dim=2, seq_length=4,
                     n_classes=3, use_x_prev=True)
    params = tcl.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(4)
    n = 90
    data = {"x": (rng.random((n, 4, 6)) < 0.3).astype(np.float32),
            "x_prev": (rng.random((n, 4, 6)) < 0.3).astype(np.float32),
            "y": (rng.random((n, 4, 6)) < 0.3).astype(np.float32),
            "w": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]}
    loss = lambda p, b, g, *a: tcl.loss_and_metrics(p, cfg, b, g, *a)
    return Trainer(loss, init_optimizer("adam-wn")[0], batch_size=B), params, data


def test_streamed_epoch_equals_a_train_step_loop():
    trainer, params, data = _model()
    p1, p2 = copy_params(params, True), copy_params(params, True)
    o1, o2 = trainer.init_optimizer(p1), trainer.init_optimizer(p2)
    m1 = trainer.train_epoch_streaming(p1, o1, data, torch.Generator().manual_seed(5), 1.0,
                                       1.0, 1.0, np.random.default_rng(6))
    g2, steps = torch.Generator().manual_seed(5), []
    for b in tloader.batch_iterator(data, 20, np.random.default_rng(6)):
        steps.append(trainer.train_step(p2, o2, {k: torch.from_numpy(v) for k, v in b.items()},
                                        g2, 1.0, 1.0, 1.0))
    assert len(steps) == 4
    m2 = loop._mean(steps)
    assert m1.keys() == m2.keys() and all(torch.equal(m1[k], m2[k]) for k in m1)
    for name, layer in p1.items():
        for leaf, v in layer.items():
            assert torch.equal(v, p2[name][leaf]), (name, leaf)


def test_fit_streaming_and_trace_dir(tmp_path):
    trainer, params, data = _model()
    calls = []
    real = Trainer.train_epoch_streaming
    trainer.train_epoch_streaming = lambda *a, **k: calls.append(a[7]) or real(trainer, *a, **k)
    trace = tmp_path / "trace"
    _, _, hist, _ = fit(trainer, params, data, {k: torch.from_numpy(v) for k, v in data.items()},
                        num_epochs=3, generator=torch.Generator().manual_seed(0), patience=0,
                        verbose=False, streaming=True, stream_seed=7, trace_dir=str(trace))
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    assert len(calls) == 3 and len({id(r) for r in calls}) == 1  # one generator, every epoch
    (f,) = trace.glob("*.pt.trace.json")  # one epoch traced
    events = json.loads(f.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
@pytest.mark.parametrize("flag", ["--streaming", "--trace_dir"])
def test_train_cli_flag(tmp_path, monkeypatch, family, flag):
    cli = cl_vrnn_train if family == "cl_vrnn" else cl_vae_train
    extra = (["--intermediate_dim", "8", "--seq_length", "4", "--batch_size", "1000"]
             if family == "cl_vrnn" else ["--latent_dim", "2", "--batch_size", "500"])
    value = [str(tmp_path / "trace")] if flag == "--trace_dir" else []
    args = cli.build_parser().parse_args(
        ["r", "--device", "cpu", "--train_file", CORPUS, "--num_epochs", "2", "--patience", "0",
         "--model_dir", str(tmp_path), flag, *value, *extra])
    used = []
    for name in ("train_epoch", "train_epoch_streaming"):
        real = getattr(Trainer, name)
        monkeypatch.setattr(Trainer, name, functools.partialmethod(
            lambda self, *a, _n=name, _r=real, **k: used.append(_n) or _r(self, *a, **k)))
    cli.train(args)
    if flag == "--streaming":
        assert used == ["train_epoch_streaming"] * 2
    else:
        assert used == ["train_epoch"] * 2
        assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
