"""The port's TensorBoard event files, offline numerics and ``--do_log``
sink vs the JAX package's.

* Event files: each package's reader reads the other's file back to the
  same steps and scalars (f32 ``simple_value``s), the CRC32C of the same
  bytes is the same, and the JSONL -> events converter writes what the JAX
  reader reads.
* ``utils.numerics``: every function equal to the JAX package's on the same
  arrays (the same NumPy code).
* ``cli.common.make_log_fn``: one JSONL line an epoch, and the events the
  JAX reader gets back equal the logged values rounded to f32; both train
  CLIs' ``--do_log`` write them under ``--log_dir``, one line an epoch with
  the epoch's history.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from classifying_vae_lstm_tpu.utils import numerics as jnum
from classifying_vae_lstm_tpu.utils import tb_events as jtb
from classifying_vae_lstm_tpu_torch.cli import cl_vae_train, cl_vrnn_train
from classifying_vae_lstm_tpu_torch.cli import common as tcommon
from classifying_vae_lstm_tpu_torch.utils import numerics as tnum
from classifying_vae_lstm_tpu_torch.utils import tb_events as ttb

SCALARS = [(0, {"loss": 3.25, "val_loss": 2.5}), (1, {"loss": 1.0 / 3, "w_acc": 0.875}),
           (7, {"loss": -0.125})]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("writer,reader", [(ttb, jtb), (jtb, ttb)],
                         ids=["port_written_jax_read", "jax_written_port_read"])
def test_each_reader_reads_the_other_file(tmp_path, writer, reader):
    w = writer.ScalarEventWriter(str(tmp_path))
    for step, scalars in SCALARS:
        w.add_scalars(step, scalars)
    w.close()
    got = reader.read_scalar_events(w.path)
    want = [(s, {k: float(np.float32(v)) for k, v in d.items()}) for s, d in SCALARS]
    assert got == want
    assert ttb.read_scalar_events(w.path) == jtb.read_scalar_events(w.path)


def test_crc_and_converter_match_jax(tmp_path):
    for data in (b"", b"123456789", bytes(range(256)) * 3):
        assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    jsonl = tmp_path / "run.jsonl"
    jsonl.write_text("".join(json.dumps({"epoch": s, **d}) + "\n" for s, d in SCALARS))
    path = ttb.jsonl_to_tb(str(jsonl), str(tmp_path / "tb"))
    assert jtb.read_scalar_events(path) == jtb.read_scalar_events(
        jtb.jsonl_to_tb(str(jsonl), str(tmp_path / "tb_jax")))


@pytest.mark.parametrize("name", ["bincrossentropy", "logmeanexp", "logsumexp", "LL_frame"])
def test_numerics_match_jax(name):
    rng = np.random.default_rng(0)
    y = (rng.random((5, 6, 88)) < 0.2).astype(np.float32)
    p = rng.random((5, 6, 88)).astype(np.float32)
    args = (y, p) if name in ("bincrossentropy", "LL_frame") else (rng.normal(size=(7, 5)) * 30,)
    for axis in ((0, 1) if len(args) == 1 else (None,)):
        kw = {} if axis is None else {"axis": axis}
        np.testing.assert_array_equal(getattr(tnum, name)(*args, **kw),
                                      getattr(jnum, name)(*args, **kw))


def test_make_log_fn_writes_jsonl_and_events(tmp_path):
    args = argparse.Namespace(log_dir=str(tmp_path / "logs"), run_name="r")
    log_fn = tcommon.make_log_fn(args)
    logs = [{"loss": 60.123456789, "val_loss": 58.5, "w_acc": 0.25},
            {"loss": 55.0, "val_loss": 52.75, "w_acc": 0.5}]
    for epoch, d in enumerate(logs):
        log_fn(epoch, d)
    lines = (tmp_path / "logs" / "r.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == [{"epoch": e, **d} for e, d in enumerate(logs)]
    (events,) = (tmp_path / "logs" / "r").glob("events.out.tfevents.*")
    assert jtb.read_scalar_events(str(events)) == [
        (e, {k: float(np.float32(v)) for k, v in d.items()}) for e, d in enumerate(logs)]


@pytest.mark.parametrize("family", ["cl_vrnn", "cl_vae"])
def test_do_log_flag_writes_one_line_an_epoch(tmp_path, monkeypatch, family):
    cli = cl_vrnn_train if family == "cl_vrnn" else cl_vae_train
    extra = (["--intermediate_dim", "8", "--seq_length", "4", "--batch_size", "1000"]
             if family == "cl_vrnn" else ["--latent_dim", "2", "--batch_size", "500"])
    args = cli.build_parser().parse_args(
        ["r", "--device", "cpu", "--train_file", "data/input/Piano-midi_Cs.pickle",
         "--num_epochs", "2", "--patience", "0", "--model_dir", str(tmp_path), "--do_log",
         "--log_dir", str(tmp_path / "logs"), *extra])
    out, real = [], cli.fit
    monkeypatch.setattr(cli, "fit", lambda *a, **k: out.append(real(*a, **k)) or out[-1])
    cli.train(args)
    history = out[0][2]
    lines = [json.loads(x) for x in (tmp_path / "logs" / "r.jsonl").read_text().splitlines()]
    assert [d.pop("epoch") for d in lines] == [0, 1]
    assert {k: [d[k] for d in lines] for k in lines[0]} == history
    (events,) = (tmp_path / "logs" / "r").glob("events.out.tfevents.*")
    assert [step for step, _ in ttb.read_scalar_events(str(events))] == [0, 1]
