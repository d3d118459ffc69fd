"""``tools/torch_converged_parity.py``: BASELINE configs 3 and 5 through the
port, against the JAX package's recipe and record.

* The tool's recipes are the training fields of the committed JAX
  checkpoints (``artifacts/pm_configs/c3.json``, ``c5m.json``), parsed by
  both packages' train CLIs, and the flags of
  ``examples/reproduce_baselines.sh``, parsed from the script.
* Configs 1, 2 and 4 raise, naming the JSB pickle the repository lacks.
* One ``--device cpu`` run of config 5 on a small corpus trains, evaluates
  and samples, and writes an entry with every field; the best-epoch rules
  it reports are the JAX package's.
* ``artifacts/torch_converged_parity.json``: five JAX seeds a config, seed 0
  the committed checkpoint; the port's pallas entries went through the
  kernels, and ``parity`` is what the entries give.
"""

import importlib
import json
import math
import pickle
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import torch_converged_parity as tcp  # noqa: E402

ARTIFACT = ROOT / "artifacts" / "torch_converged_parity.json"
ENTRY_FIELDS = {"config", "route", "seed", "card", "train_command", "recipe", "epochs_run",
                "best_epoch", "checkpoint_epoch", "best_val_loss", "best_val_w_acc",
                "s_per_epoch_median", "wall_s", "eval_nlls", "nll", "launches", "samples",
                "plain_on_cuda"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runs beside other workers' processes,
    and torch's default of one thread a core would oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script_flags(cli: str, run: str) -> list:
    """The flags of ``examples/reproduce_baselines.sh``'s ``<cli> <run>``
    command, up to ``--model_dir``."""
    text = (ROOT / "examples" / "reproduce_baselines.sh").read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if f"cli.{cli} {run} " in ln)
    words = shlex.split(line)
    words = words[words.index(run) + 1:]
    return words[:words.index("--model_dir")]


@pytest.mark.parametrize("config", ["3", "5"])
def test_recipe_is_the_committed_checkpoints_and_the_scripts(config):
    cli, run, flags, committed = tcp.RECIPES[config]
    assert flags == _script_flags(cli, run)
    want = tcp.recipe_fields(json.loads((ROOT / committed).read_text()))
    argv = tcp.train_argv(config, "pallas", None, 0, tcp.PM_ALL, "unused", "cpu")
    assert argv[0] == run and argv[-2:] == ["--device", "cpu"]
    # both packages' train CLIs read the argv as the committed run's recipe
    # (the JAX CLIs have no --device)
    for package, words in (("classifying_vae_lstm_tpu_torch", argv),
                           ("classifying_vae_lstm_tpu", argv[:-2])):
        parser = importlib.import_module(f"{package}.cli.{cli}").build_parser()
        args = vars(parser.parse_args(words))
        assert {k: args[k] for k in want} == want, package
    # the routes: the f32 kernels, or plain PyTorch
    assert tcp.ROUTES[config]["xla"][1] == "xla"
    assert "pallas" in tcp.ROUTES[config]["pallas"]


@pytest.mark.parametrize("config,pickle_name", [("1", "JSB Chorales_Cs.pickle"),
                                                ("2", "JSB Chorales_all.pickle"),
                                                ("4", "JSB Chorales_all.pickle")])
def test_jsb_configs_name_the_missing_pickle(config, pickle_name):
    assert not (ROOT / "data" / "input" / pickle_name).exists()
    with pytest.raises(FileNotFoundError, match=pickle_name):
        tcp.run(config, 0, device="cpu")
    with pytest.raises(SystemExit):  # argparse refuses what is not a BASELINE config
        tcp.main(["--config", "6"])


def _corpus(path):
    """A small three-key corpus in the pickle schema: 4 + 4 songs of 80
    frames (one batch of 200 windows each at T=16) and one test song of 72
    (eight 64-frame windows to seed six songs)."""
    rng = np.random.default_rng(0)
    keys = ["C", "G", "F"]
    d = {}
    for split, n, frames in (("train", 4, 80), ("valid", 4, 80), ("test", 1, 72)):
        ks = [keys[i % 3] for i in range(n)]
        d[split] = [[sorted({int(48 + 2 * keys.index(k) + rng.choice([0, 4, 7, 12]))
                             for _ in range(2)}) for _ in range(frames)] for k in ks]
        d[f"{split}_key"], d[f"{split}_mode"] = ks, [True] * n
    with open(path, "wb") as f:
        pickle.dump(d, f)
    return str(path)


def test_cpu_run_trains_evaluates_samples_and_records(tmp_path):
    from classifying_vae_lstm_tpu.train.callbacks import CheckpointPolicy

    corpus = _corpus(tmp_path / "tiny.pickle")
    with pytest.raises(ValueError, match="writes no checkpoint"):
        tcp.run("5", 0, epochs=6, device="cpu", train_file=corpus)
    # two evaluation seeds of the four a card run takes: each is a full
    # 64-sample pass over 12,800 padded rows on one CPU thread
    entry = tcp.run("5", 3, "pallas", 7, "cpu", corpus, str(tmp_path / "work"), (0, 2))
    assert ENTRY_FIELDS <= set(entry)
    assert (entry["config"], entry["route"], entry["seed"], entry["card"]) == ("5", "pallas", 3,
                                                                               "cpu")
    assert entry["resolved"]["two_cell"] is True and entry["recipe"]["num_epochs"] == 7
    assert "--seed 3" in entry["train_command"] and "--two_cell auto" in entry["train_command"]
    assert entry["epochs_run"] == 7 and len(entry["s_per_epoch"]) == 7
    # the checkpoint holds the epoch JAX's CheckpointPolicy saves last (from
    # index max(anneals) + 1 = 6); the CLI's best epoch counts from index
    # min(anneals) = 3, as the JAX CLIs count it
    val = entry["val_loss_per_epoch"]
    policy = CheckpointPolicy(min_epoch=6)
    saved = [i for i, v in enumerate(val) if policy.should_save(i, v)]
    assert entry["checkpoint_epoch"] == saved[-1] + 1 == 7
    assert entry["best_epoch"] == int(np.argmin(val[3:])) + 4
    assert sorted(entry["eval_nlls"]) == ["0", "2"]
    assert entry["nll"] == pytest.approx(np.mean(list(entry["eval_nlls"].values())))
    assert all(math.isfinite(v) and v > 0 for v in entry["eval_nlls"].values())
    songs = entry["samples"]["c5"]["songs"]
    assert entry["samples"]["c5"]["ok"] and len(songs) == 6
    assert all(s["frames"] > 0 and s["notes"] > 0 and s["wav_nonzero"] > 0 for s in songs)
    assert (tmp_path / "work" / "c5m.npz").exists()
    assert set(entry["launches"]) == {"train", "evaluate", "sample"}
    assert entry["plain_on_cuda"] == []  # CPU tensors only: the plain versions
    out = tmp_path / "parity.json"
    doc = tcp.record(entry, out)
    assert doc["torch"]["5"]["pallas"]["3"]["nll"] == entry["nll"]
    assert doc["parity"]["5"]["pallas"]["seeds"] == [3]
    again = tcp.record(None, tmp_path / "merged.json", merge_from=out)
    assert again["torch"] == json.loads(out.read_text())["torch"]


def test_parity_summary_welch_and_cross_package():
    doc = {"jax": {"5": {"seeds": {str(s): {"nll": v} for s, v in enumerate([6.4, 6.2, 6.3])},
                         "cross_package": {"eval_nlls": {"0": 6.30, "1": 6.32}}}},
           "torch": {"5": {"pallas": {str(s): {"nll": v, "eval_nlls": {"0": 6.305, "1": 6.321}}
                                      for s, v in enumerate([6.25, 6.35, 6.3])},
                           "xla": {"1": {"nll": 6.36}}}}}
    row = tcp.summarize(doc)["5"]
    # the one-seed control is held against the kernels' run of its seed
    assert row["xla"]["diff_to_pallas_same_seeds"] == pytest.approx(0.01)
    assert "within_limit" not in row["xla"] and row["xla"]["diff"] == pytest.approx(0.06)
    assert row["jax_mean"] == pytest.approx(6.3) and row["pallas"]["mean"] == pytest.approx(6.3)
    assert row["pallas"]["within_limit"] and row["pallas"]["welch_t"] == pytest.approx(0.0)
    assert row["pallas"]["spread"] == pytest.approx(0.1)
    assert row["cross_package"]["diff"] == pytest.approx(0.003)
    assert row["cross_package"]["within_limit"]


@pytest.mark.parametrize("config", ["3", "5"])
def test_committed_record(config):
    doc = json.loads(ARTIFACT.read_text())
    seeds = doc["jax"][config]["seeds"]
    assert sorted(seeds, key=int) == ["0", "1", "2", "3", "4"]
    committed = tcp.recipe_fields(json.loads((ROOT / tcp.RECIPES[config][3]).read_text()))
    assert seeds["0"]["train_args"] == committed
    assert seeds["0"]["checkpoint"] == tcp.RECIPES[config][3].replace(".json", ".npz")
    for s, e in seeds.items():
        assert {k: v for k, v in e["train_args"].items() if k != "seed"} == committed
        assert sorted(e["eval_nlls"], key=int) == ["0", "1", "2", "3"]
        assert e["nll"] == pytest.approx(np.mean(list(e["eval_nlls"].values())))
    pallas = doc["torch"][config]["pallas"]
    assert sorted(pallas, key=int) == ["0", "1", "2", "3", "4"]
    for e in pallas.values():
        assert e["device"] == "cuda" and e["recipe"] == committed and not e["plain_on_cuda"]
        assert e["resolved"] == ({"train_backend": "pallas"} if config == "3" else
                                 {"lstm_backend": "pallas", "two_cell": True,
                                  "fusion": [True, True, True]})
        for stage, needed in tcp.NEEDED[config].items():
            assert all(e["launches"][stage].get(f"{m}.{k}", 0) > 0 for m, k in needed), stage
        assert all(s["ok"] for s in e["samples"].values())
    assert "0" in doc["torch"][config]["xla"]
    assert doc["parity"] == tcp.summarize(doc)
