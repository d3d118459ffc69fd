#!/usr/bin/env python3
"""The JAX package's side of ``tools/torch_converged_parity.py``: BASELINE
configs 3 and 5 trained and evaluated by the JAX CLIs on the CPU.

    python3 tools/jax_converged_reference.py --config {3,5} [--work_dir DIR]
        [--seeds 0,1,2,3,4] [--out artifacts/torch_converged_parity.json]
    python3 tools/jax_converged_reference.py --config {3,5} --cross CKPT.npz

Runs each command below as a subprocess with ``JAX_PLATFORMS=cpu`` and
writes the ``jax`` section of ``--out`` (keyed by config, then training
seed), the commands beside their numbers:

- training seeds 1-4 with the JAX train CLI and the recipe of
  ``tools/torch_converged_parity.RECIPES`` (the flags of
  ``examples/reproduce_baselines.sh``), ``--seed N``; seed 0 is the
  committed checkpoint (``artifacts/pm_configs/c3.npz``, ``c5m.npz``);
- each evaluated by ``cli.evaluate`` with 64 importance samples at
  evaluation seeds 0-3 (``--batch_size`` 500 for cl_vae, 200 for cl_vrnn,
  as the shell script evaluates).

``--cross CKPT`` instead evaluates a checkpoint the port trained at
evaluation seeds 0-7 (the cl_vrnn one through ``--lstm_backend xla``: the
JAX Pallas kernels run in interpret mode on the CPU, the same function) and
records it as the config's ``cross_package``. A command whose log is
already in ``--work_dir`` (``c<config>_s<seed>.train.log``,
``c<config>_s<seed>_e<eval seed>.eval.log``, ``c<config>_cross_e<eval
seed>.eval.log``) is not run again. Then ``parity`` is recomputed.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shlex
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_converged_parity as tcp  # noqa: E402

ROOT = tcp.ROOT
COMMITTED = {"3": "artifacts/pm_configs/c3", "5": "artifacts/pm_configs/c5m"}
EVAL_SEEDS, CROSS_SEEDS = (0, 1, 2, 3), tuple(range(8))


def _run(cmd: list, log: Path) -> str:
    """The command's output, from its log when it ran before."""
    if not log.exists():
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{shlex.join(cmd)} exited {out.returncode}:\n{out.stderr[-4000:]}")
        log.write_text(out.stdout)
    return log.read_text()


def _shown(cmd: list, work: Path) -> str:
    return "JAX_PLATFORMS=cpu " + shlex.join(cmd).replace(str(work), "WORK_DIR")


def _evaluate(config, model, seeds, log_stem, work, extra=()):
    """(commands, NLL per evaluation seed) of the JAX ``cli.evaluate``."""
    cmds, nlls = [], {}
    for e in seeds:
        cmd = [sys.executable, "-m", "classifying_vae_lstm_tpu.cli.evaluate", "-i", model,
               "--family", tcp.FAMILY[config], "--n_samples", str(tcp.N_SAMPLES),
               "--batch_size", str(tcp.EVAL_BATCH[config]), "--train_file", tcp.PM_ALL,
               "--seed", str(e), *extra]
        last = _run(cmd, work / f"{log_stem}_e{e}.eval.log").strip().splitlines()[-1]
        nlls[str(e)] = json.loads(last)["test_nll_nats_per_frame"]
        cmds.append(_shown([Path(cmd[0]).name, *cmd[1:]], work))
    return cmds, nlls


def _train_log_fields(text: str) -> dict:
    """Epochs run, s per epoch (median) and the CLI's best-epoch metrics
    from a JAX train CLI's output."""
    secs = [float(s) for s in re.findall(r"^epoch \d+/\d+ .*\(([\d.]+)s\)$", text, re.M)]
    best = ast.literal_eval(text.strip().splitlines()[-1])
    return {"epochs_run": len(secs), "cpu_s_per_epoch_median": statistics.median(secs),
            "best_val_loss": best["val_loss"], "best_val_w_acc": best["val_w_acc"]}


def reference(config: str, seeds, work: Path) -> dict:
    """The ``jax`` entries of ``config`` for training seeds ``seeds``."""
    cli, run, flags, committed_args = tcp.RECIPES[config]
    out = {}
    for s in seeds:
        if s == 0:
            model = COMMITTED[config] + ".npz"
            entry = {"checkpoint": model, "train_command": "the committed checkpoint (seed 0)",
                     "train_args": tcp.recipe_fields(
                         json.loads((ROOT / committed_args).read_text()))}
        else:
            model_dir = work / f"c{config}"
            cmd = [sys.executable, "-m", f"classifying_vae_lstm_tpu.cli.{cli}", f"{run}_s{s}",
                   *flags, "--seed", str(s), "--model_dir", str(model_dir), "--log_dir",
                   str(work / "logs"), "--train_file", tcp.PM_ALL]
            text = _run(cmd, work / f"c{config}_s{s}.train.log")
            model = str(model_dir / f"{run}_s{s}.npz")
            entry = {"train_command": _shown([Path(cmd[0]).name, *cmd[1:]], work),
                     "train_args": tcp.recipe_fields(
                         json.loads((model_dir / f"{run}_s{s}.json").read_text())),
                     **_train_log_fields(text)}
        entry["eval_commands"], entry["eval_nlls"] = _evaluate(
            config, model, EVAL_SEEDS, f"c{config}_s{s}", work)
        entry["nll"] = statistics.fmean(entry["eval_nlls"].values())
        out[str(s)] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=["3", "5"], required=True)
    ap.add_argument("--seeds", default="0,1,2,3,4", help="training seeds")
    ap.add_argument("--work_dir", default=str(ROOT / "build" / "jax_reference"))
    ap.add_argument("--cross", default=None,
                    help="a checkpoint the port trained: evaluate it at seeds 0-7 instead")
    ap.add_argument("--out", default=str(tcp.OUT))
    a = ap.parse_args(argv)
    work = Path(a.work_dir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    out = Path(a.out)
    doc = json.loads(out.read_text()) if out.exists() else {}
    jax = doc.setdefault("jax", {"about": "the JAX package's CLIs on the CPU "
                                          "(JAX_PLATFORMS=cpu); tools/jax_converged_reference.py"})
    section = jax.setdefault(a.config, {})
    if a.cross:
        model = os.path.relpath(Path(a.cross).resolve(), ROOT)
        extra = ("--lstm_backend", "xla") if a.config == "5" else ()
        cmds, nlls = _evaluate(a.config, model, CROSS_SEEDS, f"c{a.config}_cross", work, extra)
        section["cross_package"] = {"checkpoint": model, "eval_commands": cmds,
                                    "eval_nlls": nlls}
    else:
        seeds = [int(s) for s in a.seeds.split(",")]
        section.setdefault("seeds", {}).update(reference(a.config, seeds, work))
    out.write_text(json.dumps(doc, indent=1) + "\n")
    doc = tcp.record(None, out)
    print(json.dumps(doc["parity"].get(a.config, {})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
