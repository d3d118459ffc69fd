#!/usr/bin/env python3
"""BASELINE configs 3 and 5 trained to their epoch budgets through the port,
evaluated and sampled, one training seed a call.

    python3 tools/torch_converged_parity.py --config {3,5} --seed N
        [--route pallas|xla] [--epochs E] [--device cuda|cpu]
        [--eval_seeds 0,1,2,3] [--train_file PICKLE] [--work_dir DIR]
        [--out artifacts/torch_converged_parity.json]
    python3 tools/torch_converged_parity.py --merge FILE [--out ...]

The port's counterpart of ``examples/reproduce_baselines.sh`` (configs 3
and 5) with ``tools/run_oracle_parity.py``'s converged evidence. It runs
the port's CLIs in this process:

1. **train** with the recipe of the committed JAX checkpoint
   (``artifacts/pm_configs/c3.json``, ``c5m.json``; the shell script's
   flags): config 3 ``cl_vae_train`` (latent 4, x_prev, 60 epochs, batch
   100), config 5 ``cl_vrnn_train`` (x_prev, 80 epochs, B=200, T=16, H=88,
   latent 2), both with ``--kl_anneal 5 --w_kl_anneal 3 --patience 10``.
   Route ``pallas`` trains config 3 through the f32 dense-stack kernels
   (``--train_backend pallas``, ``csrc/vae_dense.cu``) and config 5 through
   the f32 two-cell kernels (``--lstm_backend pallas --two_cell auto``,
   ``csrc/two_cell.cu``, ``csrc/two_cell_tc.cu``); route ``xla`` is the
   plain PyTorch control;
2. **evaluate** the best-epoch checkpoint with ``cli.evaluate`` (64
   importance samples) at each evaluation seed; a cl_vrnn checkpoint of
   the pallas route goes through the f32 inference forward
   (``csrc/lstm_seq.cu``);
3. **sample** as the shell script does, through the generation kernels:
   config 3 ``cl_vae_sample`` with ``--infer_w`` and without (``-n 2 -t
   64``), config 5 ``cl_vrnn_sample --infer_w --write_wav -n 6 -t 64``; every
   MIDI file is read back and must hold notes, every WAV file sound;
4. **record** one entry, keyed by config, route and seed, in ``--out``:
   epochs run, the CLI's best epoch and the epoch whose weights the
   checkpoint holds, s per epoch (median) and wall s, val_loss and val
   w_acc, the NLL of each evaluation seed and their mean over seeds 0-3,
   each kernel's launch count per stage, and the card's name and power
   limit. The ``jax`` section of the file (the JAX package's seeds 0-4, and
   its evaluation of the port's seed-0 checkpoints) is read, never made,
   here: ``tools/jax_converged_reference.py`` writes it. ``parity`` is
   recomputed on every write: the two means, their difference against the
   0.1 nats/frame limit and Welch's t.

On the card, every stage's launch counts are set to 0 just before it and
read just after; the pallas route fails unless its kernels launched, and
any route fails if a kernel's plain version ran on a CUDA tensor. Configs 1,
2 and 4 train on the JSB Chorales pickles, which the repository does not
hold; the tool refuses them, naming the file. ``--epochs`` shortens a run
(at least 7: the best-epoch save starts at epoch max(kl_anneal,
w_kl_anneal) + 2, so a shorter run writes no checkpoint). ``--merge FILE``
adds another file's port entries to ``--out``. Imports torch and the port,
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "artifacts" / "torch_converged_parity.json"
PM_ALL = "data/input/Piano-midi_all.pickle"
JSB = {"1": "data/input/JSB Chorales_Cs.pickle", "2": "data/input/JSB Chorales_all.pickle",
       "4": "data/input/JSB Chorales_all.pickle"}
ANNEALS = ["--kl_anneal", "5", "--w_kl_anneal", "3", "--patience", "10"]
# config -> (train CLI, run name, flags of examples/reproduce_baselines.sh,
# the committed JAX checkpoint's args.json)
RECIPES = {
    "3": ("cl_vae_train", "c3", ["--latent_dim", "4", "--use_x_prev", "--num_epochs", "60",
                                 *ANNEALS], "artifacts/pm_configs/c3.json"),
    "5": ("cl_vrnn_train", "c5m", ["--use_x_prev", "--num_epochs", "80", *ANNEALS],
          "artifacts/pm_configs/c5m.json"),
}
ROUTES = {
    "3": {"pallas": ["--train_backend", "pallas"], "xla": ["--train_backend", "xla"]},
    "5": {"pallas": ["--lstm_backend", "pallas", "--two_cell", "auto"],
          "xla": ["--lstm_backend", "xla"]},
}
FAMILY = {"3": "cl_vae", "5": "cl_vrnn"}
EVAL_BATCH = {"3": 500, "5": 200}  # the shell script's evaluate --batch_size
# config -> [(sample CLI, run name, flags)], as the shell script samples
SAMPLES = {
    "3": [("cl_vae_sample", "c3_infer", ["-n", "2", "-t", "64", "--infer_w"]),
          ("cl_vae_sample", "c3_true", ["-n", "2", "-t", "64"])],
    "5": [("cl_vrnn_sample", "c5", ["-n", "6", "-t", "64", "--infer_w", "--write_wav"])],
}
# the kernels each stage of the pallas route must launch on the card:
# (module of ops/, count)
NEEDED = {
    "3": {"train": [("vae_dense", "FWD_LAUNCHES"), ("vae_dense", "BWD_LAUNCHES")],
          "sample": [("cuda_generate_vae", "LAUNCHES")]},
    "5": {"train": [("two_cell", "FWD_LAUNCHES"), ("two_cell", "BWD_LAUNCHES")],
          "evaluate": [("lstm_seq", "FWD_LAUNCHES")],
          "sample": [("cuda_generate", "LAUNCHES")]},
}
# the kernel sources each config's path runs, built together before it starts
SOURCES = {"3": ["vae_dense", "generate_cl_vae"],
           "5": ["two_cell", "two_cell_tc", "lstm_seq", "generate_cl_vrnn"]}
COUNTED = ("two_cell", "lstm_seq", "vae_dense", "cuda_generate", "cuda_generate_vae")
N_SAMPLES, PARITY_EVAL_SEEDS, LIMIT, CROSS_LIMIT = 64, (0, 1, 2, 3), 0.1, 0.01
# fields of a run's args.json that are not its training recipe
NOT_RECIPE = {"run_name", "model_dir", "log_dir", "train_file", "seed", "n_classes", "resume",
              "save_last", "trace_dir", "check_numerics", "streaming", "do_log", "dp",
              "device", "lstm_backend", "two_cell", "fusion", "train_backend", "bf16_compute"}


def recipe_fields(margs: dict) -> dict:
    """The training recipe of a run's args.json (every field but where it
    ran, what it wrote and how the route was resolved)."""
    return {k: v for k, v in margs.items() if k not in NOT_RECIPE}


def train_file_for(config: str, train_file: str | None = None) -> str:
    """The corpus of ``config``; raises for configs 1, 2 and 4, whose JSB
    pickle the repository does not hold."""
    if config in JSB:
        path = JSB[config]
        if not (ROOT / path).exists():
            raise FileNotFoundError(
                f"config {config} trains on {path!r}, which is not in the repository; it "
                "runs once that file is committed there")
        raise ValueError(f"config {config}: only configs 3 and 5 have a recipe here")
    if config not in RECIPES:
        raise ValueError(f"unknown config {config!r} (BASELINE configs are 1-5)")
    if train_file:
        return train_file
    # relative from the checkout's root, so args.json names no machine's path
    return PM_ALL if Path.cwd().resolve() == ROOT else str(ROOT / PM_ALL)


def train_argv(config: str, route: str, epochs: int | None, seed: int, train_file: str,
               model_dir: str, device: str) -> list:
    """The train CLI's argv for one run."""
    _, run, flags, _ = RECIPES[config]
    flags = list(flags)
    if epochs is not None:
        i = flags.index("--num_epochs")
        flags[i + 1] = str(epochs)
    return [run, *flags, *ROUTES[config][route], "--seed", str(seed), "--train_file",
            train_file, "--model_dir", model_dir, "--log_dir", model_dir, "--device", device]


def _modules():
    import importlib

    return {m: importlib.import_module(f"classifying_vae_lstm_tpu_torch.ops.{m}")
            for m in COUNTED}


def _reset_counts(mods):
    for mod in mods.values():
        for k in vars(mod):
            if k.endswith("LAUNCHES") and isinstance(getattr(mod, k), int):
                setattr(mod, k, 0)


def _read_counts(mods) -> dict:
    return {f"{m}.{k}": v for m, mod in mods.items() for k, v in sorted(vars(mod).items())
            if k.endswith("LAUNCHES") and isinstance(v, int) and v}


@contextlib.contextmanager
def _plain_guard(mods, record):
    """Record every call of a kernel's plain version (``*_plain`` of
    ``ops/``) whose first tensor argument lies on the card."""
    import torch

    real = {(m, n): getattr(mod, n) for m, mod in mods.items() for n in vars(mod)
            if n.endswith("_plain") and callable(getattr(mod, n))}

    def guard(key):
        def guarded(*a, **k):
            first = next((v for v in (*a, *k.values()) if torch.is_tensor(v)), None)
            if first is not None and first.is_cuda:
                record.append(".".join(key))
            return real[key](*a, **k)
        return guarded

    for (m, n) in real:
        setattr(mods[m], n, guard((m, n)))
    try:
        yield
    finally:
        for (m, n), fn in real.items():
            setattr(mods[m], n, fn)


@contextlib.contextmanager
def _stage(name, mods, launches):
    """A stage's launch counts: set to 0 just before, read just after."""
    _reset_counts(mods)
    try:
        yield
    finally:
        launches[name] = _read_counts(mods)


def _train(cli, argv, sync):
    """One run of a train CLI; returns (history, per-epoch seconds: each
    training pass and its validation pass, the card synchronised, the parsed
    args)."""
    from classifying_vae_lstm_tpu_torch.train import loop

    seen, starts, epoch_s = {}, [], []
    real_fit, real_train, real_eval = cli.fit, loop.Trainer.train_epoch, loop.Trainer.eval_epoch

    def fit(*a, **k):
        out = real_fit(*a, **k)
        seen["history"] = out[2]
        return out

    def train_epoch(self, *a, **k):
        sync()
        starts.append(time.perf_counter())
        return real_train(self, *a, **k)

    def eval_epoch(self, *a, **k):
        m = real_eval(self, *a, **k)
        sync()
        epoch_s.append(time.perf_counter() - starts[-1])
        return m

    args = cli.build_parser().parse_args(argv)
    cli.fit, loop.Trainer.train_epoch, loop.Trainer.eval_epoch = fit, train_epoch, eval_epoch
    try:
        cli.train(args)
    finally:
        cli.fit, loop.Trainer.train_epoch, loop.Trainer.eval_epoch = (real_fit, real_train,
                                                                     real_eval)
    return seen["history"], epoch_s, args


def _epochs(history: dict, min_epoch_cb: int, min_epoch_best: int) -> tuple:
    """(the CLI's best epoch, the epoch whose weights the checkpoint holds),
    1-based: the CLI reports the lowest val_loss from epoch index
    ``min_epoch_best`` on, and its CheckpointPolicy saves each new lowest
    from ``min_epoch_cb`` on (the reference's rules, kept in both
    packages)."""
    from classifying_vae_lstm_tpu_torch.train.callbacks import CheckpointPolicy

    val = history["val_loss"]
    best = min(range(min_epoch_best, len(val)), key=val.__getitem__, default=0)
    policy, saved = CheckpointPolicy(min_epoch=min_epoch_cb), None
    for i, v in enumerate(val):
        if policy.should_save(i, v):
            saved = i
    return best + 1, None if saved is None else saved + 1


def _read_back(sample_dir, run, n, wav) -> dict:
    """Each song ``<run>_<i>.mid`` read back: its frames and notes; with
    ``wav``, the frames and nonzero samples of ``<run>_<i>.wav``."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.data.midi import read_midi_roll

    songs = []
    for i in range(n):
        roll = read_midi_roll(os.path.join(sample_dir, f"{run}_{i}.mid"))
        song = {"frames": int(roll.shape[0]), "notes": int(roll.sum())}
        if wav:
            with wave.open(os.path.join(sample_dir, f"{run}_{i}.wav")) as f:
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            song.update(wav_frames=int(pcm.size), wav_nonzero=int(np.count_nonzero(pcm)))
        songs.append(song)
    return {"songs": songs, "ok": all(s["notes"] > 0 and s.get("wav_nonzero", 1) > 0
                                      for s in songs)}


def _shown(path: str) -> str:
    """``path`` relative to the checkout where it lies inside it."""
    return path[len(str(ROOT)) + 1:] if path.startswith(str(ROOT) + os.sep) else path


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "no nvidia-smi"
    except (FileNotFoundError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def run(config: str, seed: int, route: str = "pallas", epochs: int | None = None,
        device: str = "cuda", train_file: str | None = None, work_dir: str | None = None,
        eval_seeds=PARITY_EVAL_SEEDS) -> dict:
    """Train, evaluate and sample one seed of ``config`` on ``route``;
    returns the entry :func:`record` writes. The checkpoint triple and the
    samples stay in ``work_dir`` when one is given."""
    import importlib

    import torch

    from classifying_vae_lstm_tpu_torch import resolve_device
    from classifying_vae_lstm_tpu_torch.cli import evaluate
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    config = str(config)
    train_file = train_file_for(config, train_file)
    if route not in ROUTES[config]:
        raise ValueError(f"route {route!r}: pallas or xla")
    if epochs is not None and epochs < 7:
        raise ValueError(f"--epochs {epochs}: the best-epoch save starts at epoch 7 "
                         "(max(kl_anneal, w_kl_anneal) + 2), so a shorter run writes no "
                         "checkpoint")
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    if dev.type == "cuda":
        from classifying_vae_lstm_tpu_torch.ops import _build

        _build.build_all(names=SOURCES[config])
    build_s, t_start = time.perf_counter() - t_start, time.perf_counter()
    keep = work_dir is not None
    work_dir = work_dir or tempfile.mkdtemp(prefix="converged_")
    os.makedirs(work_dir, exist_ok=True)
    mods, launches, plain_on_cuda = _modules(), {}, []
    cli_name, run_name, _, _ = RECIPES[config]
    try:
        with _plain_guard(mods, plain_on_cuda):
            argv = train_argv(config, route, epochs, seed, train_file, work_dir, device)
            cli = importlib.import_module(f"classifying_vae_lstm_tpu_torch.cli.{cli_name}")
            with _stage("train", mods, launches):
                t0 = time.perf_counter()
                history, epoch_s, args = _train(cli, argv, sync)
                train_s = time.perf_counter() - t0
            ckpt = os.path.join(work_dir, f"{run_name}.npz")
            margs = load_model_args(ckpt)
            best, saved = _epochs(history, max(args.kl_anneal, args.w_kl_anneal) + 1,
                                  min(args.kl_anneal, args.w_kl_anneal))
            nlls, n_test = {}, None
            with _stage("evaluate", mods, launches):
                for e in eval_seeds:
                    out = evaluate.evaluate(evaluate.build_parser().parse_args([
                        "-i", ckpt, "--family", FAMILY[config], "--n_samples", str(N_SAMPLES),
                        "--batch_size", str(EVAL_BATCH[config]), "--train_file", train_file,
                        "--seed", str(e), "--device", device]))
                    nlls[str(e)], n_test = out["test_nll_nats_per_frame"], out["n_test_examples"]
            sample_dir, samples = os.path.join(work_dir, "samples"), {}
            with _stage("sample", mods, launches):
                for s_cli, s_run, flags in SAMPLES[config]:
                    mod = importlib.import_module(f"classifying_vae_lstm_tpu_torch.cli.{s_cli}")
                    mod.sample(mod.build_parser().parse_args([
                        s_run, "-i", ckpt, *flags, "--sample_dir", sample_dir,
                        "--train_file", train_file, "--device", device]))
                    samples[s_run] = _read_back(sample_dir, s_run, int(flags[1]),
                                                "--write_wav" in flags)
        sync()
    finally:
        if not keep:
            shutil.rmtree(work_dir, ignore_errors=True)
    b, c = best - 1, (saved or 1) - 1
    hist = lambda k, i: history.get(k, [None])[i]  # noqa: E731
    parity_nlls = [nlls[str(e)] for e in PARITY_EVAL_SEEDS if str(e) in nlls]
    entry = {
        "config": config, "route": route, "seed": seed, "device": dev.type,
        "card": card_line() if dev.type == "cuda" else "cpu",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "train_file": _shown(train_file),
        "train_command": " ".join([cli_name, *(_shown(a).replace(work_dir, "WORK_DIR")
                                               for a in argv)]),
        "recipe": recipe_fields(margs),
        "resolved": {k: margs[k] for k in ("lstm_backend", "two_cell", "fusion",
                                           "train_backend") if k in margs},
        "epochs_run": len(history["val_loss"]), "best_epoch": best,
        "checkpoint_epoch": saved,
        "best_val_loss": hist("val_loss", b), "best_val_w_acc": hist("val_w_acc", b),
        "checkpoint_val_loss": hist("val_loss", c), "checkpoint_val_w_acc": hist("val_w_acc", c),
        "val_loss_per_epoch": history["val_loss"],
        "s_per_epoch_median": statistics.median(epoch_s), "s_per_epoch": epoch_s,
        "train_s": train_s, "wall_s": time.perf_counter() - t_start, "build_s": build_s,
        "n_samples": N_SAMPLES, "n_test_examples": n_test, "eval_nlls": nlls,
        "nll": statistics.fmean(parity_nlls) if parity_nlls else None,
        "samples": samples, "launches": launches, "plain_on_cuda": plain_on_cuda,
    }
    _check(entry)
    return entry


def _check(entry):
    """Fails the run where a stage's output or its kernels are missing."""
    bad = []
    if not all(math.isfinite(v) for v in entry["eval_nlls"].values()):
        bad.append(f"non-finite NLL {entry['eval_nlls']}")
    bad += [f"{run}: a song without notes or sound {s['songs']}"
            for run, s in entry["samples"].items() if not s["ok"]]
    if entry["plain_on_cuda"]:
        bad.append(f"plain versions ran on CUDA tensors: {sorted(set(entry['plain_on_cuda']))}")
    if entry["device"] == "cuda" and entry["route"] == "pallas":
        for stage, needed in NEEDED[entry["config"]].items():
            bad += [f"{stage}: {m}.{k} was not launched"
                    for m, k in needed if not entry["launches"][stage].get(f"{m}.{k}")]
    if bad:
        raise RuntimeError("; ".join(bad))


def _welch(a, b) -> float | None:
    """Welch's t of the means of samples ``a`` and ``b``."""
    if len(a) < 2 or len(b) < 2:
        return None
    se = math.sqrt(statistics.variance(a) / len(a) + statistics.variance(b) / len(b))
    return (statistics.fmean(a) - statistics.fmean(b)) / se if se else None


def summarize(doc: dict) -> dict:
    """``parity`` of the file: per config, the port's mean over its pallas
    seeds against the JAX package's over its seeds (each seed's NLL the mean
    of evaluation seeds 0-3), the difference against the 0.1 limit and
    Welch's t; the xla control beside it, against the pallas runs of the
    same seeds; and the JAX CLI's evaluation of the port's seed-0
    checkpoint against the card's over seeds 0-7 (limit 0.01)."""
    out = {}
    for config, routes in sorted(doc.get("torch", {}).items()):
        jax_seeds = doc.get("jax", {}).get(config, {}).get("seeds", {})
        j = [s["nll"] for _, s in sorted(jax_seeds.items(), key=lambda kv: int(kv[0]))]
        row = {"jax_seeds": len(j), "jax_nlls": j,
               "jax_mean": statistics.fmean(j) if j else None}
        for route, seeds in sorted(routes.items()):
            t = [e["nll"] for _, e in sorted(seeds.items(), key=lambda kv: int(kv[0]))]
            row[route] = {"seeds": sorted(int(s) for s in seeds), "nlls": t,
                          "mean": statistics.fmean(t),
                          "spread": max(t) - min(t)}
            if j:
                row[route]["diff"] = row[route]["mean"] - row["jax_mean"]
            if route == "pallas" and j:  # the route the limit judges
                row[route].update(welch_t=_welch(t, j),
                                  within_limit=abs(row[route]["diff"]) <= LIMIT)
            elif route != "pallas":  # a control: against the kernels on its own seeds
                pallas = routes.get("pallas", {})
                pairs = [seeds[k]["nll"] - pallas[k]["nll"] for k in seeds if k in pallas]
                if pairs:
                    row[route]["diff_to_pallas_same_seeds"] = statistics.fmean(pairs)
        cross = doc.get("jax", {}).get(config, {}).get("cross_package")
        card = routes.get("pallas", {}).get("0", {}).get("eval_nlls", {})
        if cross and card:
            seeds = sorted(cross["eval_nlls"], key=int)
            if all(s in card for s in seeds):
                jm = statistics.fmean(cross["eval_nlls"][s] for s in seeds)
                tm = statistics.fmean(card[s] for s in seeds)
                row["cross_package"] = {"eval_seeds": [int(s) for s in seeds],
                                        "jax_cpu_mean": jm, "torch_card_mean": tm,
                                        "diff": tm - jm, "within_limit": abs(tm - jm) <= CROSS_LIMIT}
        out[config] = row
    return out


def record(entry: dict | None, out=OUT, merge_from=None) -> dict:
    """Write ``entry`` (and every port entry of the file ``merge_from``)
    into the JSON file ``out``, then recompute its ``parity``."""
    out = Path(out)
    doc = json.loads(out.read_text()) if out.exists() else {}
    doc.setdefault("about", "BASELINE configs 3 and 5 trained to their epoch budgets: the "
                   "port (tools/torch_converged_parity.py) against the JAX package "
                   "(tools/jax_converged_reference.py); NLL in nats/frame, IW with 64 samples")
    entries = [entry] if entry else []
    if merge_from:
        other = json.loads(Path(merge_from).read_text()).get("torch", {})
        entries += [e for routes in other.values() for seeds in routes.values()
                    for e in seeds.values()]
    for e in entries:
        doc.setdefault("torch", {}).setdefault(e["config"], {}).setdefault(
            e["route"], {})[str(e["seed"])] = e
    doc["parity"] = summarize(doc)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=["1", "2", "3", "4", "5"])
    ap.add_argument("--seed", type=int, default=0, help="the training seed")
    ap.add_argument("--route", choices=["pallas", "xla"], default="pallas")
    ap.add_argument("--epochs", type=int, default=None,
                    help="shorten the run (at least 7); default: the recipe's budget")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--eval_seeds", default="0,1,2,3",
                    help="comma-separated evaluation seeds (the NLL is the mean over 0-3)")
    ap.add_argument("--train_file", default=None, help=f"default: {PM_ALL}")
    ap.add_argument("--work_dir", default=None,
                    help="keep the checkpoint triple and the samples here")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--merge", default=None, help="add this file's port entries to --out")
    a = ap.parse_args(argv)
    if a.merge:
        doc = record(None, a.out, a.merge)
    else:
        if a.config is None:
            ap.error("--config is required")
        entry = run(a.config, a.seed, a.route, a.epochs, a.device, a.train_file, a.work_dir,
                    tuple(int(s) for s in a.eval_seeds.split(",")))
        print(json.dumps({k: entry[k] for k in (
            "config", "route", "seed", "card", "epochs_run", "best_epoch", "checkpoint_epoch",
            "s_per_epoch_median", "wall_s", "eval_nlls", "nll", "launches")}))
        doc = record(entry, a.out)
    print(json.dumps(doc["parity"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
