"""The padded-batch reverse-walk ladder of ``tools/repro_full_bwd_fault.py``
on the port, each rung held against its plain version.

The JAX tool adds one feature at a time to a reverse-walk stub at a batch
its 16-row tile does not divide (B=40), then runs the real backward kernels
at B=500, H=512, and checks only that outputs are finite. Here every case
also measures how far its outputs are from the plain version on the same
inputs (``max|got - plain| / max|plain|`` for each output; dx of the mini
walk each step apart):

* ``min_base`` .. ``min_all``: ``ops/exp_lstm.mini_walk`` (drk only; an
  extra streamed x; a dx output; a second accumulator; a one-row
  accumulator; everything);
* ``real_drk`` / ``real_full``: ``lstm_seq.lstm_seq_walk_drk`` and
  ``lstm_seq.lstm_seq_bwd`` called directly at B=500, H=512, T=16, IN=98,
  in bf16 (``csrc/lstm_seq_tc.cu``) and in f32 (``csrc/lstm_bwd_f32.cu``);
* ``jit_drk`` / ``jit_full``: the gradient of ``mean(h ** 2)`` through
  ``lstm_sequence_kernel`` (``LstmSeqCore`` under ``torch.autograd``) with
  fusion (T, T, F) and (T, T, T), bf16 and f32, against the same autograd
  with the kernels' plain versions swapped in.

The port has no padded-batch gate: ``LstmSeqCore.backward`` sends every
batch to the rung its fusion names, so the partial last tiles of B=500 run
on the card here, by direct call and through autograd.

Tolerances: 1e-2 (bf16 streams) and 1e-4 (f32) of each output's largest
entry; the mini walk's f32 accumulators 1e-4, its bf16 dx 1e-2.

Usage (a card is the default device):

    python tools/torch_repro_full_bwd_fault.py              # every case, a process each, all at once
    python tools/torch_repro_full_bwd_fault.py --case min_all   # one case, in this process
    python tools/torch_repro_full_bwd_fault.py --device cpu --cases min_base,min_all

Writes ``artifacts/torch_full_bwd_fault_repro.json`` (a card's run; ``--out``
names another file), headed with the card's name and power limit. With
``--device cpu`` the plain versions run and nothing is written unless
``--out`` is given. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REAL = dict(B=500, H=512, T=16, IN=98)
MINI = dict(B=40, H=256, T=8, IN=128, bb=16)  # 40 % 16 = 8: the last tile is partial
CASES = ["min_base", "min_dx_in", "min_dx_out", "min_dw", "min_db", "min_all",
         "real_drk", "real_full", "jit_drk", "jit_full"]
TOL = {"bf16": 1e-2, "f32": 1e-4}
OUT = os.path.join(REPO, "artifacts", "torch_full_bwd_fault_repro.json")
TIMEOUT = 900  # seconds a case


def _rel(got, want) -> float:
    want = want.float()
    top = want.abs().max().item()
    return (got.float() - want).abs().max().item() / (top if top > 0 else 1.0)


def _finite(ts) -> bool:
    import torch

    return all(bool(torch.isfinite(t.float()).all()) for t in ts)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_mini(case, dev) -> dict:
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex

    B, H, T, IN = (MINI[k] for k in ("B", "H", "T", "IN"))
    rng = np.random.default_rng(0)
    b16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).bfloat16()
    z, h, x = b16(T, B, 4 * H), b16(T, B, H), b16(T, B, IN)
    ex.reset_counts()
    got = ex.mini_walk(case, z, h, x)
    _sync(dev)
    launches = ex.counts()["mini_walk"]
    want = ex.mini_walk_plain(case, z, h, x)
    errs, ok = {}, True
    for name, g, w in zip(("dx", "drk", "dw", "db"), got, want):
        if w is None:
            continue
        if name == "dx":
            errs[name] = max(_rel(g[t], w[t]) for t in range(T))
            ok &= errs[name] <= TOL["bf16"]
        else:
            errs[name] = _rel(g, w)
            ok &= errs[name] <= TOL["f32"]
    written = [g for g in got if g is not None]
    return {"case": case, "finite": _finite(written), "ok": bool(ok) and _finite(written),
            "err": errs, "launches": {"exp_lstm.MINI_WALK_LAUNCHES": launches}}


def _lstm_counts():
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    return {f"lstm_seq.{m}{k}_LAUNCHES": getattr(ls, f"{m}{k}_LAUNCHES")
            for m in ("BF16_", "") for k in ("TRAIN_FWD", "BWD", "WALK", "DRK")}


def _reset_lstm_counts():
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    for name in _lstm_counts():
        setattr(ls, name.split(".")[1], 0)


def _real_inputs(dev, bf16: bool, seed=0):
    import numpy as np
    import torch

    B, H, T, IN = (REAL[k] for k in ("B", "H", "T", "IN"))
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    sd = (lambda t: t.bfloat16()) if bf16 else (lambda t: t)
    # the weights at 1/sqrt(fan-in), so the dh carry keeps its size over T
    return dict(z=sd(f(T, B, 4 * H)), c_prev=f(T, B, H), c=f(T, B, H), h_prev=sd(f(T, B, H)),
                x=sd(f(T, B, IN)), dh_seq=f(T, B, H), dc_seq=f(T, B, H),
                rk_t=sd(f(4 * H, H, scale=H ** -0.5)), w_t=f(4 * H, IN, scale=IN ** -0.5))


def run_real(case, dev) -> dict:
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    errs, finite, ok = {}, True, True
    _reset_lstm_counts()
    for mode in ("bf16", "f32"):
        a = _real_inputs(dev, mode == "bf16")
        if case == "real_drk":
            args = [a[k] for k in ("z", "c_prev", "c", "h_prev", "dh_seq", "dc_seq", "rk_t")]
            names = ("dz", "dh0", "dc0", "drk")
            fn, plain = ls.lstm_seq_walk_drk, ls.lstm_seq_walk_drk_plain
        else:
            args = [a[k] for k in ("z", "c_prev", "c", "h_prev", "x", "dh_seq", "dc_seq", "rk_t",
                                   "w_t")]
            names = ("dx", "dh0", "dc0", "drk", "dw", "db")
            fn, plain = ls.lstm_seq_bwd, ls.lstm_seq_bwd_plain
        got = fn(*args)
        _sync(dev)
        want = plain(*args)
        errs[mode] = {n: _rel(g, w) for n, g, w in zip(names, got, want)}
        finite &= _finite(got)
        ok &= max(errs[mode].values()) <= TOL[mode]
    return {"case": case, "shape": REAL, "finite": bool(finite), "ok": bool(ok and finite),
            "err": errs, "launches": {k: v for k, v in _lstm_counts().items() if v}}


@contextlib.contextmanager
def _plain_kernels():
    """The whole-sequence LSTM wrappers replaced by their plain versions
    (this process runs one case, so nothing else sees the swap)."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    names = ("lstm_seq_train_fwd", "lstm_seq_bwd", "lstm_seq_walk", "lstm_seq_walk_drk")
    saved = {n: getattr(ls, n) for n in names}
    for n in names:
        setattr(ls, n, getattr(ls, f"{n}_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ls, n, f)


def run_jit(case, dev) -> dict:
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.nn.core import init_lstm
    from classifying_vae_lstm_tpu_torch.ops.lstm_seq import lstm_sequence_kernel

    B, H, T, IN = (REAL[k] for k in ("B", "H", "T", "IN"))
    fusion = (True, True, case == "jit_full")
    params = {k: v.to(dev) for k, v in init_lstm(torch.Generator().manual_seed(0), IN,
                                                 H).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, IN))
                         .astype(np.float32)).to(dev)
    h0 = torch.zeros((B, H), device=dev)

    def grads(sd):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        h, _ = lstm_sequence_kernel(p, x, h0, h0, compute_dtype=sd, fusion=fusion)
        return torch.autograd.grad((h.float() ** 2).mean(), list(p.values()))

    errs, finite, ok = {}, True, True
    _reset_lstm_counts()
    for mode, sd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        got = grads(sd)
        _sync(dev)
        with _plain_kernels():
            want = grads(sd)
        errs[mode] = {n: _rel(g, w) for n, g, w in zip(params, got, want)}
        finite &= _finite(got)
        ok &= max(errs[mode].values()) <= TOL[mode]
    return {"case": case, "shape": REAL, "fusion": list(fusion), "finite": bool(finite),
            "ok": bool(ok and finite), "err": errs,
            "launches": {k: v for k, v in _lstm_counts().items() if v}}


def run_case(case, device) -> dict:
    from classifying_vae_lstm_tpu_torch import resolve_device

    dev = resolve_device(device)
    if case.startswith("real"):
        return run_real(case, dev)
    if case.startswith("jit"):
        return run_jit(case, dev)
    return run_mini(case, dev)


def _subprocess_row(case, device, timeout) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--case", case, "--device", device]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"case": case, "returncode": None, "crashed": True, "finite": False, "ok": False,
                "tail": [f"timed out after {timeout} s"]}
    lines = r.stdout.strip().splitlines()
    row = {"case": case, "finite": False, "ok": False}
    if r.returncode == 0 and lines:
        row.update(json.loads(lines[-1]))
    row.update(returncode=r.returncode, crashed=r.returncode != 0)
    if r.returncode != 0:
        row["tail"] = (r.stdout + r.stderr).strip().splitlines()[-3:]
    return row


def run_ladder(device="cuda", cases=CASES, timeout=TIMEOUT) -> list:
    """Every case in its own process (a fault can poison a CUDA context),
    all at once, each given ``timeout`` seconds; returns the rows in the
    order of ``cases``."""
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        rows = list(pool.map(lambda c: _subprocess_row(c, device, timeout), cases))
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=CASES, help="run one case in this process")
    ap.add_argument("--cases", default=",".join(CASES), help="comma-separated cases to run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--out", default=None, help=f"the artifact (default {OUT} on a card)")
    args = ap.parse_args(argv)
    if args.case:
        print(json.dumps(run_case(args.case, args.device)), flush=True)
        return 0
    cases = [c for c in args.cases.split(",") if c]
    bad = sorted(set(cases) - set(CASES))
    if bad:
        ap.error(f"unknown cases {bad}")
    if args.device != "cpu":
        from classifying_vae_lstm_tpu_torch import resolve_device

        resolve_device(args.device)  # raises without a card
    rows = run_ladder(args.device, cases)
    out = args.out or (OUT if args.device != "cpu" else None)
    if out:
        import torch

        from tools.torch_converged_parity import card_line

        doc = {"card": card_line() if args.device != "cpu" else None, "device": args.device,
               "torch": torch.__version__, "cuda": torch.version.cuda, "tolerance": TOL,
               "rows": rows}
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {out}", flush=True)
    failed = [r["case"] for r in rows if not (r["ok"] and r["finite"])]
    print(f"cases finite and within tolerance: {len(rows) - len(failed)}/{len(rows)}"
          + (f"; failed {failed}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
