"""The half-batch interleaved LSTM training forward against the port's own,
on the card: the counterpart of ``tools/exp_lstm_interleave.py``.

The JAX tool splits each batch block into halves A and B and pipelines
them, so that one half's gate math overlaps the other half's product. The
port's version (``ops/exp_lstm.lstm_interleave_train_fwd``,
``csrc/exp_lstm.cu`` ``interleave_kernel``) is one persistent cooperative
launch for all T steps with a barrier counter for each half, split into
arrive and wait, so that each half's wait at its barrier is hidden behind
the other half's tiles. The baseline is the port's unfused bf16 training
forward, ``lstm_seq.lstm_seq_xz_train_fwd`` (``csrc/lstm_seq_tc.cu``: one
launch a step, the same products and epilogue).

At the JAX tool's four (H, B) with T=16 (xz ~ N(0, 1) and Rk ~ N(0, 0.05^2)
in bf16, h0 = c0 = 0), each row gives both times (CUDA events around
20 calls after a warm-up call), the speedup, both rates (2 B T H 4H
operations), whether the two agree bit for bit, and the relative Frobenius
distance of h, c and z to the plain version
(``lstm_interleave_train_fwd_plain``).

Usage (a card is the default device; ~30 s with the build):

    python tools/torch_exp_lstm_interleave.py
    python tools/torch_exp_lstm_interleave.py --device cpu   # the plain versions at a small shape

Writes ``artifacts/torch_lstm_interleave_exp.json`` from a card's run,
headed with the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [(512, 1024), (1024, 1024), (512, 200), (768, 1024)]  # (H, B)
CPU_SHAPE = (16, 32)
OUT = os.path.join(REPO, "artifacts", "torch_lstm_interleave_exp.json")


def inputs(H, B, dev, T=16, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xz = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).to(dev)
    rk = torch.from_numpy((0.05 * rng.standard_normal((H, 4 * H))).astype(np.float32)).to(dev)
    h0 = torch.zeros((B, H), device=dev)
    return xz.bfloat16(), rk.bfloat16(), h0, h0.clone()


def rel_frob(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def run(H, B, dev, T=16, reps=20) -> dict:
    import torch

    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from tools.torch_kernel_times import _time

    args = inputs(H, B, dev, T)
    got = ex.lstm_interleave_train_fwd(*args)
    base = ls.lstm_seq_xz_train_fwd(*args)
    plain = ex.lstm_interleave_train_fwd_plain(*args)
    row = {"H": H, "B": B, "T": T,
           "bitwise_equal_to_baseline": all(torch.equal(g, b) for g, b in zip(got, base)),
           "rel_frob_to_plain": {n: rel_frob(g, p) for n, g, p in zip("hcz", got, plain)}}
    if dev.type == "cuda":
        n_flops = B * T * 2 * H * 4 * H
        t_base = _time(lambda: ls.lstm_seq_xz_train_fwd(*args), reps)
        t_int = _time(lambda: ex.lstm_interleave_train_fwd(*args), reps)
        row.update(baseline_ms=round(t_base, 4), interleaved_ms=round(t_int, 4),
                   speedup=round(t_base / t_int, 3),
                   baseline_tflops=round(n_flops / (t_base * 1e-3) / 1e12, 1),
                   interleaved_tflops=round(n_flops / (t_int * 1e-3) / 1e12, 1))
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--out", default=None, help=f"the artifact (default {OUT})")
    args = ap.parse_args(argv)
    from classifying_vae_lstm_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    rows = [run(H, B, dev) for H, B in (SHAPES if dev.type == "cuda" else [CPU_SHAPE])]
    bad = [(r["H"], r["B"]) for r in rows if max(r["rel_frob_to_plain"].values()) > 1e-3]
    if bad:
        print(f"the interleaved forward differs from its plain version at (H, B) {bad}")
        return 1
    if dev.type != "cuda":
        print("plain versions only (CPU): no times, nothing written", flush=True)
        return 0
    import torch

    from tools.torch_converged_parity import card_line

    doc = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "rows": rows}
    path = args.out or OUT
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
