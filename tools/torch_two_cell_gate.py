#!/usr/bin/env python3
"""The two ``--lstm_backend pallas`` routes of a cl_vrnn training step,
timed against each other on one CUDA card at equal shapes.

    python3 tools/torch_two_cell_gate.py [--reps 5]

The two-cell route (``csrc/two_cell.cu`` and ``csrc/two_cell_tc.cu``:
encoder and decoder in one forward and one backward kernel) and the two-loop route (``two_cell``
off: each LSTM through the whole-sequence kernels, ``csrc/lstm_seq.cu`` in
f32, ``csrc/lstm_seq_tc.cu`` in bf16) compute the same function; the port's
``ops/two_cell.should_use`` picks one when a config leaves ``two_cell``
unset. A step here is ``loss_and_metrics`` and its backward (the optimizer
is the same on both routes), on the model's seeded Keras init and seeded
windows: D=88, T=16, use_x_prev, 13 keys, the default fusion rung; bf16 at
B=1,024, L=2 (the JAX package's scale work) and f32 at B=200, L=8
(``chip_smoke.py`` phase 5's shape), H in {88, 256, 512, 768, 1,024,
1,536, 2,048}.
Each route is timed with CUDA events (after two warm-up steps) in the order
two-cell, two-loop, two-loop, two-cell; the launch counts of the step show
which kernels ran. Prints the card's name and power limit first and one line
per shape; needs a CUDA card and ``nvcc`` (the kernels are built at first
use).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HIDDEN = (88, 256, 512, 768, 1024, 1536, 2048)
MODES = (("bf16", 1024, 2), ("f32", 200, 8))  # stream mode, batch, latent_dim
D, T, K = 88, 16, 13


def step_fn(cfg, B, gen):
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn

    params = cl_vrnn.init(gen, cfg)
    for cell in params.values():
        for v in cell.values():
            v.requires_grad_(True)
    dev = gen.device
    frames = (torch.rand((B, T + 1, D), generator=gen, device=dev) < 0.1).float()
    batch = {"x": frames[:, 1:], "y": frames[:, 1:], "x_prev": frames[:, :-1],
             "w": torch.eye(K, device=dev)[torch.arange(B, device=dev) % K],
             **cl_vrnn.draw_apply_noise(gen, cfg, B)}

    def step():
        loss, _ = cl_vrnn.loss_and_metrics(params, cfg, batch)
        loss.backward()

    return step


def time_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counts():
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    return {f"{m.__name__.rsplit('.', 1)[1]}.{n}": getattr(m, n) for m in (ls, tc)
            for n in dir(m) if n.endswith("_LAUNCHES") and getattr(m, n)}


def main(argv=None) -> int:
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for mode, B, L in MODES:
        for H in HIDDEN:
            base = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                                  seq_length=T, n_classes=K, use_x_prev=True,
                                  lstm_backend="pallas", bf16_compute=mode == "bf16")
            steps, ran = {}, {}
            for route in ("two-cell", "two-loop"):
                cfg = dataclasses.replace(base, two_cell=route == "two-cell")
                steps[route] = step_fn(cfg, B, torch.Generator(device=dev).manual_seed(H))
                before = counts()
                steps[route]()
                torch.cuda.synchronize()
                ran[route] = sorted(k for k, v in counts().items() if v != before.get(k, 0))
            ms = {r: [] for r in steps}
            for route in ("two-cell", "two-loop", "two-loop", "two-cell"):
                ms[route].append(time_ms(steps[route], a.reps))
            best = {r: min(v) for r, v in ms.items()}
            faster = min(best, key=best.get)
            print(f"{mode} B={B} L={L} H={H}: step (loss + backward) two-cell "
                  f"{' / '.join(f'{v:.3f}' for v in ms['two-cell'])} ms, two-loop "
                  f"{' / '.join(f'{v:.3f}' for v in ms['two-loop'])} ms; faster: {faster} "
                  f"({max(best.values()) / min(best.values()):.2f}x); kernels two-cell "
                  f"{ran['two-cell']}, two-loop {ran['two-loop']}", flush=True)
            del steps
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
