#!/usr/bin/env python3
"""Times of the two-cell forward and of f32 / bf16 cl_vrnn generation in one
checkout of the port, at the shapes of ``chip_smoke.py``, for comparing two
checkouts on one card in turns.

    python3 tools/torch_kernel_times.py [--root CHECKOUT] [--reps 5]

Runs the kernels of the checkout at ``--root`` (default: this one; run each
checkout in its own process, as both define the same package): the two-cell
forward (``ops/two_cell.two_cell_fwd``) at phase 5's shape (f32, B=200,
T=16, H=256, L=8, input widths 101) and phase 23's (bf16, B=1,024, H=512,
L=2); generation (``ops/cuda_generate.generate_cl_vrnn_batch_cuda``, u = 1,
probabilities) of ``artifacts/jsball_vrnn4`` (f32, H=256) and of seeded
glorot weights in bf16 at H=512 (phase 3: L=8, 10 keys), 1,536 and 2,048
(L=2, 13 keys), 64 songs x (32 + 256) steps, and the serving buckets (1, 4,
16, 64 songs x 32 ... 256 steps) of the f32 and the bf16 H=512 ones. Each
is timed with CUDA events around the wrapper after a warm-up call, and its
device time a call is the sum of ``torch.profiler``'s device events over
two calls ("not measured" where it records none). Prints the card's name and
power limit first and one JSON object a line. Needs a CUDA card and ``nvcc``;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0


def _time(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, n=2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total", 0.0) or 0.0 for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    return round(sum(us) / (n * 1e3), 4) if any(us) else "not measured"


def _line(name, fn, reps, **shape):
    print(json.dumps({"name": name, **shape, "ms": round(_time(fn, reps), 4),
                      "device_ms": _device_ms(fn)}), flush=True)


def _two_cell(reps):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    dev = torch.device("cuda", 0)
    for mode, B, H, L in (("f32", 200, 256, 8), ("bf16", 1024, 512, 2)):
        rng = np.random.default_rng(SEED)
        T, IN = 16, 101
        f = lambda *s, scale=1.0: torch.from_numpy(
            (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
        ins = [f(T, B, IN), f(T, B, IN), f(T, B, L), f(IN, 4 * H, scale=0.1),
               f(4 * H, scale=0.1), f(H, 4 * H, scale=0.05), f(IN, 4 * H, scale=0.1),
               f(4 * H, scale=0.1), f(H, 4 * H, scale=0.05), f(L, 4 * H, scale=0.1),
               f(H, 2 * L, scale=0.05), f(2 * L, scale=0.1), f(B, H, scale=0.5),
               f(B, H, scale=0.5), f(B, H, scale=0.5), f(B, H, scale=0.5)]
        if mode == "bf16":
            for i in (0, 1, 3, 5, 6, 8, 9, 10):
                ins[i] = ins[i].bfloat16()
        _line(f"two_cell_fwd {mode}", lambda: tc.two_cell_fwd(*ins), reps, B=B, T=T, H=H, L=L)


def _glorot_params(rng, D, H, L, K, dev):
    import numpy as np

    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    zeros = lambda n: np.zeros(n, np.float32)
    raw = {"encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                         "bias": zeros(4 * H)},
           "decoder_h": {"kernel": glorot(D + L + K, 4 * H),
                         "recurrent_kernel": glorot(H, 4 * H), "bias": zeros(4 * H)},
           "Z_mean": {"kernel": glorot(H, L), "bias": zeros(L)},
           "Z_log_var": {"kernel": glorot(H, L), "bias": zeros(L)},
           "X_decoded_mean": {"kernel": glorot(H, D), "bias": zeros(D)}}
    return params_from_numpy(raw, dev)


def _generation(reps, root):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    dev = torch.device("cuda", 0)
    B, Tseed, nsteps, D = 64, 32, 256, 88
    rng = np.random.default_rng(SEED)
    seeds = torch.from_numpy((rng.random((B, Tseed, D)) < 0.1).astype(np.float32)).to(dev)
    raw, cfg, _ = common.load_model(str(Path(root) / "artifacts" / "jsball_vrnn4.npz"), "cl_vrnn")
    cases = [("f32", params_from_numpy(raw, dev), cfg)]
    for H, L, K in ((512, 8, 10), (1536, 2, 13), (2048, 2, 13)):
        cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=16,
                             n_classes=K, use_x_prev=True, bf16_compute=True)
        cases.append(("bf16", _glorot_params(rng, D, H, L, K, dev), cfg))
    for mode, params, cfg in cases:
        L, K, H = cfg.latent_dim, cfg.n_classes, cfg.intermediate_dim
        eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, L)).astype(np.float32))
        eps = eps.to(dev)
        u = torch.ones((B, Tseed + nsteps, D), device=dev)
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        run = lambda b, t: cg.generate_cl_vrnn_batch_cuda(
            params, cfg, seeds[:b].contiguous(), t, eps[:b, :Tseed + t].contiguous(),
            u[:b, :Tseed + t].contiguous(), ws[:b].contiguous(), return_probs=True, mode=mode)
        _line(f"generation {mode}", lambda: run(B, nsteps), max(1, reps // 2 if H > 1024 else reps),
              B=B, Tseed=Tseed, nsteps=nsteps, H=H)
        if H <= 512:
            grid = {f"{b}x{t}": round(_time(lambda: run(b, t), reps), 3)
                    for b in (1, 4, 16, 64) for t in (32, 64, 128, 256)}
            print(json.dumps({"name": f"generation {mode} buckets", "H": H, "ms": grid}),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose package to run (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    root = str(Path(a.root or Path(__file__).resolve().parents[1]).resolve())
    sys.path.insert(0, root)
    import torch

    import classifying_vae_lstm_tpu_torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"package: {Path(classifying_vae_lstm_tpu_torch.__file__).parent}", flush=True)
    _two_cell(a.reps)
    _generation(a.reps, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
