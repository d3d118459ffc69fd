"""Time-budget decomposition of the bf16 LSTM training step at H=512 and
H=1,024 on the card: the port's counterpart of ``tools/exp_h512_ablation.py``.

Each microkernel of ``ops/exp_lstm.py`` times one part of a step on its
own, at the JAX tool's shapes (T=16, B=1,024, batch blocks of bb=256):

  chain_mm               the serial recurrent product chain, nb*T dependent
                         [bb, H] @ [H, 4H] products (h feeds the next step)
  chain_mm_x2            the same chain as two independent half-row chains
                         -> how much of chain_mm is hideable latency
  chain_mm_x2_fullwidth  two independent full-width chains (2x the FLOPs)
  chain_mm_encdec        the same pair with the two-cell coupling
                         -> whether a second chain rides the first one's
                         latency (the basis of the two-cell design)
  gates_fwd / gates_bwd  the forward and backward gate math alone
  offchain_mm            the dRk / dW products off the chain

plus the port's whole-sequence LSTM (``lstm_sequence_kernel``, bf16 streams,
default fusion) at B=1,024, T=16, IN=98:

  fwd      the inference forward (no autograd)
  fwdbwd   the gradient of mean(h ** 2): training forward and backward

The rows keep the JAX tool's keys (``us``, ``tflops``,
``us_per_block_step``) and its analysis: the serial sum of the parts against
the measured step, the share of chain_mm that chain_mm_x2 hides, the share
of a second full-width chain hidden (100%: it rides the first chain's
latency for free; 0%: the chains run back to back), and ``roofline_ok``, no
row above the card's bf16 rate (989 TFLOP/s on an H100 SXM at 700 W).

The h512 kernels carry their state across batch blocks, as the TPU ran
them (see ``ops/exp_lstm.py``), so the chain at bb=256 is one serial chain
of 4*16 steps over 256 rows. Each shape is also run at bb = B (one block):
there the carried and the per-block readings coincide, and the chain is the
port's real step shape, [1024, H] @ [H, 4H] for 16 steps.

rk is scaled by 1 / (0.02 sqrt(H)) instead of the JAX tool's 0.02, so that
|h| stays of O(1) over every step (with 0.02 the chain underflows to 0,
whose products the card may time differently).

Timing: CUDA events around 20 calls after one warm-up call
(``tools/torch_kernel_times._time``), and the profiler's device time of the
kernels (``_device_ms``); each row's ``max_rel_err`` is its largest
distance to the plain version over the largest entry of the plain output
(a chain's plain version run block by block from the state the kernel
carried, see ``reference``).

Usage (a card is the default device; ~1 min with the build):

    python tools/torch_exp_h512_ablation.py [--smoke]
    python tools/torch_exp_h512_ablation.py --device cpu --smoke   # plain versions, no times

Writes ``artifacts/torch_h512_ablation.json`` from a card's full run,
headed with the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T = 16
IN_REAL, IN_OFF = 98, 128  # the real LSTM's input width; the off-chain x width
PEAK = 989e12  # H100 SXM, dense bf16 on the tensor cores
SHAPES = [(1024, 512, 256), (1024, 1024, 256)]
SMOKE = [(64, 128, 32)]
OUT = os.path.join(REPO, "artifacts", "torch_h512_ablation.json")
MICRO = ("chain_mm", "chain_mm_x2", "chain_mm_x2_fullwidth", "chain_mm_encdec", "gates_fwd",
         "gates_bwd", "offchain_mm")


def micro_inputs(B, H, dev, seed=0) -> dict:
    """Seeded inputs of every microkernel at (B, H)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    rk = lambda: f(H, 4 * H, scale=1 / (0.02 * H ** 0.5)).bfloat16()  # noqa: E731
    return dict(h0=f(B, H), g0=f(B, H), rkA=rk(), rkB=rk(), z0=f(B, 4 * H),
                hp=f(B, H).bfloat16(), dz=f(B, 4 * H).bfloat16(), xp=f(B, IN_OFF).bfloat16())


def micro_calls(ex, a, bb, plain=False) -> dict:
    """name -> a call of each microkernel (or its plain version) on ``a``."""
    fn = lambda name: getattr(ex, f"{name}_plain" if plain else name)  # noqa: E731
    return {
        "chain_mm": lambda: fn("chain_mm")(a["h0"], a["rkA"], bb, T),
        "chain_mm_x2": lambda: fn("chain_mm_x2")(a["h0"], a["rkA"], bb, T),
        "chain_mm_x2_fullwidth": lambda: fn("chain_mm_x2_fullwidth")(
            a["h0"], a["g0"], a["rkA"], a["rkB"], bb, T),
        "chain_mm_encdec": lambda: fn("chain_mm_encdec")(a["h0"], a["g0"], a["rkA"], a["rkB"],
                                                         bb, T),
        "gates_fwd": lambda: fn("gates_fwd")(a["z0"], bb, T),
        "gates_bwd": lambda: fn("gates_bwd")(a["z0"], bb, T),
        "offchain_mm": lambda: fn("offchain_mm")(a["hp"], a["dz"], a["xp"], bb, T),
    }


def reference(ex, name, got, a, bb):
    """The plain output ``got`` is held against: a chain's plain version run
    block by block from the state the kernel carried
    (``exp_lstm.chain_plain_blockwise``), the others' plain version."""
    if name in ("chain_mm", "chain_mm_x2"):
        return ex.chain_plain_blockwise(name, got, a["h0"], a["rkA"], bb=bb, T=T)
    if name.startswith("chain_mm"):
        return ex.chain_plain_blockwise(name, got, a["h0"], a["g0"], a["rkA"], a["rkB"], bb=bb,
                                        T=T)
    return micro_calls(ex, a, bb, plain=True)[name]()


def flops(name, B, H) -> float:
    """The JAX tool's operation counts (tensor-core products only)."""
    H4 = 4 * H
    return {"chain_mm": 2 * B * H * H4 * T, "chain_mm_x2": 2 * B * H * H4 * T,
            "chain_mm_x2_fullwidth": 2 * 2 * B * H * H4 * T,
            "chain_mm_encdec": 2 * 2 * B * H * H4 * T,
            "offchain_mm": 2 * B * (H + IN_OFF) * H4 * T}.get(name, 0.0)


def max_rel_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30) for g, w in zip(got, want))


def run_micro(B, H, bb, dev, reps=20, profile=True) -> dict:
    """One row per microkernel; on the CPU the plain versions run once and
    the rows carry no times (``profile``: the profiler's device time too)."""
    from classifying_vae_lstm_tpu_torch.ops import exp_lstm as ex
    from tools.torch_kernel_times import _device_ms, _time

    a = micro_inputs(B, H, dev)
    calls, nb, rows = micro_calls(ex, a, bb), B // bb, {}
    for name in MICRO:
        got = calls[name]()
        row = {"max_rel_err": max_rel_err(got, reference(ex, name, got, a, bb))}
        if dev.type == "cuda":
            ms = _time(calls[name], reps)
            us = ms * 1e3
            row.update(us=round(us, 2), us_per_block_step=round(us / (T * nb), 3))
            if profile:
                row["device_us"] = _us(_device_ms(calls[name]))
            if flops(name, B, H):
                row["tflops"] = round(flops(name, B, H) / (us * 1e-6) / 1e12, 2)
        rows[name] = row
    return rows


def _us(ms):
    return ms if isinstance(ms, str) else round(ms * 1e3, 2)  # "not measured" stays


def run_real(B, H, dev, reps=10) -> dict:
    """The port's bf16 whole-sequence LSTM (default fusion) at (B, T=16,
    IN=98): the inference forward and the gradient step."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.nn.core import init_lstm
    from classifying_vae_lstm_tpu_torch.ops.lstm_seq import lstm_sequence_kernel
    from tools.torch_kernel_times import _time

    params = {k: v.to(dev) for k, v in init_lstm(torch.Generator().manual_seed(0), IN_REAL,
                                                 H).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, IN_REAL))
                         .astype(np.float32)).to(dev)
    h0 = torch.zeros((B, H), device=dev)

    def fwd():
        with torch.no_grad():
            return lstm_sequence_kernel(params, x, h0, h0, compute_dtype=torch.bfloat16)[0]

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}

    def fwdbwd():
        h, _ = lstm_sequence_kernel(p, x, h0, h0, compute_dtype=torch.bfloat16)
        return torch.autograd.grad((h ** 2).mean(), list(p.values()))

    finite = bool(torch.isfinite(fwd()).all()) and all(
        bool(torch.isfinite(g).all()) for g in fwdbwd())
    if dev.type != "cuda":
        return {"finite": finite}
    fwd_flops = 2 * B * T * (IN_REAL + H) * H * 4
    rows = {"finite": finite}
    for name, fn, n_flops in (("fwd", fwd, fwd_flops), ("fwdbwd", fwdbwd, 3 * fwd_flops)):
        us = _time(fn, reps) * 1e3
        rows[name] = {"us": round(us, 2), "tflops": round(n_flops / (us * 1e-6) / 1e12, 2)}
    rows["bwd_derived_us"] = round(rows["fwdbwd"]["us"] - rows["fwd"]["us"], 2)
    return rows


def analysis(micro, real) -> dict:
    """The JAX tool's analysis keys, with the card's bf16 rate in
    ``roofline_ok``."""
    us = lambda k: micro[k]["us"]  # noqa: E731
    fwd_serial = us("chain_mm") + us("gates_fwd")
    bwd_serial = us("chain_mm") + us("gates_bwd") + us("offchain_mm")
    return {
        "fwd_parts_serial_us": round(fwd_serial, 2),
        "bwd_parts_serial_us": round(bwd_serial, 2),
        "fwdbwd_parts_serial_us": round(fwd_serial + bwd_serial, 2),
        "fwdbwd_measured_us": real["fwdbwd"]["us"],
        "parts_vs_measured": round(real["fwdbwd"]["us"] / (fwd_serial + bwd_serial), 3),
        "chain_latency_hideable_pct": round(100 * (1 - us("chain_mm_x2") / us("chain_mm")), 1),
        "fullwidth_second_chain_hidden_pct": round(
            100 * (2 - us("chain_mm_x2_fullwidth") / us("chain_mm")), 1),
        "encdec_second_chain_hidden_pct": round(
            100 * (2 - us("chain_mm_encdec") / us("chain_mm")), 1),
        "roofline_ok": all(r.get("tflops", 0.0) <= PEAK / 1e12 * 1.02
                           for r in list(micro.values()) + [real["fwd"], real["fwdbwd"]]),
    }


def run(shapes, dev) -> dict:
    """Every shape at its bb and at bb = B: micro rows, the real rows and
    the analysis (on a card), keyed as the JAX tool keys them."""
    out = {}
    for B, H, bb in shapes:
        real = run_real(B, H, dev)
        for blk in dict.fromkeys((bb, B)):
            tag = f"B{B} H{H} bb{blk}"
            micro = run_micro(B, H, blk, dev)
            out[tag] = {"micro": micro, "real": real}
            if dev.type == "cuda":
                out[tag]["analysis"] = analysis(micro, real)
            print(json.dumps({tag: out[tag]}, indent=1), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--smoke", action="store_true", help="the JAX tool's --smoke shape only")
    ap.add_argument("--out", default=None, help=f"the artifact (default {OUT})")
    args = ap.parse_args(argv)
    from classifying_vae_lstm_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    out = run(SMOKE if args.smoke else SHAPES, dev)
    bad = [t for t, r in out.items() if not r["real"]["finite"]
           or any(m["max_rel_err"] > 1e-2 for m in r["micro"].values())]
    if bad:
        print(f"outputs differ from the plain versions or are not finite: {bad}", flush=True)
        return 1
    if dev.type != "cuda":
        print("plain versions only (CPU): no times, nothing written", flush=True)
        return 0
    if args.smoke and not args.out:
        print("smoke ok (artifact not written: the --smoke shape measures launch overhead)")
        return 0
    import torch

    from tools.torch_converged_parity import card_line

    doc = {"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "T": T, "peak_bf16_tflops": PEAK / 1e12, "rows": out}
    path = args.out or OUT
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
