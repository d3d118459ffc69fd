#!/usr/bin/env python3
"""Times of the two-cell forward, of f32 / bf16 cl_vrnn generation, of the
bf16 dense-stack forward, of int8 and of wide f32 / bf16 cl_vae generation
and of the f32 whole-sequence LSTM forward in one checkout of the port, at
the shapes of ``chip_smoke.py``, for comparing two checkouts on one card in
turns.

    python3 tools/torch_kernel_times.py [--root CHECKOUT] [--reps 5]
        [--parts two_cell,cluster_vae,cluster_vae_sweep,generation,vae_dense,
                 vae_dense_f32,int8_vae,wide_vae,wide_vae_buckets,lstm_f32_fwd,
                 rungs_bf16,generation_plain]
        [--against PARENT]

Runs the kernels of the checkout at ``--root`` (default: this one; run each
checkout in its own process, as both define the same package): the two-cell
forward (``ops/two_cell.two_cell_fwd``) at phase 5's shape (f32, B=200,
T=16, H=256, L=8, input widths 101) and phase 23's (bf16, B=1,024, H=512,
L=2); generation (``ops/cuda_generate.generate_cl_vrnn_batch_cuda``, u = 1,
probabilities) of ``artifacts/jsball_vrnn4`` (f32, H=256) and of seeded
glorot weights in bf16 at H=512 (phase 3: L=8, 10 keys), 1,536 and 2,048
(L=2, 13 keys), 64 songs x (32 + 256) steps, and the serving buckets (1, 4,
16, 64 songs x 32 ... 256 steps) of the f32 and the bf16 H=512 ones; the
bf16 dense-stack forward (``ops/vae_dense.vae_dense_fwd``) at phase 18's
shapes (B=100, D=1,024, Cw=256, H=1,024, L=16, K=13; B=1,024, D=976 with
x_prev); the f32 dense-stack forward and backward (``vae_dense_f32``) at
phase 14's training shape (B=100, D=Cw=H=88, L=4, K=13, x_prev) and wide
shape (B=1,024, D=976, Cw=256, H=1,024, L=16), timed over 20 and 2 times
``--reps`` calls, with the checkout's plan and the kernels' own clock of
each part and grid (``vae_dense.phase_ms``) where it has them; int8 cl_vae
generation
(``ops/cuda_generate_vae.generate_cl_vae_batch_cuda``, sampled frames) at
phase 29's shapes (D=1,024, L=16, 64 songs x 256 steps: H=5,120 with and
without use_z_prior, H=4,160 with x_prev, whose weight slices stay in shared
memory; H=5,120 and 7,808 with x_prev, which stream some; the serving
buckets at H=5,120), and, in a checkout that has them, each layout, the
frame head in one and in two song groups at the first two widths, the
streamed widths' parts of a call and the wrapper's quantization and packing
alone; wide cl_vae generation (``wide_vae``: f32 and bf16 at D=88, L=4
with x_prev, H = 256, 512, 1,024, and at D=1,024, L=16, H = 1,024 and
5,120, 64 songs x 256 steps; at H=5,120 in bf16 also with x_prev, with
use_z_prior and the serving buckets) through the kernel ``kernel_for``
picks and, in f32 in a checkout that has both, through the cooperative and
the wide kernel (the routing sweep), with the cooperative kernel's clock of
each part of a step and the wrapper's pack apart; the routing sweep at the
serving buckets (``wide_vae_buckets``: D=88, H = 256 and 512, f32 and
bf16); the f32 LSTM
forward (``lstm_f32_fwd``: the training and inference forwards and both xz
forwards at B=200, T=16, H=256, IN=105, the inference forward and the xz
one at 12,800 rows, with the layout where the checkout plans one; the
kernel reads every weight as stored, so the wrapper packs nothing); the
bf16 kernels of the other fusion rungs at phase 28's shape (``rungs_bf16``:
both unfused forwards, the dz-only and the drk walk at B=200, T=16, H=256,
IN=101, each with its plain version's time and its bound at the bf16 rate);
the plain version of bf16 cl_vrnn generation at the kernel's shapes
(``generation_plain``: H=512, 1,536 and 2,048, 64 songs x (32 + 256)); the
cl_vae generation shapes of the cluster kernel (``cluster_vae``: the
trained jsball_vae in f32 and its serving buckets, bf16 H=256, f32 H=256
and a model without hidden layers, 64 songs x 256 steps, through the
kernel ``kernel_for`` picks, and the cooperative kernel at the routing
sweep's widths) and, in a checkout with the cluster kernel, the routing
sweep at the serving buckets and the plans it launches at 4 and 8 blocks
a cluster and past one wave of the card (``cluster_vae_sweep``). ``--against PARENT`` runs the
parts in four processes, PARENT, this checkout, this checkout, PARENT, on
one card. Each is timed with CUDA events around the wrapper after a
warm-up call, and its device time a call is the sum of ``torch.profiler``'s
device events over two calls ("not measured" where it records none).
Prints the card's name and power limit first and one JSON object a line.
Needs a CUDA card and ``nvcc``; imports nothing of JAX.
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


def _glorot(rng, i, o):
    import numpy as np

    lim = np.sqrt(6.0 / (i + o))
    return rng.uniform(-lim, lim, (i, o)).astype(np.float32)


def _vae_dense(reps):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    for B, D, Cw, H, L, K, use_xp in ((100, 1024, 256, 1024, 16, 13, False),
                                      (1024, 976, 256, 1024, 16, 13, True)):
        t = lambda a, bf16=False: torch.from_numpy(a).to(dev).to(
            torch.bfloat16 if bf16 else torch.float32)
        g = lambda i, o: t(_glorot(rng, i, o), True)
        z = lambda n: t(np.zeros(n, np.float32))
        bits = lambda: t((rng.random((B, D)) < 0.1).astype(np.float32), True)
        K2 = 2 * (K - 1)
        ins = (bits(), bits() if use_xp else None,
               t(rng.standard_normal((B, K - 1)).astype(np.float32)),
               t(rng.standard_normal((B, L)).astype(np.float32)), g(D, Cw), z(Cw), g(Cw, K2),
               z(K2), g(D, H), g(K, H), z(H), g(H, 2 * L), z(2 * L), g(K, H),
               g(D, H) if use_xp else None, g(L, H), z(H), g(H, D), z(D))
        _line("vae_dense_fwd bf16", lambda: vd.vae_dense_fwd(*ins), reps, B=B, D=D, H=H,
              use_x_prev=use_xp)


def _vae_dense_f32(reps):
    """The f32 dense stack (``csrc/vae_dense.cu``), both directions, at
    phase 14's training shape (B=100, D=Cw=H=88, L=4, K=13, x_prev) and wide
    shape (B=1,024, D=976, Cw=256, H=1,024, L=16, K=13, x_prev); where the
    checkout has them, its plan and the kernels' own clock of each part (and
    the blocks of each launch, where ``phase_ms`` returns them)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    for label, (B, D, Cw, H, L, K), n in (("training", (100, 88, 88, 88, 4, 13), 20 * reps),
                                          ("wide", (1024, 976, 256, 1024, 16, 13), 2 * reps)):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        g = lambda i, o: t(_glorot(rng, i, o))
        b = lambda m: t(0.1 * rng.standard_normal(m))
        bits = lambda: t(rng.random((B, D)) < 0.1)
        K2 = 2 * (K - 1)
        ins = (bits(), bits(), t(rng.standard_normal((B, K - 1))), t(rng.standard_normal((B, L))),
               g(D, Cw), b(Cw), g(Cw, K2), b(K2), g(D, H), g(K, H), b(H), g(H, 2 * L), b(2 * L),
               g(K, H), g(D, H), g(L, H), b(H), g(H, D), b(D))
        xhat, wargs, zargs, w, a1, a2, a3 = vd.vae_dense_fwd_plain(*ins)
        cot = [t(1e-2 * rng.standard_normal(tuple(o.shape))) for o in (xhat, wargs, zargs, w)]
        res = (*ins[:4], a1, a2, a3, xhat, wargs, zargs, w, *cot, *(ins[i] for i in
               (4, 6, 8, 9, 11, 13, 14, 15, 17)))
        shape = dict(B=B, D=D, Cw=Cw, H=H, L=L, K=K, use_x_prev=True)
        extra = {}
        if hasattr(vd, "plan"):
            extra["plan"] = {k: int(v) for k, v in vd.plan(B, D, Cw, H, L, K, True)._asdict()
                             .items()}
        for direction, fn, args in (("fwd", vd.vae_dense_fwd, ins),
                                    ("bwd", vd.vae_dense_bwd, res)):
            parts = {}
            if hasattr(vd, "phase_ms"):
                got = vd.phase_ms(direction, *args)
                ms, blocks = got if isinstance(got, tuple) else (got, None)  # a checkout's form
                parts = {"parts_ms": {k: round(v, 4) for k, v in ms.items()}, "blocks": blocks}
            _line(f"vae_dense_{direction} f32 {label}", lambda: fn(*args), n, **shape, **extra,
                  **parts)


def _int8_vae(reps):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    B, D, L, K, Cw, nsteps = 64, 1024, 16, 13, 256, 256
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # the resident layouts (H=5,120; H=4,160 with x_prev), then the streamed
    # ones: the head's tiles (H=5,120 with x_prev), the head and the x rows
    # (H=7,808 with x_prev)
    for H, use_xp in ((5120, False), (4160, True), (5120, True), (7808, True)):
        cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                            intermediate_class_dim=Cw, n_classes=K, use_x_prev=use_xp,
                            bf16_compute=True, gen_backend="pallas")
        n_xp = D if use_xp else 0
        zeros = lambda n: np.zeros(n, np.float32)
        raw = {"h_w": {"kernel": _glorot(rng, D, Cw), "bias": zeros(Cw)},
               "w_mean": {"kernel": _glorot(rng, Cw, K - 1), "bias": zeros(K - 1)},
               "w_log_var": {"kernel": _glorot(rng, Cw, K - 1), "bias": zeros(K - 1)},
               "h": {"kernel": _glorot(rng, D + K, H), "bias": zeros(H)},
               "z_mean": {"kernel": _glorot(rng, H, L), "bias": zeros(L)},
               "z_log_var": {"kernel": _glorot(rng, H, L), "bias": zeros(L)},
               "decoder_h": {"kernel": _glorot(rng, K + n_xp + L, H), "bias": zeros(H)},
               "x_decoded_mean": {"kernel": _glorot(rng, H, D),
                                  "bias": np.full(D, -2.0, np.float32)}}
        params = params_from_numpy(raw, dev)
        t = lambda a: torch.from_numpy(a).to(dev)
        seeds = t((rng.random((B, D)) < 0.1).astype(np.float32))
        eps = t(rng.standard_normal((B, nsteps, L)).astype(np.float32))
        u = t(rng.random((B, nsteps, D)).astype(np.float32))
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        plan_fn = getattr(cgv, "coop_plan", getattr(cgv, "int8_plan", None))  # a parent's name
        plan = plan_fn(cfg, B, n_sm) if plan_fn else None
        layout = {"resident": list(plan["res"])} if plan else {}
        for zp in ((False, True) if (H, use_xp) == (5120, False) else (False,)):
            run = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws,
                                                         use_z_prior=zp, mode="int8")
            _line("generation int8 cl_vae", run, max(1, reps // 2), B=B, nsteps=nsteps, D=D,
                  H=H, use_x_prev=use_xp, use_z_prior=zp, **layout)
        if (H, use_xp) == (5120, False):  # the serving buckets (songs x steps)
            run = lambda b, n: cgv.generate_cl_vae_batch_cuda(
                params, cfg, seeds[:b].contiguous(), n, eps[:b, :n].contiguous(),
                u[:b, :n].contiguous(), ws[:b].contiguous(), mode="int8")
            grid = {f"{b}x{n}": round(_time(lambda: run(b, n), max(1, reps // 3)), 3)
                    for b in (1, 4, 16, 64) for n in (32, 64, 128, 256)}
            print(json.dumps({"name": "generation int8 cl_vae buckets", "H": H, "ms": grid}),
                  flush=True)
        if plan is None:
            continue
        pack_fn = getattr(cgv, "pack_coop", getattr(cgv, "pack_int8", None))
        pack = lambda: pack_fn(cgv._pack_int8(params, cfg, ws), cfg, plan["nu"], plan["G"],
                               plan["P"], plan["hs"])
        _line("int8 cl_vae pack (quantization and per-block packing)", pack, reps, H=H,
              use_x_prev=use_xp)
        if (H, use_xp) not in ((5120, False), (4160, True)):  # a streamed layout's parts
            parts = cgv.phase_ms(params, cfg, seeds, nsteps, eps, u, ws)
            print(json.dumps({"name": "generation int8 cl_vae, parts of a call", "H": H,
                              "use_x_prev": use_xp, **layout,
                              "parts_ms": {k: round(v, 4) for k, v in parts.items()}}),
                  flush=True)
            continue
        # the frame head in one and in two song groups: head_split's rule
        # replaced for the comparison
        rule = cgv.head_split
        for hs in (1, 2):
            cgv.head_split = lambda D, G, B, hs=hs: (hs, -(-(-(-D // 8)) // (G // hs)))
            try:
                parts = cgv.phase_ms(params, cfg, seeds, nsteps, eps, u, ws)
                lib = cgv._kernels()
                flags = (int(use_xp), 0, 0)
                launch = ((lambda: cgv._launch_coop(lib, params, cfg, seeds, nsteps, eps, u, ws,
                                                    flags, "int8"))
                          if hasattr(cgv, "_launch_coop") else
                          (lambda: cgv._launch_int8(lib, params, cfg, seeds, nsteps, eps, u, ws,
                                                    flags)))
                ms, dev_ms = round(_time(launch, reps), 4), _device_ms(launch)
            finally:
                cgv.head_split = rule
            print(json.dumps({"name": "generation int8 cl_vae, song groups of the frame head",
                              "H": H, "song_groups": hs, "ms": ms, "device_ms": dev_ms,
                              "parts_ms": {k: round(v, 4) for k, v in parts.items()}}),
                  flush=True)


def _wide_problem(D, H, L, use_xp, mode, B, nsteps, K=13):
    """Seeded glorot cl_vae weights (frame bias -2; H = 0: no hidden layers)
    and B songs' seeds and noise on the card: (params, cfg, seeds, eps, u,
    ws)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + H + D)

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    n_xp = D if use_xp else 0
    raw = {"h_w": dense(D, 88), "w_mean": dense(88, K - 1), "w_log_var": dense(88, K - 1)}
    if H:
        raw.update(h=dense(D + K, H), z_mean=dense(H, L), z_log_var=dense(H, L),
                   decoder_h=dense(K + n_xp + L, H), x_decoded_mean=dense(H, D))
    else:  # no hidden layers: the z heads over [x_prev, w], the frame head over [w, x_prev, z]
        raw.update(z_mean=dense(D + K, L), z_log_var=dense(D + K, L),
                   x_decoded_mean=dense(K + n_xp + L, D))
    raw["x_decoded_mean"]["bias"][:] = -2.0
    params = params_from_numpy(raw, dev)
    cfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                        intermediate_class_dim=88, n_classes=K, use_x_prev=use_xp,
                        bf16_compute=mode == "bf16")
    t = lambda a: torch.from_numpy(a).to(dev)
    seeds = t((rng.random((B, D)) < 0.1).astype(np.float32))
    eps = t(rng.standard_normal((B, nsteps, L)).astype(np.float32))
    u = t(rng.random((B, nsteps, D)).astype(np.float32))
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    return params, cfg, seeds, eps, u, ws


def _pinned(cgv, cfg):
    """Each kernel this checkout has for ``cfg``, with a context that pins
    ``kernel_for`` to it: in f32 with hidden layers past the shared-memory
    kernel both the cooperative and the wide kernel (``_F32_COOP_FROM``
    moved), else the one ``kernel_for`` picks (a checkout without the
    cooperative kernel: the wide one)."""
    import contextlib

    @contextlib.contextmanager
    def at(width):
        old = cgv._F32_COOP_FROM
        cgv._F32_COOP_FROM = width
        try:
            yield
        finally:
            cgv._F32_COOP_FROM = old

    if (hasattr(cgv, "_F32_COOP_FROM") and cgv.pick_mode(cfg) == "f32" and cfg.has_hidden
            and not cgv.fits(cfg)):
        return [("generate_cl_vae_coop", at(0)), ("generate_cl_vae_wide", at(1 << 30))]
    return [(cgv.kernel_for(cfg), contextlib.nullcontext())]


def _wide_vae(reps):
    import torch

    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    dev = torch.device("cuda", 0)
    B, nsteps = 64, 256
    coop = hasattr(cgv, "coop_plan")  # this checkout has the cooperative kernel
    sweep = [(88, H, 4, True, m) for H in (256, 512, 1024) for m in ("f32", "bf16")]
    sweep += [(1024, H, 16, False, m) for H in (1024, 5120) for m in ("f32", "bf16")]
    sweep += [(1024, 5120, 16, True, "bf16")]
    for D, H, L, use_xp, mode in sweep:
        params, cfg, seeds, eps, u, ws = _wide_problem(D, H, L, use_xp, mode, B, nsteps)
        shape = dict(D=D, H=H, L=L, use_x_prev=use_xp, mode=mode, B=B, nsteps=nsteps)
        run = lambda zp=False: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps,
                                                                  u, ws, use_z_prior=zp)
        # every kernel this checkout has for the config (the routing sweep),
        # then the one kernel_for picks
        for kernel, pin in _pinned(cgv, cfg):
            with pin:
                _line("cl_vae generation, the routing sweep", run, max(1, reps // 2),
                      kernel=kernel, **shape)
        _line("cl_vae generation", run, max(1, reps // 2), kernel=cgv.kernel_for(cfg), **shape)
        if (D, H, use_xp, mode) != (1024, 5120, False, "bf16"):
            continue
        _line("cl_vae generation, use_z_prior", lambda: run(True), max(1, reps // 2),
              kernel=cgv.kernel_for(cfg), **shape)
        print(json.dumps({"name": "cl_vae generation buckets", **shape,
                          "kernel": cgv.kernel_for(cfg),
                          "ms": _buckets(cgv, params, cfg, seeds, eps, u, ws, reps)}), flush=True)
        if not coop:
            continue
        parts = cgv.phase_ms(params, cfg, seeds, nsteps, eps, u, ws, mode=mode)
        print(json.dumps({"name": "cl_vae generation, parts of a call", **shape,
                          "parts_ms": {k: round(v, 4) for k, v in parts.items()}}), flush=True)
        plan = cgv.coop_plan(cfg, B, torch.cuda.get_device_properties(dev).multi_processor_count,
                             mode)
        pack = lambda: cgv.pack_coop(cgv._pack(params, cfg, ws, mode), cfg, plan["nu"],
                                     plan["G"], plan["P"], plan["hs"])
        _line("cl_vae generation pack (the operands and the per-block packing)", pack, reps,
              layout=list(plan["res"]), **shape)


def _buckets(cgv, params, cfg, seeds, eps, u, ws, reps):
    """ms a call at the serving buckets, 1, 4, 16, 64 songs x 32 ... 256
    steps, through the kernel ``kernel_for`` picks."""
    return {f"{b}x{n}": round(_time(lambda: cgv.generate_cl_vae_batch_cuda(
        params, cfg, seeds[:b].contiguous(), n, eps[:b, :n].contiguous(),
        u[:b, :n].contiguous(), ws[:b].contiguous()), max(1, reps // 3)), 3)
        for b in (1, 4, 16, 64) for n in (32, 64, 128, 256)}


def _wide_vae_buckets(reps):
    """The routing rule at the serving buckets: D=88, L=4 with x_prev, H =
    256 and 512, f32 and bf16, through every kernel this checkout has for
    the config."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    for H in (256, 512):
        for mode in ("f32", "bf16"):
            params, cfg, seeds, eps, u, ws = _wide_problem(88, H, 4, True, mode, 64, 256)
            for kernel, pin in _pinned(cgv, cfg):
                with pin:
                    print(json.dumps({"name": "cl_vae generation buckets, the routing sweep",
                                      "D": 88, "H": H, "L": 4, "use_x_prev": True,
                                      "mode": mode, "kernel": kernel,
                                      "ms": _buckets(cgv, params, cfg, seeds, eps, u, ws,
                                                     reps)}), flush=True)


def _cluster_shapes():
    """The cl_vae generation shapes of the cluster kernel's redesign, 64
    songs x 256 steps: the trained jsball_vae (f32, D=H=88, L=4, x_prev),
    and seeded glorot weights at D=88, L=4, x_prev: bf16 H=256, f32 H=256,
    and without hidden layers (f32)."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    dev = torch.device("cuda", 0)
    B, nsteps = 64, 256
    raw, cfg, _ = common.load_model("artifacts/jsball_vae.npz", "cl_vae")
    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(a).to(dev)
    seeds = t((rng.random((B, 88)) < 0.1).astype(np.float32))
    jsball = (params_from_numpy(raw, dev), cfg, seeds,
              t(rng.standard_normal((B, nsteps, cfg.latent_dim)).astype(np.float32)),
              t(rng.random((B, nsteps, 88)).astype(np.float32)),
              torch.eye(cfg.n_classes, device=dev)[torch.arange(B, device=dev) % cfg.n_classes])
    yield "f32 jsball_vae", jsball
    for label, H, mode in (("bf16 H=256", 256, "bf16"), ("f32 H=256", 256, "f32"),
                           ("no hidden", 0, "f32")):
        yield label, _wide_problem(88, H, 4, True, mode, B, nsteps)


def _coop_pinned(cgv):
    """A context that routes every config with hidden layers to the
    cooperative kernel: in a checkout with the cluster kernel, one that
    holds nothing (``fits``); in its parent, the routing width
    ``_F32_COOP_FROM`` at 0 (bf16 went there already)."""
    import contextlib

    @contextlib.contextmanager
    def pinned():
        name = "fits" if hasattr(cgv, "cluster_plan") else "_F32_COOP_FROM"
        old = getattr(cgv, name)
        setattr(cgv, name, (lambda cfg, mode=None: False) if name == "fits" else 0)
        try:
            yield
        finally:
            setattr(cgv, name, old)

    return pinned()


def _cluster_vae(reps):
    """The shapes of :func:`_cluster_shapes` through the kernel ``kernel_for``
    picks (CUDA events and device time), the jsball_vae serving buckets, and
    the cooperative kernel at the routing sweep's widths (f32 at D=88, H =
    256, 512, 1,024; bf16 at H=512; 64 x 256), pinned to it
    (:func:`_coop_pinned`)."""
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    nsteps = 256
    for label, (params, cfg, seeds, eps, u, ws) in _cluster_shapes():
        run = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
        _line(f"cl_vae generation {label}", run, 4 * reps, kernel=cgv.kernel_for(cfg),
              B=seeds.shape[0], nsteps=nsteps)
        if label == "f32 jsball_vae":
            print(json.dumps({"name": "cl_vae generation buckets f32 jsball_vae",
                              "kernel": cgv.kernel_for(cfg),
                              "ms": _buckets(cgv, params, cfg, seeds, eps, u, ws, 3 * reps)}),
                  flush=True)

    for H, mode in ((256, "f32"), (512, "f32"), (1024, "f32"), (512, "bf16")):
        params, cfg, seeds, eps, u, ws = _wide_problem(88, H, 4, True, mode, 64, nsteps)
        run = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, nsteps, eps, u, ws)
        with _coop_pinned(cgv):
            kernel = cgv.kernel_for(cfg)
            if kernel == "generate_cl_vae_coop":
                _line("cl_vae generation, the cooperative kernel", run, reps, kernel=kernel, D=88,
                      H=H, mode=mode, B=64, nsteps=nsteps)


def _plan_fields(cgv, cfg, B):
    """The plan the wrapper launches on this card, and the clusters of it
    that the card holds at once."""
    import torch

    dev = torch.device("cuda", 0)
    mode = cgv.pick_mode(cfg)
    p = cgv.launch_plan(cfg, B, mode, dev)
    return {**{k: p[k] for k in ("C", "T", "regs", "clusters", "waves")},
            "at_once": cgv._max_clusters(dev, mode)(p)}


def _cluster_vae_sweep(reps):
    """The routing rule, in a checkout with the cluster kernel: at D=88, L=4
    with x_prev, f32 H = 256, 512, 1,024 and bf16 H=512, the serving buckets
    (1, 4, 16, 64 songs x 32 ... 256 steps) through the cluster kernel and
    through the cooperative kernel (:func:`_coop_pinned`); then f32 at
    H = 512 and 1,024 (4 and 8 blocks a cluster) at 64 x 256, and jsball_vae
    at 64 x 256 and at 300 x 64 (past one wave of the card), each with the
    plan it launches."""
    import contextlib

    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    if not hasattr(cgv, "launch_plan"):
        print(json.dumps({"name": "cl_vae routing sweep", "skipped": "no cluster kernel"}))
        return
    for H, mode in ((256, "f32"), (512, "f32"), (1024, "f32"), (512, "bf16")):
        params, cfg, seeds, eps, u, ws = _wide_problem(88, H, 4, True, mode, 64, 256)
        for pin in (contextlib.nullcontext(), _coop_pinned(cgv)):
            with pin:
                print(json.dumps({"name": "cl_vae routing sweep", "D": 88, "H": H, "mode": mode,
                                  "kernel": cgv.kernel_for(cfg),
                                  "ms": _buckets(cgv, params, cfg, seeds, eps, u, ws, reps)}),
                      flush=True)
    for H in (512, 1024):  # 4 and 8 blocks a cluster, f32
        params, cfg, seeds, eps, u, ws = _wide_problem(88, H, 4, True, "f32", 64, 256)
        run = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds, 256, eps, u, ws)
        _line("cl_vae generation, the cluster kernel", run, reps, H=H, B=64, nsteps=256,
              plan=_plan_fields(cgv, cfg, 64))
    shapes = dict(_cluster_shapes())
    params, cfg, seeds, eps, u, ws = shapes["f32 jsball_vae"]
    for B, nsteps in ((64, 256), (300, 64)):
        if B > seeds.shape[0]:
            rep = -(-B // seeds.shape[0])
            seeds, eps, u, ws = (x.repeat(rep, *([1] * (x.dim() - 1)))[:B].contiguous()
                                 for x in (seeds, eps, u, ws))
        run = lambda: cgv.generate_cl_vae_batch_cuda(params, cfg, seeds[:B], nsteps,
                                                     eps[:B, :nsteps].contiguous(),
                                                     u[:B, :nsteps].contiguous(), ws[:B])
        _line("cl_vae generation, the cluster kernel", run, 4 * reps, B=B, nsteps=nsteps,
              plan=_plan_fields(cgv, cfg, B))


def _lstm_f32_fwd(reps):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    dev = torch.device("cuda", 0)
    H, IN, T = 256, 105, 16
    for B in (200, 12800):
        rng = np.random.default_rng(SEED + B)
        f = lambda *s, scale=1.0: torch.from_numpy(
            (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
        x = torch.cat([(torch.rand(T, B, 88, generator=torch.Generator().manual_seed(B))
                        < 0.1).float().to(dev), f(T, B, IN - 88, scale=0.5)], -1).contiguous()
        w, b, rk = f(IN, 4 * H, scale=0.1), f(4 * H, scale=0.1), f(H, 4 * H, scale=0.06)
        h0 = c0 = torch.zeros(B, H, device=dev)
        xz = (x.reshape(T * B, IN) @ w + b).reshape(T, B, 4 * H)
        shape = dict(B=B, T=T, H=H, IN=IN)
        calls = {"inference forward": lambda: ls.lstm_seq_fwd(x, w, b, rk, h0, c0),
                 "xz inference forward": lambda: ls.lstm_seq_xz_fwd(xz, rk, h0, c0)}
        if B == 200:
            calls.update({
                "training forward": lambda: ls.lstm_seq_train_fwd(x, w, b, rk, h0, c0),
                "xz training forward": lambda: ls.lstm_seq_xz_train_fwd(xz, rk, h0, c0)})
        plan = {}
        if hasattr(ls, "card_plan"):  # this checkout's layout
            plan = {"plan": {k: int(v) for k, v in ls.card_plan(B, IN, H, dev).items()}}
        for name, fn in calls.items():
            _line(f"lstm f32 {name}", fn, reps, **shape, **plan)


PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3


def _bound(fmas, nbytes, peak=PEAK_BF16_FLOPS):
    """``chip_smoke.roofline_ms``: the larger of the operations (2 a FMA) over
    the peak rate and the bytes (each input read once, each output written
    once) over HBM bandwidth, in ms, and which one it is."""
    t_ops, t_bytes = 2 * fmas / peak, nbytes / PEAK_HBM_BYTES
    return round(max(t_ops, t_bytes) * 1e3, 4), "operations" if t_ops >= t_bytes else "bytes"


def _rungs_bf16(reps):
    """The bf16 kernels of the non-default rungs at phase 28's shape (B=200,
    T=16, H=256, the encoder's IN=101): the unfused inference and training
    forwards (``pallas_lstm.py:387`` / ``:414``, ``:1070``) on xz = x @ W +
    b rounded as ``lstm_sequence_pallas`` hoists it, the dz-only walk and
    the drk walk (``:1251``, ``:1306``) on the plain forward's residuals;
    each beside its plain version and its bound at the bf16 rate."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops.lstm import bf16_operand

    dev = torch.device("cuda", 0)
    B, T, IN, H = 200, 16, 101, 256
    rng = np.random.default_rng(SEED + 28)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(dev)
    x = ((torch.rand(T, B, IN, generator=torch.Generator().manual_seed(SEED)) < 0.1).float()
         .to(dev).bfloat16())
    w, b, rk = f(IN, 4 * H, scale=0.1), f(4 * H, scale=0.1), f(H, 4 * H, scale=0.06).bfloat16()
    h0 = c0 = torch.zeros(B, H, device=dev)
    xz = (x.float() @ bf16_operand(w) + b).bfloat16().contiguous()
    xins = (xz, rk, h0, c0)
    h, c, z = ls.lstm_seq_xz_train_fwd_plain(*xins)
    dh = f(*h.shape, scale=1e-2)
    dc = torch.zeros_like(dh)
    dc[-1] = f(B, H, scale=1e-2)
    cp, hp = torch.cat([c0[None], c[:-1]]), torch.cat([h0[None], h[:-1]]).to(z.dtype)
    res = (z, cp, c, hp, dh, dc, rk.T.contiguous())
    walk_res = res[:3] + res[4:]
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    fwd_fmas, walk_fmas = T * B * H * 4 * H, T * B * 4 * H * H
    cases = {
        "xz_fwd (:387 / :414)": (ls.lstm_seq_xz_fwd, ls.lstm_seq_xz_fwd_plain, xins, fwd_fmas),
        "xz_train_fwd (:1070)": (ls.lstm_seq_xz_train_fwd, ls.lstm_seq_xz_train_fwd_plain, xins,
                                 fwd_fmas),
        "walk (:1251)": (ls.lstm_seq_walk, ls.lstm_seq_walk_plain, walk_res, walk_fmas),
        "walk_drk (:1306)": (ls.lstm_seq_walk_drk, ls.lstm_seq_walk_drk_plain, res,
                             2 * walk_fmas),
    }
    for name, (kernel, plain, ins, fmas) in cases.items():
        got, want = kernel(*ins), plain(*ins)
        err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, want))
        bound, by = _bound(fmas, nb(ins) + nb(got))
        print(json.dumps({"name": f"lstm bf16 {name}", "B": B, "T": T, "H": H, "IN": IN,
                          "ms": round(_time(lambda: kernel(*ins), reps), 4),
                          "device_ms": _device_ms(lambda: kernel(*ins)),
                          "plain_ms": round(_time(lambda: plain(*ins), reps), 4),
                          "bound_ms": bound, "bound_by": by, "max_abs_err": err}), flush=True)


def _generation_plain(reps):
    """The plain version of bf16 cl_vrnn generation at the kernel row's
    shapes (64 songs x (32 + 256) steps, u = 1, probabilities; seeded glorot
    weights at H=512, L=8, 10 keys and H=1,536 and 2,048, L=2, 13 keys, as
    ``_generation``), beside the kernel on the same inputs."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    dev = torch.device("cuda", 0)
    B, Tseed, nsteps, D = 64, 32, 256, 88
    rng = np.random.default_rng(SEED)
    seeds = torch.from_numpy((rng.random((B, Tseed, D)) < 0.1).astype(np.float32)).to(dev)
    for H, L, K in ((512, 8, 10), (1536, 2, 13), (2048, 2, 13)):
        cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=16,
                             n_classes=K, use_x_prev=True, bf16_compute=True)
        params = _glorot_params(rng, D, H, L, K, dev)
        eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, L)).astype(np.float32))
        eps, u = eps.to(dev), torch.ones((B, Tseed + nsteps, D), device=dev)
        ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
        run = lambda fn: fn(params, cfg, seeds, nsteps, eps, u, ws,  # noqa: E731
                            return_probs=True, mode="bf16")
        pk, pp = run(cg.generate_cl_vrnn_batch_cuda), run(cg.generate_cl_vrnn_batch_plain)
        print(json.dumps({"name": "generation bf16 plain", "B": B, "Tseed": Tseed,
                          "nsteps": nsteps, "H": H,
                          "plain_ms": round(_time(lambda: run(cg.generate_cl_vrnn_batch_plain),
                                                  max(1, reps // 2)), 3),
                          "ms": round(_time(lambda: run(cg.generate_cl_vrnn_batch_cuda), reps), 4),
                          "max_abs_err": (pk - pp).abs().max().item()}), flush=True)


PARTS = {"two_cell": lambda reps, root: _two_cell(reps),
         "cluster_vae": lambda reps, root: _cluster_vae(reps),
         "cluster_vae_sweep": lambda reps, root: _cluster_vae_sweep(reps),
         "generation": lambda reps, root: _generation(reps, root),
         "vae_dense": lambda reps, root: _vae_dense(reps),
         "vae_dense_f32": lambda reps, root: _vae_dense_f32(reps),
         "int8_vae": lambda reps, root: _int8_vae(reps),
         "wide_vae": lambda reps, root: _wide_vae(reps),
         "wide_vae_buckets": lambda reps, root: _wide_vae_buckets(reps),
         "lstm_f32_fwd": lambda reps, root: _lstm_f32_fwd(reps),
         "rungs_bf16": lambda reps, root: _rungs_bf16(reps),
         "generation_plain": lambda reps, root: _generation_plain(reps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout whose package to run (default: this one)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {', '.join(PARTS)} (default: all)")
    ap.add_argument("--against", help="a parent checkout: run the parts in turns, PARENT, this "
                                      "checkout, this checkout, PARENT, one process each")
    a = ap.parse_args(argv)
    here = Path(__file__).resolve().parents[1]
    if a.against:
        for n, turn in enumerate((a.against, here, here, a.against)):
            print(f"--- turn {n + 1}: {Path(turn).resolve()}", flush=True)
            cmd = [sys.executable, __file__, "--root", str(turn), "--reps", str(a.reps),
                   "--parts", a.parts]
            if subprocess.run(cmd).returncode:
                return 1
        return 0
    root = str(Path(a.root or here).resolve())
    sys.path.insert(0, root)
    import torch

    import classifying_vae_lstm_tpu_torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"package: {Path(classifying_vae_lstm_tpu_torch.__file__).parent}", flush=True)
    for part in a.parts.split(","):
        PARTS[part](a.reps, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
