#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (the kernels are
built from ``classifying_vae_lstm_tpu_torch/csrc`` into
``build/torch_kernels/``). Imports nothing of JAX. Phases, each fatal on
failure:

1. the card's name and power limit; build every kernel source (one nvcc per
   source, started together), timed, with the compiler's register report;
2. kernel vs plain version, f32, on the trained ``artifacts/jsball_vrnn4``
   weights at the largest serving bucket (64 songs, 32 seed + 256 steps):
   probabilities with u=1 within 1e-5, and sampled frames equal up to each
   song's first near-tie (|u - p| < 1e-4 in the plain run); kernel and plain
   times with CUDA events;
3. kernel vs plain version, bf16 weights, at hidden 512 (seeded glorot-scale
   weights): probabilities with u=1, max within 2e-2, mean within 2e-3;
4. the serving path: the port's ``cli.serve`` server with
   ``--dynamic_batching --warmup full`` answers /generate requests (a burst
   among them) over HTTP; the launch counts are set to 0 just before and read
   just after, and the plain version must not run on a CUDA tensor;
5. the two-cell training kernels vs their plain versions at the full
   training shape (B=200, T=16, H=256, L=8, K=13, use_x_prev; the
   ``jsball_vrnn4`` weights with seeded rows for 13 keys): forward hd and
   zargs within 1e-5, every backward output within 1e-4 * max|plain| + 1e-6;
   kernel and plain times with CUDA events beside each kernel's bound;
6. the training path: the port's ``cli.cl_vrnn_train`` trains 3 epochs on
   the committed corpus at the jsball_vrnn4 width through
   ``--lstm_backend pallas``; the two-cell counts are set to 0 just before and
   read just after and must equal the run's own steps (one forward launch per
   train and eval batch, two backward launches per train batch), losses must
   be finite and fall, and the plain versions must not run on CUDA tensors;
   then a training step's time split (forward, backward, optimizer; a
   profiler's per-kernel device time where it records one);
7. the checkpoint that run wrote loads into the port's ``GenerationEngine``
   and generates songs through the generation kernel;
8. the whole-sequence LSTM kernels (inference forward, training forward,
   backward) vs their plain versions: all three at the training shape
   (B=200, T=16, H=256, the ``jsball_vrnn4`` encoder and decoder weights with
   seeded rows for 13 keys), the inference forward at the evaluation shape
   (64 importance samples x 200 windows = 12,800 rows, the trained weights);
   forward outputs within 1e-5, backward outputs within 1e-4 * max|plain| +
   1e-6; kernel and plain times with CUDA events beside each kernel's bound;
9. the ``--two_cell off`` training path: ``cli.cl_vrnn_train --lstm_backend
   pallas --two_cell off`` for 2 epochs from phase 6's seed; the LSTM kernel
   counts are set to 0 just before and read just after and must equal the
   run's own steps (per train batch 2 training-forward and 4 backward
   launches, per eval batch 2 inference-forward launches; two-cell counts
   0), losses finite and falling, the first epoch's train loss equal to
   phase 6's within 1e-3 relative, and no plain version on CUDA tensors;
10. the evaluation path: ``cli.evaluate`` of ``artifacts/jsball_vrnn4`` on
   ``Piano-midi_Cs`` (4,468 test windows, 64 samples, batches of 200)
   through ``--lstm_backend pallas`` (46 inference-forward launches, counts
   set to 0 just before), then ``xla`` (plain PyTorch on the card, same
   seed): the two NLLs within 1e-4; a profile of one evaluation batch; then
   phase 9's checkpoint evaluated on ``Piano-midi_all``;
11. the cl_vae generation kernel vs its plain version, f32, on the trained
   ``artifacts/jsball_vae`` weights (D=H=88, L=4, K=10, use_x_prev) at the
   largest serving bucket (64 single-frame seeds, 256 steps), with and
   without ``use_z_prior``: probabilities with u=1 within 1e-5, frames equal
   up to each song's first near-tie; kernel and plain times with CUDA events
   beside the bound; then bf16 weights at hidden 256 (seeded glorot-scale
   weights, where f32 ones would not fit shared memory): probabilities with
   u=1, max within 2e-2, mean within 2e-3;
12. cl_vae serving: the port's ``cli.serve`` on ``jsball_vae`` with
   ``--dynamic_batching --warmup full`` answers /generate over HTTP (solo,
   key-filtered and MIDI-seeded requests, a burst of 8); the cl_vae launch
   count, set to 0 just before and read just after, must equal the engine's
   device calls, and the plain version must not run on a CUDA tensor;
13. both sample CLIs: ``cli.cl_vae_sample`` (``jsbcs_vae`` on
   ``Piano-midi_Cs``, true keys, 8 songs x 64 frames) and
   ``cli.cl_vrnn_sample`` (``jsball_vrnn4``, ``--infer_w``, 4 songs) write
   their MIDI files with exactly one launch of their kernel each;
14. the dense-stack cl_vae training kernels (forward; backward = row pass +
   weight-gradient pass) vs their plain versions at the training shape
   (B=100, the ``jsball_vae`` weights with seeded rows for 13 keys,
   use_x_prev) and at the seq-concat width (D=976, Cw=256, H=1024, L=16,
   K=13, B=1024, seeded glorot weights): forward outputs within 1e-5 x
   max(1, max|plain|), every backward output within 1e-4 * max|plain| +
   1e-6; kernel and plain (cuBLAS products) times with CUDA events beside
   each kernel's bound;
15. the cl_vae training path: ``cli.cl_vae_train --train_backend pallas``
   for 3 epochs on the committed corpus (13 keys) at the jsball_vae width;
   the dense-stack counts are set to 0 just before and read just after and
   must equal the run's own steps (per train batch one forward and two
   backward launches, per eval batch one forward), losses finite and
   falling, no plain version on CUDA tensors; a step's time split; then one
   ``xla`` epoch from the same seed, its first-epoch loss within 1e-3
   relative of the kernel run's;
16. ``cli.evaluate --family cl_vae`` of ``artifacts/jsbcs_vae`` on
   ``Piano-midi_Cs`` (its whole test split, 64 samples, batches of 200) and
   of phase 15's checkpoint on the training corpus; ``cli.cl_vae_sample`` on
   that checkpoint with true keys, one generation launch.

The last lines are the kernel table (one JSON object), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 0
MODEL = "artifacts/jsball_vrnn4.npz"
VAE_MODEL = "artifacts/jsball_vae.npz"
CORPUS = "data/input/Piano-midi_all.pickle"
EVAL_CORPUS = "data/input/Piano-midi_Cs.pickle"  # keys 0 and 1: jsball_vrnn4 has 10
EVAL_WINDOWS, EVAL_SAMPLES, EVAL_B = 4468, 64, 200  # its test split at T=16
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TRAIN_B, TRAIN_T, TRAIN_K = 200, 16, 13  # the training path's batch, window, key classes
LSTM_SEQ_PLAIN = ("lstm_seq_fwd_plain", "lstm_seq_train_fwd_plain", "lstm_seq_bwd_plain")


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 1) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seed_windows(n: int):
    import numpy as np

    from classifying_vae_lstm_tpu_torch.data import PianoData

    P = PianoData(CORPUS, batch_size=1, seq_length=32, squeeze_x=False)
    idx = np.random.default_rng(SEED).choice(len(P.x_test), size=n, replace=False)
    return P.x_test[idx]


def frames_agree_to_near_tie(label, fk, fp, u, probs):
    """Kernel frames ``fk`` equal the plain frames ``fp`` ([B, nsteps, D])
    in every song up to its first near-tie, a step where some |u - p| < 1e-4
    in the plain run (``probs``): there the two summation orders may rightly
    draw another frame, and the songs part."""
    import torch

    B, nsteps = fk.shape[:2]
    require(set(torch.unique(fk).tolist()) <= {0.0, 1.0}, "kernel frames not binary")
    near = ((u - probs).abs() < 1e-4).any(dim=2)  # [B, nsteps]
    diff = (fk != fp).any(dim=2)
    first = lambda m: torch.where(m.any(1), m.float().argmax(1), torch.full_like(m[:, 0], nsteps,
                                                                                 dtype=torch.long))
    t_tie, t_diff = first(near), first(diff)
    bad = (t_diff < t_tie).nonzero().flatten().tolist()
    whole = int((t_diff == nsteps).sum().item())
    print(f"{label}: {whole}/{B} songs agree wholly; {int((t_tie < nsteps).sum())} songs "
          f"have a near-tie (median first near-tie at step {int(t_tie.median())}); "
          f"songs diverging before their first near-tie: {bad}")
    require(not bad, f"songs {bad} diverge before a near-tie")


def roofline_ms(fmas: float, nbytes: float) -> tuple[float, str]:
    """Least time for a call: the larger of its f32 operations (2 per FMA)
    over the card's f32 rate and its bytes over HBM bandwidth."""
    t_ops, t_bytes = 2 * fmas / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(cfg, B, Tseed, nsteps, weight_bytes) -> tuple[float, str]:
    """Least time for one call: the larger of its f32 FMAs over the card's f32
    rate and its bytes (each input read once, the output written once) over
    HBM bandwidth. The w folds are computed outside the kernel."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    total, n_xp = Tseed + nsteps, (D if cfg.use_x_prev else 0)
    per_song_step = 2 * ((D + H) * 4 * H + H * 2 * L + (H + L + n_xp) * 4 * H + H * D)
    flops = B * total * per_song_step
    stream_bytes = 4 * (B * Tseed * D + B * total * (L + D) + 2 * B * 4 * H
                        + 2 * L + D + B * nsteps * D)
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = (stream_bytes + weight_bytes) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from classifying_vae_lstm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=["-Xptxas", "-v"])
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"--- nvcc csrc/{name}.cu ---\n{log.strip()}")
    print(f"kernel build: {build_s:.2f} s for {sorted(logs) or 'no sources (already built)'}")
    require(set(_build.sources()) == {"generate_cl_vae", "generate_cl_vrnn", "lstm_seq",
                                      "two_cell", "vae_dense"}, f"sources {_build.sources()}")


def phase_f32(dev):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.sampling import infer_w_cl_vrnn
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg, _ = common.load_model(MODEL, "cl_vrnn")
    params = params_from_numpy(raw, dev)
    B, Tseed, nsteps = 64, 32, 256
    total = Tseed + nsteps
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    ws = infer_w_cl_vrnn(params, cfg, seeds)
    rng = np.random.default_rng(SEED)
    eps = torch.from_numpy(rng.standard_normal((B, total, cfg.latent_dim), dtype=np.float32)).to(dev)
    u_np = rng.random((B, total, cfg.original_dim), dtype=np.float32)
    # the seed phase's draws are discarded except the last one's, which feeds
    # the first free step; pinning them makes every near-tie visible in the
    # returned (post-seed) probabilities
    u_np[:, :Tseed] = 1.0
    u = torch.from_numpy(u_np).to(dev)
    u1 = torch.ones_like(u)

    kern = lambda uu, rp: cg.generate_cl_vrnn_batch_cuda(params, cfg, seeds, nsteps, eps, uu, ws,
                                                         return_probs=rp)
    plain = lambda uu, rp: cg.generate_cl_vrnn_batch_plain(params, cfg, seeds, nsteps, eps, uu,
                                                           ws, return_probs=rp)
    pk, pp = kern(u1, True), plain(u1, True)
    torch.cuda.synchronize()
    err = (pk - pp).abs().max().item()
    require(torch.isfinite(pk).all().item() and pk.shape == (B, nsteps, cfg.original_dim),
            "kernel probabilities not finite or misshapen")
    print(f"f32 probs, u=1: max |kernel - plain| = {err:.3e} (limit 1e-5)")
    require(err <= 1e-5, f"f32 probabilities differ by {err}")

    fk, fp, probs = kern(u, False), plain(u, False), plain(u, True)
    torch.cuda.synchronize()
    frames_agree_to_near_tie("f32 frames", fk, fp, u[:, Tseed:], probs)

    k_ms = time_ms(lambda: kern(u, False), reps=10, warm=2)
    p_ms = time_ms(lambda: plain(u, False), reps=3, warm=1)
    w = cg._pack(params, cfg, ws, cfg.original_dim, "f32")
    wbytes = sum(w[k].numel() * w[k].element_size()
                 for k in ("wke_x", "rke", "wz_t", "wkd_x", "wkd_z", "rkd", "wx_t"))
    b_ms, b_by = bound_ms(cfg, B, Tseed, nsteps, wbytes)
    print(f"f32 kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}) "
          f"at B={B} Tseed={Tseed} nsteps={nsteps} H={cfg.intermediate_dim}")
    grid = {}  # the serving buckets (songs x steps), each after a warm-up launch
    for b in (1, 4, 16, 64):
        for t in (32, 64, 128, 256):
            args = [x[:b, : Tseed + t].contiguous() for x in (seeds, eps, u)]
            wb = ws[:b].contiguous()
            grid[f"{b}x{t}"] = round(time_ms(lambda: cg.generate_cl_vrnn_batch_cuda(
                params, cfg, args[0], t, args[1], args[2], wb), reps=5), 3)
    print(f"f32 kernel ms per serving bucket (songs x steps): {json.dumps(grid)}")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_bf16(dev):
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    D, H, L, K = 88, 512, 8, 10
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=16,
                         n_classes=K, use_x_prev=True, bf16_compute=True)
    rng = np.random.default_rng(SEED + 1)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    raw = {
        "encoder_h": {"kernel": glorot(D + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "decoder_h": {"kernel": glorot(D + L + K, 4 * H), "recurrent_kernel": glorot(H, 4 * H),
                      "bias": np.zeros(4 * H, np.float32)},
        "Z_mean": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "Z_log_var": {"kernel": glorot(H, L), "bias": np.zeros(L, np.float32)},
        "X_decoded_mean": {"kernel": glorot(H, D), "bias": np.zeros(D, np.float32)},
    }
    params = params_from_numpy(raw, dev)
    B, Tseed, nsteps = 64, 32, 256
    seeds = torch.from_numpy(seed_windows(B)).to(dev)
    ws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    eps = torch.from_numpy(rng.standard_normal((B, Tseed + nsteps, L), dtype=np.float32)).to(dev)
    u1 = torch.ones((B, Tseed + nsteps, D), device=dev)
    run = lambda f: f(params, cfg, seeds, nsteps, eps, u1, ws, return_probs=True, mode="bf16")
    pk, pp = run(cg.generate_cl_vrnn_batch_cuda), run(cg.generate_cl_vrnn_batch_plain)
    torch.cuda.synchronize()
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    k_ms = time_ms(lambda: run(cg.generate_cl_vrnn_batch_cuda), reps=5)
    print(f"bf16 H={H} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} (limit 2e-3); "
          f"kernel {k_ms:.3f} ms")
    require(torch.isfinite(pk).all().item(), "bf16 kernel probabilities not finite")
    require(mx <= 2e-2 and mean <= 2e-3, f"bf16 probabilities differ: max {mx}, mean {mean}")


def exercise_server(httpd, extra=()):
    """Serve ``httpd`` in a thread and drive /generate as a client would:
    /healthz, a rolls, a MIDI and a key-filtered request, the ``extra``
    (label, body) rolls requests, then a burst of 8 concurrent requests.
    Returns /stats and each request's ms on the client's clock (HTTP and
    JSON included); shuts the server down."""
    import base64

    import numpy as np

    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    client_ms = {}

    def post(body, label):
        req = urllib.request.Request(f"{url}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            require(r.status == 200, f"{label} -> HTTP {r.status}")
            out = json.load(r)
        client_ms[label] = (time.perf_counter() - t0) * 1e3
        return out

    def check_rolls(out, n, t):
        rolls = np.asarray(out["rolls"])
        require(rolls.shape == (n, t, 88), f"rolls shape {rolls.shape} != {(n, t, 88)}")
        require(set(np.unique(rolls).tolist()) <= {0, 1}, "rolls not binary")

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            require(json.load(r)["ok"], "/healthz")
        check_rolls(post({"n": 4, "t": 64}, "4x64"), 4, 64)
        out = post({"n": 16, "t": 128, "format": "midi_base64"}, "16x128 midi")
        require(len(out["midi_base64"]) == 16
                and all(base64.b64decode(m)[:4] == b"MThd" for m in out["midi_base64"]),
                "midi_base64 response")
        check_rolls(post({"n": 1, "t": 32, "key": "C"}, "1x32 key C"), 1, 32)
        for label, body in extra:
            check_rolls(post(body, label), body["n"], body["t"])
        results, errors = [None] * 8, []
        barrier = threading.Barrier(8)

        def client(i):
            try:
                barrier.wait(timeout=30)
                results[i] = post({"n": 2, "t": 64}, f"burst {i}")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        require(not errors and not any(c.is_alive() for c in clients), f"burst: {errors}")
        for r in results:
            check_rolls(r, 2, 64)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
    solo = [f"{k} {v:.3f} ms" for k, v in client_ms.items() if not k.startswith("burst")]
    burst = sorted(v for k, v in client_ms.items() if k.startswith("burst"))
    print(f"client latency: {'; '.join(solo)}; burst of 8 x {{n: 2, t: 64}}: min "
          f"{burst[0]:.3f} ms, median {burst[4]:.3f} ms, max {burst[-1]:.3f} ms")
    return stats


def phase_serve():
    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    plain_on_cuda = []
    args = serve.build_parser().parse_args(
        ["-i", MODEL, "--train_file", CORPUS, "--dynamic_batching", "--warmup", "full",
         "--port", "0"])
    with sampler_plain_guard(cg, "generate_cl_vrnn_batch_plain", plain_on_cuda):
        cg.LAUNCHES = 0  # counts from here on are the main path's
        t0 = time.perf_counter()
        httpd, engine = serve.make_server(args)
        print(f"engine built and warmed in {time.perf_counter() - t0:.2f} s "
              f"({cg.LAUNCHES} warm-up launches)")
        warm_launches = cg.LAUNCHES
        stats = exercise_server(httpd)
        launches = cg.LAUNCHES
    lat = engine.latency_stats()
    print(f"/stats: requests {stats['requests']}, batches {stats['batches']}, batched_songs "
          f"{stats['batched_songs']}, gen_path {stats['gen_path']}, device {stats['device']}")
    print(f"main path launches: {launches} ({warm_launches} warm-up, "
          f"{launches - warm_launches} for {stats['requests']} requests); "
          f"latency p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms "
          f"(window {args.batch_window_ms} ms)")
    require(launches > warm_launches, "requests did not launch the kernel")
    require(stats["batches"] > 0, "the burst was not coalesced (batches == 0)")
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return launches


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_shape_weights(rng):
    """The trained ``jsball_vrnn4`` weights (as NumPy) with fresh glorot rows
    for the 13 key classes of the training corpus, and its config."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import common

    raw, cfg0, _ = common.load_model(MODEL, "cl_vrnn")
    K, K0, H = TRAIN_K, cfg0.n_classes, cfg0.intermediate_dim
    lim = np.sqrt(6.0 / (K + 4 * H))
    w_rows = lambda: rng.uniform(-lim, lim, (K, 4 * H)).astype(np.float32)
    for cell in ("encoder_h", "decoder_h"):
        raw[cell]["kernel"] = np.concatenate([raw[cell]["kernel"][:-K0], w_rows()])
    return raw, cfg0


def phase_two_cell(dev):
    """Both two-cell kernels against their plain versions at the training
    shape; returns the kernel-table fields of each."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.models import cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    B, T, K = TRAIN_B, TRAIN_T, TRAIN_K
    rng = np.random.default_rng(SEED + 2)
    raw, cfg0 = train_shape_weights(rng)
    D, H, L = cfg0.original_dim, cfg0.intermediate_dim, cfg0.latent_dim
    cfg = cl_vrnn.Config(original_dim=D, intermediate_dim=H, latent_dim=L, seq_length=T,
                         n_classes=K, use_x_prev=True, lstm_backend="pallas", two_cell=True)
    params = params_from_numpy(raw, dev)
    f = lambda a: torch.from_numpy(a).to(dev)
    x = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    xp = f((rng.random((B, T, D)) < 0.1).astype(np.float32))
    W = torch.softmax(f(rng.standard_normal((B, K)).astype(np.float32)), -1)
    eps = f(rng.standard_normal((B, T, L)).astype(np.float32))
    ins = tc.pack_inputs(params, cfg, x, xp, W, eps)

    outs = tc.two_cell_fwd(*ins)
    ref = tc.two_cell_fwd_plain(*ins)
    torch.cuda.synchronize()
    names = ("hd", "zargs", "ze", "zd", "hpe", "cpe", "ce", "he", "hpd", "cpd", "cd")
    errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, outs, ref)}
    require(all(torch.isfinite(o).all().item() for o in outs), "forward kernel output not finite")
    fwd_err = max(errs["hd"], errs["zargs"])
    print(f"two-cell forward, B={B} T={T} H={H} L={L} K={K}: max |kernel - plain| hd "
          f"{errs['hd']:.3e}, zargs {errs['zargs']:.3e} (limit 1e-5); residual streams "
          + ", ".join(f"{n} {errs[n]:.3e}" for n in names[2:]))
    require(fwd_err <= 1e-5, f"two-cell forward differs: {errs}")

    (xe, xd, eps_t, we, be, rke, wdx, bd, rkd, kz, wz, bz, *_) = ins
    hd, zargs, ze, zd, hpe, cpe, ce, he, hpd, cpd, cd = ref
    dhd = f((1e-2 * rng.standard_normal(tuple(hd.shape))).astype(np.float32))
    dza = f((1e-2 * rng.standard_normal(tuple(zargs.shape))).astype(np.float32))
    res = (ze, zd, cpe, ce, cpd, cd, hpe, he, hpd, eps_t, zargs, xe, xd, dhd, dza,
           we, rke, wdx, rkd, kz, wz)
    got = tc.two_cell_bwd(*res)
    want = tc.two_cell_bwd_plain(*res)
    torch.cuda.synchronize()
    gnames = ("dxe", "dxd", "dh0e", "dc0e", "dh0d", "dc0d", "drke", "drkd", "dwe", "dwdx", "dkz",
              "dwz", "dbe", "dbd", "dbz")
    bad, rel = [], {}
    for n, g, w in zip(gnames, got, want):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        rel[n] = err / max(scale, 1e-30)
        if not (err <= 1e-4 * scale + 1e-6 and math.isfinite(err)):
            bad.append((n, err, scale))
    bwd_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    print("two-cell backward: max |kernel - plain| / max|plain| per output: "
          + ", ".join(f"{n} {rel[n]:.2e}" for n in gnames)
          + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
    require(not bad, f"two-cell backward differs: {bad}")

    fk_ms = time_ms(lambda: tc.two_cell_fwd(*ins), reps=20, warm=2)
    fp_ms = time_ms(lambda: tc.two_cell_fwd_plain(*ins), reps=5, warm=1)
    bk_ms = time_ms(lambda: tc.two_cell_bwd(*res), reps=20, warm=2)
    bp_ms = time_ms(lambda: tc.two_cell_bwd_plain(*res), reps=5, warm=1)
    INe, INd, R = xe.shape[-1], xd.shape[-1], T * B
    weights = (we, be, rke, wdx, bd, rkd, kz, wz, bz)
    fwd_fmas = R * ((INe + H) * 4 * H + H * 2 * L + (INd + L + H) * 4 * H)
    fb_ms, fb_by = roofline_ms(fwd_fmas, _nbytes(ins) + _nbytes(outs))
    # serial chain (dz @ W^T for both cells, z head) + weight gradients and
    # column sums over the B*T rows
    bwd_fmas = R * (4 * H * (H + INd + L) + 2 * L * H + 4 * H * (H + INe)
                    + 4 * H * (2 * H + INe + INd + L + 2) + 2 * L * (H + 1))
    bb_ms, bb_by = roofline_ms(bwd_fmas, _nbytes(res) + _nbytes(got))
    print(f"two-cell forward kernel {fk_ms:.3f} ms, plain {fp_ms:.3f} ms, bound {fb_ms:.4f} ms "
          f"({fb_by}); backward kernel (2 launches) {bk_ms:.3f} ms, plain {bp_ms:.3f} ms, "
          f"bound {bb_ms:.4f} ms ({bb_by})")
    return ({"max_abs_err": fwd_err, "ms": fk_ms, "plain_ms": fp_ms, "bound_ms": fb_ms,
             "bound_by": fb_by},
            {"max_abs_err": bwd_err, "ms": bk_ms, "plain_ms": bp_ms, "bound_ms": bb_ms,
             "bound_by": bb_by})


TRAIN_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", "256", "--latent_dim", "8",
               "--seq_length", "16", "--batch_size", "200", "--use_x_prev", "--class_weight",
               "0.3", "--patience", "0", "--lstm_backend", "pallas"]


@contextlib.contextmanager
def plain_guard(module, names, record):
    """Record every call of the named plain versions on a CUDA tensor."""
    real = {n: getattr(module, n) for n in names}

    def guard(name):
        def guarded(*a):
            if a[0].is_cuda:
                record.append(name)
            return real[name](*a)
        return guarded

    for n in names:
        setattr(module, n, guard(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


@contextlib.contextmanager
def sampler_plain_guard(module, name, record):
    """Record every call of a sampler's plain version (``fn(params, cfg,
    x_seeds, ...)``) on a CUDA tensor."""
    real = getattr(module, name)

    def guarded(params, cfg, x_seeds, *a, **k):
        if x_seeds.is_cuda:
            record.append((name, tuple(x_seeds.shape)))
        return real(params, cfg, x_seeds, *a, **k)

    setattr(module, name, guarded)
    try:
        yield
    finally:
        setattr(module, name, real)


def run_train(run, flags, model_dir, reset, read, cli=None, base_flags=TRAIN_FLAGS):
    """One run of a train CLI (``cli.cl_vrnn_train`` at the jsball_vrnn4
    width unless ``cli`` and ``base_flags`` say otherwise). ``reset`` sets
    the launch counts to 0 just before the run, ``read`` returns them just
    after. Returns (args, counts, seen, per-epoch seconds, wall)."""
    import torch

    from classifying_vae_lstm_tpu_torch.cli import cl_vrnn_train
    from classifying_vae_lstm_tpu_torch.train import loop

    cli = cli or cl_vrnn_train
    seen, epoch_s = {}, []
    real_fit, real_epoch = cli.fit, loop.Trainer.train_epoch

    def fit(trainer, params, train_data, val_data, **kw):
        seen.update(trainer=trainer, train=train_data, val=val_data)
        out = real_fit(trainer, params, train_data, val_data, **kw)
        seen.update(best_params=out[1], history=out[2])
        return out

    def train_epoch(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real_epoch(self, *a, **k)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return m

    args = cli.build_parser().parse_args([run, *base_flags, *flags, "--model_dir", model_dir])
    cli.fit, loop.Trainer.train_epoch = fit, train_epoch
    reset()  # counts from here on are this training path's
    t0 = time.perf_counter()
    try:
        cli.train(args)
    finally:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        cli.fit, loop.Trainer.train_epoch = real_fit, real_epoch
    seen["ckpt"] = os.path.join(model_dir, f"{run}.npz")
    return args, counts, seen, epoch_s, wall


def _report_train(label, args, seen, epoch_s, wall):
    hist, B, E = seen["history"], args.batch_size, args.num_epochs
    n_train, n_val = (len(seen[k]["x"]) // B for k in ("train", "val"))
    print(f"{label}: {E} epochs x ({n_train} train + {n_val} eval steps) in {wall:.2f} s; "
          f"loss per epoch {[round(v, 4) for v in hist['loss']]}, val_loss "
          f"{[round(v, 4) for v in hist['val_loss']]}")
    print(f"{label}: ms per training step (host clock, epoch synchronised): "
          f"{[round(s * 1e3 / n_train, 3) for s in epoch_s]} per epoch")
    require(all(math.isfinite(v) for vals in hist.values() for v in vals), "non-finite loss")
    require(E < 2 or hist["loss"][-1] < hist["loss"][0],
            f"train loss did not fall: {hist['loss']}")
    return E, n_train, n_val


def phase_train(model_dir):
    """The training path through ``cli.cl_vrnn_train``; returns the launch
    counts, the checkpoint written and what the time split needs."""
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    def reset():
        tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0

    plain_on_cuda = []
    with plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
        args, (fwd, bwd), seen, epoch_s, wall = run_train(
            "smoke", ["--num_epochs", "3"], model_dir, reset,
            lambda: (tc.FWD_LAUNCHES, tc.BWD_LAUNCHES))
    E, n_train, n_val = _report_train("training path", args, seen, epoch_s, wall)
    print(f"training path launches: forward {fwd} (expected {E * (n_train + n_val)}), "
          f"backward {bwd} (expected {2 * E * n_train}: the reverse walk and the "
          f"weight-gradient pass per step)")
    require(fwd == E * (n_train + n_val), f"forward launches {fwd}")
    require(bwd == 2 * E * n_train, f"backward launches {bwd}")
    require(not plain_on_cuda, f"plain two-cell versions ran on CUDA tensors: {plain_on_cuda}")
    seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)
    return fwd, bwd, seen


def phase_train_two_loop(model_dir, first_loss):
    """The ``--two_cell off`` training path: both LSTMs through the
    whole-sequence kernels. Returns the training-forward and backward
    launch counts and what the run left (its checkpoint among them)."""
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    def reset():
        ls.FWD_LAUNCHES = ls.TRAIN_FWD_LAUNCHES = ls.BWD_LAUNCHES = 0
        tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0

    read = lambda: (ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES, ls.BWD_LAUNCHES, tc.FWD_LAUNCHES,
                    tc.BWD_LAUNCHES)
    plain_on_cuda = []
    with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda), \
            plain_guard(tc, ("two_cell_fwd_plain", "two_cell_bwd_plain"), plain_on_cuda):
        args, counts, seen, epoch_s, wall = run_train(
            "smoke_off", ["--num_epochs", "2", "--two_cell", "off"], model_dir, reset, read)
    E, n_train, n_val = _report_train("--two_cell off path", args, seen, epoch_s, wall)
    fwd, train_fwd, bwd, tc_fwd, tc_bwd = counts
    expected = (2 * E * n_val, 2 * E * n_train, 4 * E * n_train, 0, 0)
    print(f"--two_cell off launches: inference forward {fwd}, training forward {train_fwd}, "
          f"backward {bwd}, two-cell {tc_fwd} + {tc_bwd} (expected {expected}: 2 training "
          f"forwards and 2 x 2 backward launches per train batch, 2 inference forwards per "
          f"eval batch)")
    require(counts == expected, f"--two_cell off launches {counts} != {expected}")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: {plain_on_cuda}")
    loss0 = seen["history"]["loss"][0]
    rel = abs(loss0 - first_loss) / abs(first_loss)
    print(f"first epoch train loss: two-loop {loss0!r}, two-cell (phase 6) {first_loss!r}, "
          f"relative difference {rel:.3e} (limit 1e-3)")
    require(rel <= 1e-3, f"first-epoch losses differ by {rel}")
    margs = load_model_args(seen["ckpt"])
    require((margs["lstm_backend"], margs["two_cell"], margs["fusion"])
            == ("pallas", False, [True, True, True]), f"args.json {margs}")
    return train_fwd, bwd, seen


def phase_train_breakdown(seen, label="two-cell kernels", key="two_cell"):
    """Where a training step's time goes: CUDA events around the forward
    (loss), the backward and the optimizer step; then a profiler's device
    time per kernel, where it records one (``label``: the kernels whose
    name holds ``key``). Informational."""
    import torch

    from classifying_vae_lstm_tpu_torch.train.loop import copy_params

    trainer = seen["trainer"]
    params = copy_params(seen["best_params"], requires_grad=True)
    opt = trainer.init_optimizer(params)
    B = trainer.batch_size
    batch = {k: v[:B] for k, v in seen["train"].items()}
    gen = torch.Generator(device=batch["x"].device).manual_seed(SEED)

    def step(ev=None):
        opt.zero_grad(set_to_none=True)
        if ev:
            ev[0].record()
        loss, _ = trainer.loss_fn(params, batch, gen, 1.0, 0.3, 1.0)
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        opt.step()
        if ev:
            ev[3].record()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n, parts = 10, [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(ev)
        torch.cuda.synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / n
    wall = (time.perf_counter() - t0) * 1e3 / n
    print(f"training step at B={B}: {wall:.3f} ms (host clock, synchronised); CUDA events: "
          f"forward + loss {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, optimizer "
          f"{parts[2]:.3f} ms")
    device_profile(step, 5, wall, "step", label, key)


def _device_rows(fn, n):
    """``torch.profiler``'s device-side events over n calls of ``fn`` (host
    ranges and their device-side annotations report the same device time
    again, so they are left out) and their device time in µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=dev_us, reverse=True), dev_us


def device_profile(fn, n, wall_ms, unit, label, key):
    """Device time per call of ``fn`` from ``torch.profiler`` over n calls:
    busy share against ``wall_ms`` and the time of the kernels whose name
    holds ``key``. Informational: prints "not measured" where the profiler
    records no device time."""
    try:
        rows, dev_us = _device_rows(fn, n)
        if not rows:
            print("profiler: no device time recorded (device busy share not measured)")
            return
        busy = sum(dev_us(e) for e in rows) / (n * 1e3)
        ours = sum(dev_us(e) for e in rows if key in e.key) / (n * 1e3)
        print(f"profiler, per {unit}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
              f"({100 * (1 - busy / wall_ms):.1f}% idle), {label} {ours:.3f} ms, "
              f"{sum(e.count for e in rows) // n} device events; top: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / (n * 1e3):.3f} ms x{e.count // n}"
                          for e in rows[:8]))
    except Exception as e:  # noqa: BLE001 — the caller's numbers stand without it
        print(f"profiler: not measured ({e!r})")


def device_ms_per_call(fn, n, key):
    """(device ms per call of the kernels whose name holds ``key``, device
    ms per call of all kernels) from ``torch.profiler`` over n calls of
    ``fn`` after one warm-up call; None where it records no device time."""
    import torch

    try:
        fn()
        torch.cuda.synchronize()
        rows, dev_us = _device_rows(fn, n)
        if not rows:
            return None
        per = lambda es: sum(dev_us(e) for e in es) / (n * 1e3)
        return per(e for e in rows if key in e.key), per(rows)
    except Exception as e:  # noqa: BLE001 — the CUDA-event times stand without it
        print(f"profiler: not measured ({e!r})")
        return None


def phase_checkpoint_serves(ckpt):
    """The trained checkpoint serves through the generation kernel."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    args = serve.build_parser().parse_args(["-i", ckpt, "--train_file", CORPUS,
                                            "--warmup", "off"])
    engine, _ = serve.build_engine(args)
    before = cg.LAUNCHES
    rolls = engine.generate(n=4, nsteps=64)
    require(rolls.shape == (4, 64, 88) and set(np.unique(rolls).tolist()) <= {0, 1},
            f"songs from the trained checkpoint: shape {rolls.shape}")
    require(cg.LAUNCHES > before, "the trained checkpoint did not generate through the kernel")
    print(f"trained checkpoint {ckpt}: 4 songs x 64 frames through the generation kernel, "
          f"{int(rolls.sum())} notes on")


FWD_LIMIT = 1e-5


def fwd_outside(errs, ref):
    """The forward outputs whose kernel-vs-plain error exceeds the limit: h
    (|h| < 1) within 1e-5; c and z, which grow without bound over the steps,
    within 1e-5 x max(1, max|plain|), the same f32 rounding at their scale."""
    bad = {}
    for name, err in errs.items():
        key = name.split()[-1]
        scale = 1.0 if key in ("h", "h_prev") else max(1.0, ref[key].abs().max().item())
        if not (err <= FWD_LIMIT * scale and math.isfinite(err)):
            bad[name] = (err, scale)
    return bad


def _lstm_inputs(rng, dev, raw_cell, B, T, D, H):
    """A cell's weights and a time-major input batch: binary frames in the
    first D columns (the corpus's density), the rest (key weights, z)
    Gaussian; zero initial state, as the model runs it."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    p = params_from_numpy(raw_cell, dev)
    IN = p["kernel"].shape[0]
    x = np.concatenate([(rng.random((T, B, D)) < 0.1).astype(np.float32),
                        (0.5 * rng.standard_normal((T, B, IN - D))).astype(np.float32)], -1)
    zeros = torch.zeros((B, H), device=dev)
    return (torch.from_numpy(x).to(dev), p["kernel"], p["bias"], p["recurrent_kernel"], zeros,
            zeros)


def phase_lstm_seq(dev):
    """The three whole-sequence LSTM kernels against their plain versions:
    all three at the training shape (both cells), the inference forward at
    the evaluation shape (both cells). Returns the kernel-table fields of
    each, from the encoder cell."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls

    rng = np.random.default_rng(SEED + 3)
    raw13, cfg = train_shape_weights(rng)
    raw10, _, _ = common.load_model(MODEL, "cl_vrnn")
    D, H = cfg.original_dim, cfg.intermediate_dim
    H4 = 4 * H
    fwd_fmas = lambda T, B, IN: T * B * (IN + H) * H4
    table = {}
    for cell in ("encoder_h", "decoder_h"):
        B, T = TRAIN_B, TRAIN_T
        ins = _lstm_inputs(rng, dev, raw13[cell], B, T, D, H)
        x, w, b, rk, _, _ = ins
        IN = x.shape[-1]
        got = ls.lstm_seq_train_fwd(*ins)
        inf = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_train_fwd_plain(*ins)
        torch.cuda.synchronize()
        names = ("h", "c", "z", "h_prev", "c_prev")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, got, ref)}
        errs.update({f"inference {n}": (k - p).abs().max().item()
                     for n, k, p in zip(names, inf, ref)})
        require(all(torch.isfinite(o).all().item() for o in got + inf),
                "LSTM forward kernel output not finite")
        bad = fwd_outside(errs, dict(zip(names, ref)))
        print(f"lstm_seq {cell} at B={B} T={T} IN={IN} H={H}: max |kernel - plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limit {FWD_LIMIT}, for c and z {FWD_LIMIT} x max(1, max|plain|): max|plain| "
              f"c {ref[1].abs().max().item():.3f}, z {ref[2].abs().max().item():.3f})")
        require(not bad, f"LSTM forward differs: {bad}")
        h, c, z, hp, cp = ref
        dh = torch.from_numpy((1e-2 * rng.standard_normal(tuple(h.shape))).astype(np.float32))
        dc = torch.zeros_like(dh)
        dc[-1] = torch.from_numpy((1e-2 * rng.standard_normal((B, H))).astype(np.float32))
        res = (z, cp, c, hp, x, dh.to(dev), dc.to(dev), rk.T.contiguous(), w.T.contiguous())
        bgot = ls.lstm_seq_bwd(*res)
        bwant = ls.lstm_seq_bwd_plain(*res)
        torch.cuda.synchronize()
        bad, rel = [], {}
        for n, g, wv in zip(("dx", "dh0", "dc0", "drk", "dw", "db"), bgot, bwant):
            err, scale = (g - wv).abs().max().item(), wv.abs().max().item()
            rel[n] = err / max(scale, 1e-30)
            if not (err <= 1e-4 * scale + 1e-6 and math.isfinite(err)):
                bad.append((n, err, scale))
        bwd_err = max((g - wv).abs().max().item() for g, wv in zip(bgot, bwant))
        print(f"lstm_seq {cell} backward: max |kernel - plain| / max|plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
        require(not bad, f"LSTM backward differs: {bad}")

        # the two forwards in turns (inference, training, training, inference)
        ik = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=20, warm=2)
        tk = time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=20, warm=2)
        tk2 = time_ms(lambda: ls.lstm_seq_train_fwd(*ins), reps=20, warm=2)
        ik2 = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=20, warm=2)
        tp = time_ms(lambda: ls.lstm_seq_train_fwd_plain(*ins), reps=5)
        bk = time_ms(lambda: ls.lstm_seq_bwd(*res), reps=20, warm=2)
        bp = time_ms(lambda: ls.lstm_seq_bwd_plain(*res), reps=5)
        tb_ms, tb_by = roofline_ms(fwd_fmas(T, B, IN), _nbytes(ins) + _nbytes(got))
        # the serial chain dz @ [Rk | W]ᵀ, then dRk, dW and db over T*B rows
        bb_ms, bb_by = roofline_ms(T * B * H4 * (2 * (H + IN) + 1), _nbytes(res) + _nbytes(bgot))
        print(f"lstm_seq {cell} at the training shape: training forward {tk:.3f} / {tk2:.3f} ms "
              f"(plain {tp:.3f}, bound {tb_ms:.4f} {tb_by}); inference forward {ik:.3f} / "
              f"{ik2:.3f} ms; backward "
              f"(2 launches) {bk:.3f} ms (plain {bp:.3f}, bound {bb_ms:.4f} {bb_by})")
        if cell == "encoder_h":
            table["train_fwd"] = {"max_abs_err": max(errs.values()), "ms": tk, "plain_ms": tp,
                                  "bound_ms": tb_ms, "bound_by": tb_by}
            table["bwd"] = {"max_abs_err": bwd_err, "ms": bk, "plain_ms": bp, "bound_ms": bb_ms,
                            "bound_by": bb_by}

    for cell in ("encoder_h", "decoder_h"):
        B, T = EVAL_SAMPLES * EVAL_B, TRAIN_T
        ins = _lstm_inputs(rng, dev, raw10[cell], B, T, D, H)
        IN = ins[0].shape[-1]
        got = ls.lstm_seq_fwd(*ins)
        ref = ls.lstm_seq_fwd_plain(*ins)
        torch.cuda.synchronize()
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(("h", "c"), got, ref)}
        err = max(errs.values())
        require(all(torch.isfinite(o).all().item() for o in got), "LSTM forward not finite")
        bad = fwd_outside(errs, {"h": ref[0], "c": ref[1]})
        require(not bad, f"LSTM inference forward differs at the evaluation shape: {bad}")
        k_ms = time_ms(lambda: ls.lstm_seq_fwd(*ins), reps=5, warm=1)
        p_ms = time_ms(lambda: ls.lstm_seq_fwd_plain(*ins), reps=3, warm=1)
        b_ms, b_by = roofline_ms(fwd_fmas(T, B, IN), _nbytes(ins) + _nbytes(got))
        print(f"lstm_seq {cell} inference forward at the evaluation shape (B={B} T={T} IN={IN} "
              f"H={H}): max |kernel - plain| h {errs['h']:.3e}, c {errs['c']:.3e} (max|plain| c "
              f"{ref[1].abs().max().item():.3f}); kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if cell == "encoder_h":
            table["fwd"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by}
    return table


def phase_evaluate(ckpt):
    """The evaluation path through ``cli.evaluate``: the trained model on
    ``Piano-midi_Cs`` through the inference kernel, then plain PyTorch on
    the card with the same seed, then the ``--two_cell off`` checkpoint on
    the training corpus. Returns the first run's inference-forward
    launches."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import evaluate
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.evaluation.nll import iw_nll_cl_vrnn
    from classifying_vae_lstm_tpu_torch.ops import lstm_seq as ls
    from classifying_vae_lstm_tpu_torch.ops import two_cell as tc

    calls, real_nll = [], evaluate.iw_nll_dataset

    def spy(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_nll(*a, **k)
        torch.cuda.synchronize()
        calls.append({"args": a, "nlls": out, "s": time.perf_counter() - t0})
        return out

    def run(model, corpus, backend):
        args = evaluate.build_parser().parse_args(
            ["-i", model, "--train_file", corpus, "--lstm_backend", backend, "--n_samples",
             str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)])
        ls.FWD_LAUNCHES = ls.TRAIN_FWD_LAUNCHES = ls.BWD_LAUNCHES = 0  # this run's counts
        tc.FWD_LAUNCHES = tc.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        out = evaluate.evaluate(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (ls.FWD_LAUNCHES, ls.TRAIN_FWD_LAUNCHES, ls.BWD_LAUNCHES, tc.FWD_LAUNCHES,
                  tc.BWD_LAUNCHES)
        return out, counts, calls[-1], wall

    plain_on_cuda = []
    evaluate.iw_nll_dataset = spy
    try:
        with plain_guard(ls, LSTM_SEQ_PLAIN, plain_on_cuda):
            out_k, counts_k, est_k, wall_k = run(MODEL, EVAL_CORPUS, "pallas")
            out_x, counts_x, est_x, wall_x = run(MODEL, EVAL_CORPUS, "xla")
            out_c, counts_c, est_c, wall_c = run(ckpt, CORPUS, "keep")
    finally:
        evaluate.iw_nll_dataset = real_nll
    n_batches = -(-EVAL_WINDOWS // EVAL_B)
    nll_k = est_k["nlls"].double().mean().item()
    nll_x = est_x["nlls"].double().mean().item()
    print(f"evaluate jsball_vrnn4 on {EVAL_CORPUS} ({out_k['n_test_examples']} windows, "
          f"{EVAL_SAMPLES} samples, batches of {EVAL_B}): --lstm_backend pallas NLL "
          f"{nll_k!r} nats/frame (printed {out_k['test_nll_nats_per_frame']}), wall "
          f"{wall_k:.3f} s, estimator {est_k['s']:.3f} s; --lstm_backend xla NLL {nll_x!r} "
          f"(printed {out_x['test_nll_nats_per_frame']}), wall {wall_x:.3f} s, estimator "
          f"{est_x['s']:.3f} s; |difference| {abs(nll_k - nll_x):.3e} (limit 1e-4)")
    print(f"evaluation launches (inference forward, training forward, backward, two-cell "
          f"forward, two-cell backward): pallas {counts_k}, xla {counts_x} (expected "
          f"{(2 * n_batches, 0, 0, 0, 0)} and zeros)")
    require(out_k["n_test_examples"] == out_x["n_test_examples"] == EVAL_WINDOWS,
            f"test windows {out_k['n_test_examples']}, {out_x['n_test_examples']}")
    require(counts_k == (2 * n_batches, 0, 0, 0, 0), f"evaluation launches {counts_k}")
    require(counts_x == (0, 0, 0, 0, 0), f"xla evaluation launched kernels: {counts_x}")
    require(math.isfinite(nll_k) and abs(nll_k - nll_x) <= 1e-4,
            f"pallas and xla NLLs differ: {nll_k} vs {nll_x}")

    P = PianoData(CORPUS, batch_size=1, seq_length=TRAIN_T, return_y_next=True,
                  return_y_hist=True, squeeze_x=False, squeeze_y=False)
    n = len(P.x_test)
    nll_c = est_c["nlls"].double().mean().item()
    print(f"evaluate the --two_cell off checkpoint on {CORPUS}: {out_c} (NLL {nll_c!r}), "
          f"wall {wall_c:.3f} s, launches {counts_c}")
    require(out_c["n_test_examples"] == n, f"test windows {out_c['n_test_examples']} != {n}")
    require(counts_c == (2 * -(-n // EVAL_B), 0, 0, 0, 0), f"launches {counts_c}")
    require(math.isfinite(nll_c), "non-finite NLL")
    require(not plain_on_cuda, f"plain LSTM versions ran on CUDA tensors: {plain_on_cuda}")

    # where one evaluation batch's time goes
    params, cfg, data = est_k["args"][:3]
    batch = {k: v[:EVAL_B] for k, v in data.items()}
    gen = torch.Generator(device=batch["x"].device).manual_seed(SEED)

    def one_batch():
        with torch.no_grad():
            iw_nll_cl_vrnn(params, cfg, batch["x"], batch["y"], gen, EVAL_SAMPLES,
                           batch["x_prev"])

    one_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one_batch()
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"one evaluation batch ({EVAL_SAMPLES} x {EVAL_B} rows): {batch_ms:.3f} ms (host "
          f"clock, synchronised)")
    device_profile(one_batch, 3, batch_ms, "evaluation batch", "LSTM kernels", "lstm_seq")
    return counts_k[0]


def vae_bound_ms(cfg, B, nsteps, weight_bytes) -> tuple[float, str]:
    """Least time for one cl_vae generation call: its f32 FMAs (encoder x
    rows, z heads, decoder z and x_prev rows, frame head, per song-step)
    against its bytes (seeds, eps, u, the per-song folds, the weights and the
    output, each once)."""
    D, H, L = cfg.original_dim, cfg.intermediate_dim, cfg.latent_dim
    n_xp = D if cfg.use_x_prev else 0
    fmas = B * nsteps * (D * H + H * 2 * L + L * H + n_xp * H + H * D)
    stream_bytes = 4 * (B * D + B * nsteps * (L + D) + 2 * B * H + B * nsteps * D)
    return roofline_ms(fmas, stream_bytes + weight_bytes)


def phase_vae(dev):
    """The cl_vae generation kernel against its plain version: f32 on the
    trained jsball_vae weights at the largest serving bucket, then bf16 at
    a seeded width where f32 weights would not fit. Returns the kernel-table
    fields of the f32 run."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.sampling import infer_w_cl_vae
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg, _ = common.load_model(VAE_MODEL, "cl_vae")
    params = params_from_numpy(raw, dev)
    B, nsteps = 64, 256
    D, L = cfg.original_dim, cfg.latent_dim
    seeds = torch.from_numpy(np.ascontiguousarray(seed_windows(B)[:, 0])).to(dev)
    ws = infer_w_cl_vae(params, seeds)
    rng = np.random.default_rng(SEED + 4)
    eps = torch.from_numpy(rng.standard_normal((B, nsteps, L), dtype=np.float32)).to(dev)
    u = torch.from_numpy(rng.random((B, nsteps, D), dtype=np.float32)).to(dev)
    u1 = torch.ones_like(u)
    errs, times = {}, {}
    for zp in (False, True):
        kern = lambda uu, rp: cgv.generate_cl_vae_batch_cuda(
            params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp, return_probs=rp)
        plain = lambda uu, rp: cgv.generate_cl_vae_batch_plain(
            params, cfg, seeds, nsteps, eps, uu, ws, use_z_prior=zp, return_probs=rp)
        pk, pp = kern(u1, True), plain(u1, True)
        torch.cuda.synchronize()
        require(torch.isfinite(pk).all().item() and pk.shape == (B, nsteps, D),
                "cl_vae kernel probabilities not finite or misshapen")
        errs[zp] = (pk - pp).abs().max().item()
        print(f"cl_vae f32 probs, u=1, use_z_prior={zp}: max |kernel - plain| = "
              f"{errs[zp]:.3e} (limit 1e-5)")
        require(errs[zp] <= 1e-5, f"cl_vae f32 probabilities differ by {errs[zp]}")
        fk, fp, probs = kern(u, False), plain(u, False), plain(u, True)
        torch.cuda.synchronize()
        frames_agree_to_near_tie(f"cl_vae f32 frames, use_z_prior={zp}", fk, fp, u, probs)
        # kernel, plain, plain, kernel
        times[zp] = (time_ms(lambda: kern(u, False), reps=20, warm=2),
                     time_ms(lambda: plain(u, False), reps=3, warm=1),
                     time_ms(lambda: plain(u, False), reps=3),
                     time_ms(lambda: kern(u, False), reps=20))
    w = cgv._pack(params, cfg, ws, "f32")
    wbytes = sum(w[k].numel() * w[k].element_size()
                 for k in ("wke", "wz_t", "bz", "wkd_x", "wkd_z", "wx", "bx") if w[k] is not None)
    b_ms, b_by = vae_bound_ms(cfg, B, nsteps, wbytes)
    for zp, (k1, p1, p2, k2) in times.items():
        print(f"cl_vae f32 kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.3f} / {p2:.3f} ms "
              f"(use_z_prior={zp}), bound {b_ms:.4f} ms ({b_by}) at B={B} nsteps={nsteps} "
              f"H={cfg.intermediate_dim}; shared memory {cgv.smem_bytes(cfg)} B per block")
    grid = {}  # the serving buckets (songs x steps), each after a warm-up launch
    for b in (1, 4, 16, 64):
        for t in (32, 64, 128, 256):
            args = [x[:b, :t].contiguous() for x in (eps, u)]
            sb, wb = seeds[:b].contiguous(), ws[:b].contiguous()
            grid[f"{b}x{t}"] = round(time_ms(lambda: cgv.generate_cl_vae_batch_cuda(
                params, cfg, sb, t, args[0], args[1], wb), reps=5), 4)
    print(f"cl_vae f32 kernel ms per serving bucket (songs x steps): {json.dumps(grid)}")

    # bf16 weights at H=256, where the f32 ones would overflow shared memory
    H, K = 256, cfg.n_classes
    bcfg = cl_vae.Config(original_dim=D, intermediate_dim=H, latent_dim=L,
                         intermediate_class_dim=88, n_classes=K, use_x_prev=True,
                         bf16_compute=True)
    require(not cgv.fits(bcfg, "f32") and cgv.fits(bcfg, "bf16"), "bf16 width choice")
    brng = np.random.default_rng(SEED + 5)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return brng.uniform(-lim, lim, (i, o)).astype(np.float32)

    dense = lambda i, o: {"kernel": glorot(i, o), "bias": np.zeros(o, np.float32)}
    bparams = params_from_numpy({"h": dense(D + K, H), "z_mean": dense(H, L),
                                 "z_log_var": dense(H, L), "decoder_h": dense(K + D + L, H),
                                 "x_decoded_mean": dense(H, D)}, dev)
    bws = torch.eye(K, device=dev)[torch.arange(B, device=dev) % K]
    run = lambda f: f(bparams, bcfg, seeds, nsteps, eps, u1, bws, return_probs=True)
    pk, pp = run(cgv.generate_cl_vae_batch_cuda), run(cgv.generate_cl_vae_batch_plain)
    torch.cuda.synchronize()
    d = (pk - pp).abs()
    mx, mean = d.max().item(), d.mean().item()
    k_ms = time_ms(lambda: run(cgv.generate_cl_vae_batch_cuda), reps=10, warm=1)
    print(f"cl_vae bf16 H={H} probs, u=1: max {mx:.3e} (limit 2e-2), mean {mean:.3e} (limit "
          f"2e-3); kernel {k_ms:.4f} ms at B={B} nsteps={nsteps}; shared memory "
          f"{cgv.smem_bytes(bcfg)} B per block")
    require(torch.isfinite(pk).all().item(), "cl_vae bf16 kernel probabilities not finite")
    require(mx <= 2e-2 and mean <= 2e-3, f"cl_vae bf16 probabilities differ: max {mx}, "
                                        f"mean {mean}")
    k_ms, p_ms = times[False][0], times[False][1]
    return {"max_abs_err": max(errs.values()), "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def phase_vae_serve():
    """cl_vae serving through ``cli.serve``: one kernel launch per engine
    device call. Returns the launches."""
    import base64

    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.data import MidiWriter
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.serving import GenerationEngine

    runs, runs_lock = [0], threading.Lock()
    real_run = GenerationEngine._run

    def counted_run(self, *a, **k):
        with runs_lock:
            runs[0] += 1
        return real_run(self, *a, **k)

    with tempfile.TemporaryDirectory() as d:
        roll = np.zeros((12, 88), np.float32)
        roll[:, [39, 43, 46]] = 1.0
        MidiWriter().dump_sequence_to_midi(roll, os.path.join(d, "seed.mid"))
        with open(os.path.join(d, "seed.mid"), "rb") as f:
            seed_b64 = base64.b64encode(f.read()).decode()
    args = serve.build_parser().parse_args(
        ["-i", VAE_MODEL, "--train_file", CORPUS, "--dynamic_batching", "--warmup", "full",
         "--port", "0"])
    plain_on_cuda = []
    GenerationEngine._run = counted_run
    try:
        with sampler_plain_guard(cgv, "generate_cl_vae_batch_plain", plain_on_cuda):
            cgv.LAUNCHES = 0  # counts from here on are this path's
            t0 = time.perf_counter()
            httpd, engine = serve.make_server(args)
            warm = (cgv.LAUNCHES, runs[0])
            print(f"cl_vae engine built and warmed in {time.perf_counter() - t0:.2f} s "
                  f"({warm[0]} warm-up launches for {warm[1]} device calls)")
            stats = exercise_server(httpd, [("2x64 seed_midi", {
                "n": 2, "t": 64, "seed_midi_base64": seed_b64})])
            launches, calls = cgv.LAUNCHES, runs[0]
    finally:
        GenerationEngine._run = real_run
    lat = engine.latency_stats()
    print(f"cl_vae /stats: family {stats['family']}, gen_backend {stats['gen_backend']}, "
          f"requests {stats['requests']}, batches {stats['batches']}, batched_songs "
          f"{stats['batched_songs']}, gen_path {stats['gen_path']}")
    print(f"cl_vae main path: {launches} launches for {calls} engine device calls "
          f"({warm[0]} warm-up); latency p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms")
    require(stats["family"] == "cl_vae", f"/stats family {stats['family']}")
    require(launches == calls and launches > warm[0],
            f"cl_vae launches {launches} != engine device calls {calls}")
    require(stats["batches"] > 0, "the cl_vae burst was not coalesced (batches == 0)")
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return launches


def phase_sample_clis(out_dir):
    """Both sample CLIs on the card, each with exactly one launch of its
    kernel. Returns the cl_vae launches."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, cl_vrnn_sample
    from classifying_vae_lstm_tpu_torch.data import read_midi_roll
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv

    runs = (
        ("cl_vae_sample", cl_vae_sample, cgv, "generate_cl_vae_batch_plain",
         ["smoke_vae", "-i", "artifacts/jsbcs_vae.npz", "-n", "8", "-t", "64"], (8, 64), True),
        ("cl_vrnn_sample", cl_vrnn_sample, cg, "generate_cl_vrnn_batch_plain",
         ["smoke_vrnn", "-i", MODEL, "--infer_w", "-n", "4"], (4, 32), False),
    )
    vae_launches = 0
    for name, cli, kmod, plain_name, argv, (n, t), doubled in runs:
        args = cli.build_parser().parse_args(
            [*argv, "--train_file", EVAL_CORPUS, "--sample_dir", out_dir])
        plain_on_cuda = []
        with sampler_plain_guard(kmod, plain_name, plain_on_cuda):
            kmod.LAUNCHES = 0  # counts from here on are this CLI's
            t0 = time.perf_counter()
            samples = cli.sample(args)
            wall = time.perf_counter() - t0
            launches = kmod.LAUNCHES
        require(samples.shape == (n, t, 88) and set(np.unique(samples).tolist()) <= {0, 1},
                f"{name} samples {samples.shape}")
        for j in range(n):
            roll = read_midi_roll(os.path.join(out_dir, f"{args.run_name}_{j}.mid"))
            want = np.repeat(samples[j], 2, axis=0) if doubled else samples[j]
            require(np.array_equal(roll, want[: len(roll)]) and not want[len(roll):].any(),
                    f"{name}: song {j}'s MIDI does not parse back into its frames")
        files = sorted(f for f in os.listdir(out_dir) if f.startswith(args.run_name))
        print(f"{name}: {n} songs x {t} frames in {wall:.3f} s (host clock, checkpoint and "
              f"corpus included), {launches} launch, {int(samples.sum())} notes on; files "
              f"{len(files)} ({files[0]} .. {files[-1]})")
        require(launches == 1, f"{name} launched its kernel {launches} times")
        require(not plain_on_cuda, f"{name}: plain version ran on CUDA tensors")
        if cli is cl_vae_sample:
            vae_launches = launches
    return vae_launches


VAE_TRAIN_B, VAE_WIDE = 100, dict(D=976, Cw=256, H=1024, L=16, K=TRAIN_K, B=1024)
VAE_DENSE_PLAIN = ("vae_dense_fwd_plain", "vae_dense_bwd_plain")


def vae_train_shape_params(rng, dev):
    """The trained ``jsball_vae`` weights (D=H=Cw=88, L=4) with fresh glorot
    rows and heads for the 13 key classes of the training corpus, and the
    matching config on the ``pallas`` route."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import common
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    raw, cfg0, _ = common.load_model(VAE_MODEL, "cl_vae")
    K, K0, D = TRAIN_K, cfg0.n_classes, cfg0.original_dim
    glorot = lambda i, o: rng.uniform(-np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)),
                                      (i, o)).astype(np.float32)
    Cw, H = cfg0.intermediate_class_dim, cfg0.intermediate_dim
    for head in ("w_mean", "w_log_var"):
        raw[head] = {"kernel": glorot(Cw, K - 1), "bias": np.zeros(K - 1, np.float32)}
    raw["h"]["kernel"] = np.concatenate([raw["h"]["kernel"][:D], glorot(K, H)])
    raw["decoder_h"]["kernel"] = np.concatenate([glorot(K, H), raw["decoder_h"]["kernel"][K0:]])
    cfg = dataclasses.replace(cfg0, n_classes=K, train_backend="pallas")
    return params_from_numpy(raw, dev), cfg


def vae_wide_params(rng, dev):
    """Seeded glorot weights at the seq-concat width the JAX kernel was
    written for (D=976, Cw=256, H=1024, L=16, K=13), and its config."""
    import numpy as np

    from classifying_vae_lstm_tpu_torch.models import cl_vae
    from classifying_vae_lstm_tpu_torch.weights import params_from_numpy

    w = VAE_WIDE
    cfg = cl_vae.Config(original_dim=w["D"], intermediate_dim=w["H"], latent_dim=w["L"],
                        intermediate_class_dim=w["Cw"], n_classes=w["K"], use_x_prev=True,
                        train_backend="pallas")

    def dense(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return {"kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "bias": np.zeros(o, np.float32)}

    D, Cw, H, L, K = w["D"], w["Cw"], w["H"], w["L"], w["K"]
    raw = {"h_w": dense(D, Cw), "w_mean": dense(Cw, K - 1), "w_log_var": dense(Cw, K - 1),
           "h": dense(D + K, H), "z_mean": dense(H, L), "z_log_var": dense(H, L),
           "decoder_h": dense(K + D + L, H), "x_decoded_mean": dense(H, D)}
    return params_from_numpy(raw, dev), cfg


def vae_dense_fmas(cfg) -> int:
    """FMAs of one row of the dense-stack forward: every weight once."""
    D, Cw, H, L, K = (cfg.original_dim, cfg.intermediate_class_dim, cfg.intermediate_dim,
                      cfg.latent_dim, cfg.n_classes)
    n_xp = D if cfg.use_x_prev else 0
    return D * Cw + Cw * 2 * (K - 1) + (D + K) * H + H * 2 * L + (K + n_xp + L) * H + H * D


def phase_vae_dense(dev):
    """Both dense-stack kernels against their plain versions at the training
    shape and at the seq-concat width. Returns the kernel-table fields of
    each at the training shape."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    rng = np.random.default_rng(SEED + 6)
    shapes = {"training": (*vae_train_shape_params(rng, dev), VAE_TRAIN_B),
              "wide": (*vae_wide_params(rng, dev), VAE_WIDE["B"])}
    table = {}
    for label, (params, cfg, B) in shapes.items():
        D, K, L = cfg.original_dim, cfg.n_classes, cfg.latent_dim
        f = lambda a: torch.from_numpy(a).to(dev)
        x = f((rng.random((B, D)) < 0.1).astype(np.float32))
        xp = f((rng.random((B, D)) < 0.1).astype(np.float32))
        eps_w = f(rng.standard_normal((B, K - 1)).astype(np.float32))
        eps_z = f(rng.standard_normal((B, L)).astype(np.float32))
        ins = vd.pack_inputs(params, cfg, x, xp, eps_w, eps_z)
        outs = vd.vae_dense_fwd(*ins)
        ref = vd.vae_dense_fwd_plain(*ins)
        torch.cuda.synchronize()
        names = ("xhat", "wargs", "zargs", "w", "a1", "a2", "a3")
        errs = {n: (k - p).abs().max().item() for n, k, p in zip(names, outs, ref)}
        scale = {n: max(1.0, p.abs().max().item()) for n, p in zip(names, ref)}
        require(all(torch.isfinite(o).all().item() for o in outs),
                "dense-stack forward kernel output not finite")
        bad = {n: (e, scale[n]) for n, e in errs.items()
               if not (e <= FWD_LIMIT * scale[n] and math.isfinite(e))}
        print(f"vae_dense forward, {label} shape (B={B} D={D} Cw={cfg.intermediate_class_dim} "
              f"H={cfg.intermediate_dim} L={L} K={K}): max |kernel - plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (limit {FWD_LIMIT} x max(1, max|plain|))")
        require(not bad, f"dense-stack forward differs: {bad}")

        (x_, xp_, ew, ez, whw, _, wwz, _, whx, whw2, _, wzz, _, wdw, wdxp, wdz, _, wxh, _) = ins
        xhat, wargs, zargs, w, a1, a2, a3 = ref
        cot = [f((1e-2 * rng.standard_normal(tuple(o.shape))).astype(np.float32))
               for o in (xhat, wargs, zargs, w)]
        res = (x_, xp_, ew, ez, a1, a2, a3, xhat, wargs, zargs, w, *cot,
               whw, wwz, whx, whw2, wzz, wdw, wdxp, wdz, wxh)
        got = vd.vae_dense_bwd(*res)
        want = vd.vae_dense_bwd_plain(*res)
        torch.cuda.synchronize()
        gnames = ("dx", "dxp", "dwhw", "dbhw", "dwwz", "dbwz", "dwhx", "dwhw2", "dbh", "dwzz",
                  "dbzz", "dwdw", "dwdxp", "dwdz", "dbd", "dwxh", "dbxh")
        bad, rel = [], {}
        for n, g, wv in zip(gnames, got, want):
            err, sc = (g - wv).abs().max().item(), wv.abs().max().item()
            rel[n] = err / max(sc, 1e-30)
            if not (err <= 1e-4 * sc + 1e-6 and math.isfinite(err)):
                bad.append((n, err, sc))
        bwd_err = max((g - wv).abs().max().item() for g, wv in zip(got, want))
        print(f"vae_dense backward, {label} shape: max |kernel - plain| / max|plain| "
              + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
              + f" (limit 1e-4 + 1e-6 abs); largest abs error {bwd_err:.3e}")
        require(not bad, f"dense-stack backward differs: {bad}")

        # kernel, plain, plain, kernel for each direction
        reps = 50 if label == "training" else 10
        fk = (time_ms(lambda: vd.vae_dense_fwd(*ins), reps=reps, warm=2),
              time_ms(lambda: vd.vae_dense_fwd_plain(*ins), reps=reps, warm=2),
              time_ms(lambda: vd.vae_dense_fwd_plain(*ins), reps=reps),
              time_ms(lambda: vd.vae_dense_fwd(*ins), reps=reps))
        bk = (time_ms(lambda: vd.vae_dense_bwd(*res), reps=reps, warm=2),
              time_ms(lambda: vd.vae_dense_bwd_plain(*res), reps=reps, warm=2),
              time_ms(lambda: vd.vae_dense_bwd_plain(*res), reps=reps),
              time_ms(lambda: vd.vae_dense_bwd(*res), reps=reps))
        F = vae_dense_fmas(cfg)
        n_bias = (cfg.intermediate_class_dim + 2 * (K - 1) + 2 * cfg.intermediate_dim + 2 * L
                  + D)
        live = lambda ts: [t for t in ts if t is not None]
        fb_ms, fb_by = roofline_ms(B * F, _nbytes(live(ins)) + _nbytes(outs))
        # the row pass (every weight once, transposed) + every dW and bias sum
        bb_ms, bb_by = roofline_ms(B * (2 * F + n_bias), _nbytes(live(res)) + _nbytes(live(got)))
        print(f"vae_dense {label} shape: forward kernel {fk[0]:.4f} / {fk[3]:.4f} ms, plain "
              f"(cuBLAS products) {fk[1]:.4f} / {fk[2]:.4f} ms, kernel/plain "
              f"{fk[0] / fk[1]:.2f}, bound {fb_ms:.5f} ms ({fb_by}); backward kernel (2 launches) "
              f"{bk[0]:.4f} / {bk[3]:.4f} ms, plain {bk[1]:.4f} / {bk[2]:.4f} ms, kernel/plain "
              f"{bk[0] / bk[1]:.2f}, bound {bb_ms:.5f} ms ({bb_by}); shared memory "
              f"{vd.smem_bytes(cfg)} B per block")
        # device time alone (the CUDA-event times above include the
        # wrappers' host work, which sets them at the training shape)
        dt = {n: device_ms_per_call(fn, 20, "vae_dense")
              for n, fn in (("forward", lambda: vd.vae_dense_fwd(*ins)),
                            ("plain forward", lambda: vd.vae_dense_fwd_plain(*ins)),
                            ("backward", lambda: vd.vae_dense_bwd(*res)),
                            ("plain backward", lambda: vd.vae_dense_bwd_plain(*res)))}
        print(f"vae_dense {label} shape, profiler device ms per call: "
              + "; ".join(f"{n} " + ("not measured" if v is None else
                                     f"{v[1]:.4f} (dense-stack kernels {v[0]:.4f})")
                          for n, v in dt.items()))
        if label == "training":
            table["fwd"] = {"max_abs_err": max(errs.values()), "ms": fk[0], "plain_ms": fk[1],
                            "bound_ms": fb_ms, "bound_by": fb_by}
            table["bwd"] = {"max_abs_err": bwd_err, "ms": bk[0], "plain_ms": bk[1],
                            "bound_ms": bb_ms, "bound_by": bb_by}
    return table


VAE_TRAIN_FLAGS = ["--train_file", CORPUS, "--intermediate_dim", "88",
                   "--intermediate_class_dim", "88", "--latent_dim", "4", "--batch_size",
                   str(VAE_TRAIN_B), "--use_x_prev", "--patience", "0"]


def phase_vae_train(model_dir):
    """The cl_vae training path through ``cli.cl_vae_train --train_backend
    pallas`` (3 epochs), then 1 epoch of ``xla`` from the same seed. Returns
    the forward and backward launch counts and what the run left."""
    from classifying_vae_lstm_tpu_torch.cli import cl_vae_train
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd
    from classifying_vae_lstm_tpu_torch.train.checkpoint import load_model_args

    def reset():
        vd.FWD_LAUNCHES = vd.BWD_LAUNCHES = 0

    read = lambda: (vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)
    plain_on_cuda = []
    with plain_guard(vd, VAE_DENSE_PLAIN, plain_on_cuda):
        args, (fwd, bwd), seen, epoch_s, wall = run_train(
            "smoke_vae", ["--num_epochs", "3", "--train_backend", "pallas"], model_dir, reset,
            read, cli=cl_vae_train, base_flags=VAE_TRAIN_FLAGS)
        E, n_train, n_val = _report_train("cl_vae training path", args, seen, epoch_s, wall)
        print(f"cl_vae training path launches: forward {fwd} (expected {E * (n_train + n_val)}), "
              f"backward {bwd} (expected {2 * E * n_train}: the row pass and the "
              f"weight-gradient pass per step)")
        require(fwd == E * (n_train + n_val), f"dense-stack forward launches {fwd}")
        require(bwd == 2 * E * n_train, f"dense-stack backward launches {bwd}")
        margs = load_model_args(seen["ckpt"])
        require((margs["train_backend"], margs["n_classes"]) == ("pallas", TRAIN_K),
                f"args.json {margs}")
        seen.update(step_ms=epoch_s[-1] * 1e3 / n_train)

        args_x, counts_x, seen_x, epoch_x, wall_x = run_train(
            "smoke_vae_xla", ["--num_epochs", "1", "--train_backend", "xla"], model_dir, reset,
            read, cli=cl_vae_train, base_flags=VAE_TRAIN_FLAGS)
    _report_train("cl_vae --train_backend xla", args_x, seen_x, epoch_x, wall_x)
    require(counts_x == (0, 0), f"the xla route launched dense-stack kernels: {counts_x}")
    require(not plain_on_cuda, f"plain dense-stack versions ran on CUDA tensors: {plain_on_cuda}")
    loss_k, loss_x = seen["history"]["loss"][0], seen_x["history"]["loss"][0]
    rel = abs(loss_k - loss_x) / abs(loss_x)
    print(f"cl_vae first epoch train loss: pallas {loss_k!r}, xla {loss_x!r}, relative "
          f"difference {rel:.3e} (limit 1e-3); ms per step, first epoch: pallas "
          f"{epoch_s[0] * 1e3 / n_train:.3f}, xla {epoch_x[0] * 1e3 / n_train:.3f}; epoch s: "
          f"pallas {[round(v, 3) for v in epoch_s]}, xla {[round(v, 3) for v in epoch_x]}")
    require(rel <= 1e-3, f"first-epoch losses differ by {rel}")
    return fwd, bwd, seen


def phase_vae_evaluate(ckpt, out_dir):
    """``cli.evaluate --family cl_vae``: jsbcs_vae over the whole test split
    of ``Piano-midi_Cs``, then phase 15's checkpoint on the training corpus;
    then ``cli.cl_vae_sample`` on that checkpoint with true keys, one
    generation launch."""
    import numpy as np
    import torch

    from classifying_vae_lstm_tpu_torch.cli import cl_vae_sample, evaluate
    from classifying_vae_lstm_tpu_torch.data import PianoData
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate_vae as cgv
    from classifying_vae_lstm_tpu_torch.ops import vae_dense as vd

    for model, corpus in (("artifacts/jsbcs_vae.npz", EVAL_CORPUS), (ckpt, CORPUS)):
        args = evaluate.build_parser().parse_args(
            ["-i", model, "--family", "cl_vae", "--train_file", corpus, "--n_samples",
             str(EVAL_SAMPLES), "--batch_size", str(EVAL_B)])
        vd.FWD_LAUNCHES = vd.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        out = evaluate.evaluate(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(PianoData(corpus, batch_size=1, seq_length=1, return_y_next=True).x_test)
        print(f"evaluate {model} on {corpus}: NLL {out['test_nll_nats_per_frame']} nats/frame "
              f"over {out['n_test_examples']} frames ({EVAL_SAMPLES} samples, batches of "
              f"{EVAL_B}), wall {wall:.3f} s (host clock, checkpoint and corpus loads included); "
              f"dense-stack launches {(vd.FWD_LAUNCHES, vd.BWD_LAUNCHES)} (the estimator runs "
              "plain dense layers, as the JAX one does)")
        require(out["family"] == "cl_vae" and out["n_test_examples"] == n,
                f"evaluation covered {out['n_test_examples']} of {n} frames")
        require(math.isfinite(out["test_nll_nats_per_frame"]), "non-finite NLL")

    args = cl_vae_sample.build_parser().parse_args(
        ["smoke_trained_vae", "-i", ckpt, "-n", "4", "-t", "32", "--train_file", CORPUS,
         "--sample_dir", out_dir])
    plain_on_cuda = []
    with sampler_plain_guard(cgv, "generate_cl_vae_batch_plain", plain_on_cuda):
        cgv.LAUNCHES = 0
        samples = cl_vae_sample.sample(args)
        launches = cgv.LAUNCHES
    files = sorted(f for f in os.listdir(out_dir) if f.startswith("smoke_trained_vae"))
    print(f"cl_vae_sample on the trained checkpoint: 4 songs x 32 frames, {launches} launch, "
          f"{int(samples.sum())} notes on, {len(files)} MIDI files")
    require(samples.shape == (4, 32, 88) and set(np.unique(samples).tolist()) <= {0, 1},
            f"samples {samples.shape}")
    require(launches == 1 and len(files) == 4 and not plain_on_cuda,
            f"cl_vae_sample: {launches} launches, files {files}, plain {plain_on_cuda}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    import classifying_vae_lstm_tpu_torch  # noqa: F401 — fails without the checkout

    line = gpu_line()
    print(f"card: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phase_build()
    f32 = phase_f32(dev)
    phase_bf16(dev)
    launches = phase_serve()
    fwd, bwd = phase_two_cell(dev)
    lstm = phase_lstm_seq(dev)
    with tempfile.TemporaryDirectory() as model_dir:
        fwd_launches, bwd_launches, seen = phase_train(model_dir)
        phase_train_breakdown(seen)
        phase_checkpoint_serves(seen["ckpt"])
        train_fwd_launches, lstm_bwd_launches, seen_off = phase_train_two_loop(
            model_dir, seen["history"]["loss"][0])
        phase_train_breakdown(seen_off, "LSTM kernels", "lstm_seq")
        eval_launches = phase_evaluate(seen_off["ckpt"])
    vae = phase_vae(dev)
    vae_launches = phase_vae_serve()
    with tempfile.TemporaryDirectory() as sample_dir:
        vae_launches += phase_sample_clis(sample_dir)
    dense = phase_vae_dense(dev)
    with tempfile.TemporaryDirectory() as model_dir:
        dense_fwd, dense_bwd, seen_vae = phase_vae_train(model_dir)
        phase_train_breakdown(seen_vae, "dense-stack kernels", "vae_dense")
        with tempfile.TemporaryDirectory() as sample_dir:
            phase_vae_evaluate(seen_vae["ckpt"], sample_dir)
    source = "classifying_vae_lstm_tpu_torch/csrc/two_cell.cu"
    lstm_source = "classifying_vae_lstm_tpu_torch/csrc/lstm_seq.cu"
    pallas_lstm = "classifying_vae_lstm_tpu/ops/pallas_lstm.py"
    dense_source = "classifying_vae_lstm_tpu_torch/csrc/vae_dense.cu"
    kernels = [{
        "name": "generate_cl_vrnn", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vrnn.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate.py:153",
        "launches": launches, **f32, "library_ms": None,
    }, {
        "name": "two_cell_fwd", "route": "cuda", "source": source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:129",
        "launches": fwd_launches, **fwd, "library_ms": None,
    }, {
        "name": "two_cell_bwd", "route": "cuda", "source": source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_two_cell.py:295",
        "launches": bwd_launches, **bwd, "library_ms": None,
    }, {
        "name": "lstm_seq_fwd", "route": "cuda", "source": lstm_source,
        "replaces": f"{pallas_lstm}:632", "launches": eval_launches, **lstm["fwd"],
        "library_ms": None,
    }, {
        "name": "lstm_seq_train_fwd", "route": "cuda", "source": lstm_source,
        "replaces": f"{pallas_lstm}:730", "launches": train_fwd_launches, **lstm["train_fwd"],
        "library_ms": None,
    }, {
        "name": "lstm_seq_bwd", "route": "cuda", "source": lstm_source,
        "replaces": f"{pallas_lstm}:986", "launches": lstm_bwd_launches, **lstm["bwd"],
        "library_ms": None,
    }, {
        "name": "generate_cl_vae", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vae.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate_vae.py:141",
        "launches": vae_launches, **vae, "library_ms": None,
    }, {
        "name": "vae_dense_fwd", "route": "cuda", "source": dense_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:133", "launches": dense_fwd,
        **dense["fwd"], "library_ms": None,
    }, {
        "name": "vae_dense_bwd", "route": "cuda", "source": dense_source,
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_vae.py:230", "launches": dense_bwd,
        **dense["bwd"], "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
