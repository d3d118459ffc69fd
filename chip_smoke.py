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
4. the main path: the port's ``cli.serve`` server with ``--dynamic_batching
   --warmup full`` answers /generate requests (a burst among them) over HTTP;
   the launch counts are set to 0 just before and read just after, and the
   plain version must not run on a CUDA tensor.

The last lines are the kernel table (one JSON object), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

SEED = 0
MODEL = "artifacts/jsball_vrnn4.npz"
CORPUS = "data/input/Piano-midi_all.pickle"
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


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
    require(set(_build.sources()) == {"generate_cl_vrnn"}, f"sources {_build.sources()}")


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
    require(set(torch.unique(fk).tolist()) <= {0.0, 1.0}, "kernel frames not binary")
    near = ((u[:, Tseed:] - probs).abs() < 1e-4).any(dim=2)  # [B, nsteps]
    diff = (fk != fp).any(dim=2)
    first = lambda m: torch.where(m.any(1), m.float().argmax(1), torch.full_like(m[:, 0], nsteps,
                                                                                 dtype=torch.long))
    t_tie, t_diff = first(near), first(diff)
    bad = (t_diff < t_tie).nonzero().flatten().tolist()
    whole = int((t_diff == nsteps).sum().item())
    print(f"f32 frames: {whole}/{B} songs agree wholly; {int((t_tie < nsteps).sum())} songs "
          f"have a near-tie (median first near-tie at step {int(t_tie.median())}); "
          f"songs diverging before their first near-tie: {bad}")
    require(not bad, f"songs {bad} diverge before a near-tie")

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


def phase_serve():
    import base64

    import numpy as np

    from classifying_vae_lstm_tpu_torch.cli import serve
    from classifying_vae_lstm_tpu_torch.ops import cuda_generate as cg

    plain_on_cuda = []
    plain = cg.generate_cl_vrnn_batch_plain

    def guarded_plain(params, cfg, x_seeds, *a, **k):
        if x_seeds.is_cuda:
            plain_on_cuda.append(tuple(x_seeds.shape))
        return plain(params, cfg, x_seeds, *a, **k)

    cg.generate_cl_vrnn_batch_plain = guarded_plain
    args = serve.build_parser().parse_args(
        ["-i", MODEL, "--train_file", CORPUS, "--dynamic_batching", "--warmup", "full",
         "--port", "0"])
    cg.LAUNCHES = 0  # counts from here on are the main path's
    t0 = time.perf_counter()
    httpd, engine = serve.make_server(args)
    print(f"engine built and warmed in {time.perf_counter() - t0:.2f} s "
          f"({cg.LAUNCHES} warm-up launches)")
    warm_launches = cg.LAUNCHES
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"

    client_ms = {}  # request -> ms on the client's clock, HTTP and JSON included

    def post(body, label=None):
        req = urllib.request.Request(f"{url}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            require(r.status == 200, f"{body} -> HTTP {r.status}")
            out = json.load(r)
        client_ms[label or json.dumps(body)] = (time.perf_counter() - t0) * 1e3
        return out

    def check_rolls(out, n, t):
        rolls = np.asarray(out["rolls"])
        require(rolls.shape == (n, t, 88), f"rolls shape {rolls.shape} != {(n, t, 88)}")
        require(set(np.unique(rolls).tolist()) <= {0, 1}, "rolls not binary")

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            require(json.load(r)["ok"], "/healthz")
        check_rolls(post({"n": 4, "t": 64}), 4, 64)
        out = post({"n": 16, "t": 128, "format": "midi_base64"})
        require(len(out["midi_base64"]) == 16
                and all(base64.b64decode(m)[:4] == b"MThd" for m in out["midi_base64"]),
                "midi_base64 response")
        check_rolls(post({"n": 1, "t": 32, "key": "C"}), 1, 32)
        results, errors = [None] * 8, []
        barrier = threading.Barrier(8)

        def client(i):
            try:
                barrier.wait(timeout=30)
                results[i] = post({"n": 2, "t": 64}, label=f"burst {i}")
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
        cg.generate_cl_vrnn_batch_plain = plain
    launches = cg.LAUNCHES
    lat = engine.latency_stats()
    print(f"/stats: requests {stats['requests']}, batches {stats['batches']}, batched_songs "
          f"{stats['batched_songs']}, gen_path {stats['gen_path']}, device {stats['device']}")
    print(f"main path launches: {launches} ({warm_launches} warm-up, "
          f"{launches - warm_launches} for {stats['requests']} requests); "
          f"latency p50 {lat['p50_ms']:.3f} ms, p95 {lat['p95_ms']:.3f} ms")
    solo = [f"{k} {v:.3f} ms" for k, v in client_ms.items() if not k.startswith("burst")]
    burst = sorted(v for k, v in client_ms.items() if k.startswith("burst"))
    print(f"client latency: {'; '.join(solo)}; burst of 8 x {{n: 2, t: 64}}: min "
          f"{burst[0]:.3f} ms, median {burst[4]:.3f} ms, max {burst[-1]:.3f} ms "
          f"(window {args.batch_window_ms} ms)")
    require(launches > warm_launches, "requests did not launch the kernel")
    require(stats["batches"] > 0, "the burst was not coalesced (batches == 0)")
    require(not plain_on_cuda, f"plain version ran on CUDA tensors: {plain_on_cuda}")
    return launches


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
    kernels = [{
        "name": "generate_cl_vrnn", "route": "cuda",
        "source": "classifying_vae_lstm_tpu_torch/csrc/generate_cl_vrnn.cu",
        "replaces": "classifying_vae_lstm_tpu/ops/pallas_generate.py:153",
        "launches": launches, **f32, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
