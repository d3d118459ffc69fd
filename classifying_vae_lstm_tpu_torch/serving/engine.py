"""Serving engine: bucketed, batched music generation on the card.

Counterpart of ``classifying_vae_lstm_tpu/serving/engine.py``, for both
families: cl_vrnn (the seed is a window, teacher-forced) and cl_vae (the
seed is one frame). Requests round up to a fixed grid of (songs, steps)
buckets and pad/slice at the edges, so the device sees a handful of shapes,
all touched by :meth:`GenerationEngine.warmup` before traffic (on the card
the first call also builds the CUDA kernel). Each request is one launch of
the family's whole-generation kernel (:mod:`..ops.cuda_generate`,
:mod:`..ops.cuda_generate_vae`) on the engine's device; on the CPU, its
plain version. With a mesh, a batch whose songs divide by its data axis
splits over the mesh's devices (``generate_cl_*_batch_dp``: one launch a
device), the others run on the first device alone, as in the JAX engine.

:class:`DynamicBatcher` coalesces concurrent requests into one bucketed
launch: the oldest request's arrival anchors the coalescing window, groups
are homogeneous in step bucket and in whether w is inferred (one batched
w-inference per group), a lone request on a warm bucket bypasses the window,
and a delivery thread copies each group's output to the host once and splits
it per caller, while the worker is already forming the next group.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import cl_vae
from ..ops import cuda_generate, cuda_generate_vae
from ..sampling.generate import (
    generate_cl_vae_batch,
    generate_cl_vae_batch_dp,
    generate_cl_vrnn_batch,
    generate_cl_vrnn_batch_dp,
    infer_w_cl_vae,
    infer_w_cl_vrnn,
)
from ..weights import params_from_numpy


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _PendingRequest:
    """One caller's songs waiting to be coalesced into a device batch."""

    __slots__ = ("seeds", "ws", "t", "event", "result", "error", "arrival")

    def __init__(self, seeds, ws, t):
        self.seeds = seeds  # np [k, Tseed, D] (cl_vrnn) or [k, D] (cl_vae)
        self.ws = ws        # np [k, K], or None -> infer w in the batch
        self.t = t          # step bucket
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.arrival = time.perf_counter()  # anchors the coalescing deadline


class DynamicBatcher:
    """Coalesces concurrent generate() calls into ONE bucketed launch.

    The worker takes the oldest pending request, waits until ``window_ms``
    after its arrival for same-step-bucket company (or until ``max_songs``
    rows are gathered), stacks the songs, runs the engine's ``_run`` once and
    hands the whole output to the delivery thread.
    """

    DEFAULT_WINDOW_MS = 25.0

    def __init__(self, engine: "GenerationEngine",
                 window_ms: float = DEFAULT_WINDOW_MS,
                 max_songs: int | None = None):
        self.engine = engine
        self.window_s = window_ms / 1e3
        self.max_songs = max_songs or engine.BATCH_BUCKETS[-1]
        self._queue: list[_PendingRequest] = []
        self._cv = threading.Condition()
        self._delivery: list = []
        self._delivery_cv = threading.Condition()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._deliverer = threading.Thread(target=self._deliver_loop, daemon=True)
        self._worker.start()
        self._deliverer.start()

    def submit(self, seeds: np.ndarray, ws: np.ndarray | None, t: int) -> np.ndarray:
        """Block until the request's songs are generated; returns [k, t, D].
        ``ws=None`` defers w-inference into the coalesced group."""
        req = _PendingRequest(np.asarray(seeds), None if ws is None else np.asarray(ws), t)
        with self._cv:
            self._queue.append(req)
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def idle(self) -> bool:
        """True when no request is queued (the engine's solo-bypass test)."""
        with self._cv:
            return not self._queue

    def _take_group(self) -> list[_PendingRequest]:
        """Oldest request + every compatible request that arrives before the
        oldest's arrival + window, or until ``max_songs`` rows."""
        with self._cv:
            while not self._queue:
                self._cv.wait()
            t = self._queue[0].t
            infer = self._queue[0].ws is None
            deadline = self._queue[0].arrival + self.window_s
            while True:
                group, songs = [], 0
                for r in self._queue:
                    # a later request joins only if it fits (the first always
                    # does: generate() chunks oversized requests)
                    if (r.t == t and (r.ws is None) == infer
                            and songs + len(r.seeds) <= self.max_songs):
                        group.append(r)
                        songs += len(r.seeds)
                now = time.perf_counter()
                if songs >= self.max_songs or now >= deadline:
                    for r in group:
                        self._queue.remove(r)
                    return group
                self._cv.wait(timeout=deadline - now)

    def _loop(self):
        while True:
            group = self._take_group()
            try:
                self._run_group(group)
            except Exception as e:  # surface to every caller, keep serving
                for r in group:
                    r.error = e
                    r.event.set()

    def _deliver_loop(self):
        while True:
            with self._delivery_cv:
                while not self._delivery:
                    self._delivery_cv.wait()
                out, group = self._delivery.pop(0)
            try:
                host = out.cpu().numpy()  # ONE device->host copy for the group
            except Exception as e:  # device-side failure: report to every caller
                for r in group:
                    r.error = e
                    r.event.set()
                continue
            i = 0
            for r in group:
                k = len(r.seeds)
                r.result = host[i : i + k]
                i += k
                r.event.set()

    def _run_group(self, group: list[_PendingRequest]):
        eng = self.engine
        t = group[0].t
        seeds = np.concatenate([r.seeds for r in group], axis=0)
        n = len(seeds)
        b = _bucket(n, eng.BATCH_BUCKETS)
        pad = b - n
        if pad < 0:
            raise ValueError("oversized group: generate() must chunk to the max bucket")
        if pad:
            seeds = np.concatenate([seeds, np.repeat(seeds[:1], pad, axis=0)])
        seeds_dev = eng._to_device(seeds)
        if group[0].ws is None:
            ws_dev = eng._infer_ws(seeds_dev, b)  # one batched inference per group
        else:
            ws = np.concatenate([r.ws for r in group], axis=0)
            if pad:
                ws = np.concatenate([ws, np.repeat(ws[:1], pad, axis=0)])
            ws_dev = eng._to_device(ws)
        eng._mark_bucket(b, t)
        # launch only: the delivery thread waits for the result, so the
        # worker goes on to the next group while this one runs
        out = eng._run(seeds_dev, t, ws_dev)
        with eng._lock:
            eng.stats["batches"] += 1
            eng.stats["batched_songs"] += n
        with self._delivery_cv:
            self._delivery.append((out, group))
            self._delivery_cv.notify()


class GenerationEngine:
    """Thread-safe generation service over loaded weights; the family is
    the config's type.

    ``params``: the parameter tree (NumPy arrays or tensors, JAX layout);
    ``seed_bank``: [N, Tseed, D] seed windows (cl_vrnn) or [N, D] seed
    frames (cl_vae); ``seed_keys``: optional key index per seed
    (key-filtered and true-key requests); ``seed``: seeds the engine's
    ``torch.Generator`` (sampling noise) and its host RNG (seed choice);
    ``device``: ``"cuda"`` (the default; raises without a card) or ``"cpu"``;
    ``mesh``: a :class:`..parallel.Mesh` whose data axis the songs of a
    batch split over (the engine then lives on its first device, and the
    parameters are replicated once a device at construction); it must
    divide some batch bucket.
    """

    BATCH_BUCKETS = (1, 4, 16, 64)
    STEP_BUCKETS = (32, 64, 128, 256)

    def __init__(self, params, cfg, seed_bank: np.ndarray,
                 seed_keys: np.ndarray | None = None, seed: int = 0, device="cuda",
                 dynamic_batching: bool = False,
                 batch_window_ms: float = DynamicBatcher.DEFAULT_WINDOW_MS, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            n_data = mesh.shape["data"]
            if not any(b % n_data == 0 for b in self.BATCH_BUCKETS):
                raise ValueError(
                    f"dp={n_data} divides no batch bucket {self.BATCH_BUCKETS}: "
                    "every request would silently fall back to single-device")
            device = mesh.data_devices[0]
        self.device = resolve_device(device)
        self.family = "cl_vae" if isinstance(cfg, cl_vae.Config) else "cl_vrnn"
        kernel = cuda_generate_vae if self.family == "cl_vae" else cuda_generate
        # the cl_vae kernels take every width; the cl_vrnn kernel has a limit
        if self.device.type == "cuda" and self.family == "cl_vrnn" and not kernel.fits(cfg):
            raise ValueError(f"hidden {cfg.intermediate_dim} needs {kernel.smem_bytes(cfg)} B "
                             "of shared memory per block: too wide for the generation kernel")
        self.cfg = cfg
        self.mode = kernel.pick_mode(cfg)
        self.params = params_from_numpy(params, self.device)
        # one replica a mesh device, made once (the first is self.params)
        self._replicas = None
        if mesh is not None:
            from ..parallel import replicate

            self._replicas = replicate(self.params, mesh)
        self.seed_bank = np.asarray(seed_bank, dtype=np.float32)
        self.seed_keys = seed_keys
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "songs": 0, "gen_seconds": 0.0, "warm_buckets": 0,
                      "batches": 0, "batched_songs": 0}
        # solo bypass dispatches in flight: claimed under the lock so that in
        # a concurrent burst exactly one request runs solo and the rest coalesce
        self._inflight = 0
        self._warm: set = set()
        self._latencies: list = []    # per-request seconds (bounded ring)
        self._completions: list = []  # (completion time, songs), bounded ring
        self._batcher = (
            DynamicBatcher(self, window_ms=batch_window_ms) if dynamic_batching else None)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch_buckets=None, step_buckets=None, background=False):
        """Run the FULL (songs, steps) bucket grid once (largest first), and
        w-inference at every batch bucket, so that no request pays the
        kernel build or a first-touch allocation. ``background=True`` runs it
        in a daemon thread and returns the thread."""
        bb = batch_buckets or self.BATCH_BUCKETS
        sb = step_buckets or self.STEP_BUCKETS
        pairs = sorted(((b, t) for b in bb for t in sb), key=lambda p: -(p[0] * p[1]))

        def _all():
            for b, t in pairs:
                self._generate_bucket(b, t)
            for b in sorted(bb, reverse=True):
                self._infer_ws(self._to_device(self.seed_bank[np.arange(b) % len(self.seed_bank)]), b)
            self._sync()

        if background:
            th = threading.Thread(target=_all, daemon=True)
            th.start()
            return th
        _all()
        return None

    def _mark_bucket(self, b: int, t: int) -> None:
        with self._lock:
            if (b, t) not in self._warm:
                self._warm.add((b, t))
                self.stats["warm_buckets"] += 1

    def _generate_bucket(self, b: int, t: int):
        seeds = self._to_device(self.seed_bank[np.arange(b) % len(self.seed_bank)])
        K = self.cfg.n_classes
        ws = torch.full((b, K), 1.0 / K, dtype=torch.float32, device=self.device)
        self._mark_bucket(b, t)
        out = self._run(seeds, t, ws)
        if self.family == "cl_vae":
            # a solo inferred-w request runs the sampler with ws=None (w
            # inferred inside it), as the JAX engine does: warm that entry too
            out = (out, self._run(seeds, t, None))
        self._sync()
        return out

    def _run(self, seeds, t, ws):
        # with a mesh, a batch that divides by its data axis splits over it
        dp = self.mesh is not None and seeds.shape[0] % self.mesh.shape["data"] == 0
        if self.family == "cl_vae":
            if dp:
                return generate_cl_vae_batch_dp(self._replicas, self.cfg, seeds, t,
                                                self._generator, ws, self.mesh)
            return generate_cl_vae_batch(self.params, self.cfg, seeds, t, self._generator,
                                         w_vals=ws)
        if dp:
            return generate_cl_vrnn_batch_dp(self._replicas, self.cfg, seeds, t,
                                             self._generator, ws, self.mesh)
        return generate_cl_vrnn_batch(self.params, self.cfg, seeds, t, self._generator, ws)

    def _infer_ws(self, seeds, m: int):
        """w for the first ``m`` seeds, inferred at the padded batch bucket."""
        b = _bucket(m, self.BATCH_BUCKETS)
        pad = b - seeds.shape[0]
        if pad > 0:
            seeds = torch.cat([seeds, seeds[:1].expand(pad, *seeds.shape[1:])], dim=0)
        if self.family == "cl_vae":
            return infer_w_cl_vae(self.params, seeds)[:m]
        return infer_w_cl_vrnn(self.params, self.cfg, seeds)[:m]

    def _coerce_seed_rolls(self, rolls: np.ndarray) -> np.ndarray:
        """Fit user rolls to the seed-bank shape: cl_vrnn front-pads/trims
        the time axis, cl_vae takes each roll's last frame."""
        rolls = np.asarray(rolls, dtype=np.float32)
        if rolls.ndim == 2:  # single roll [T, D]
            rolls = rolls[None]
        if self.family == "cl_vae":
            return rolls[:, -1] if rolls.ndim == 3 else rolls
        t_seed = self.seed_bank.shape[1]
        out = np.zeros((len(rolls), t_seed, self.seed_bank.shape[2]), np.float32)
        for i, r in enumerate(rolls):
            take = min(t_seed, len(r))
            out[i, -take:] = r[-take:, : out.shape[2]]
        return out

    def generate(self, n: int = 1, nsteps: int = 64, key_name_index: int | None = None,
                 infer_w: bool = True, seed_indices=None, seed_rolls=None) -> np.ndarray:
        """Generate n songs of nsteps frames; returns [n, nsteps, D] (NumPy).

        Requests pad up to bucket sizes; the extra songs and steps are sliced
        off. ``seed_rolls`` ([T, D] or [k, T, D]) seeds from user piano-rolls
        instead of the bank; ``key_name_index`` filters bank seeds by key (or,
        with user seeds, conditions on that key); ``infer_w=False`` conditions
        on each bank seed's true key.
        """
        maxb = self.BATCH_BUCKETS[-1]
        if n > maxb:  # chunk oversized requests to the largest bucket
            outs, done = [], 0
            while done < n:
                k = min(maxb, n - done)
                si = None if seed_indices is None else np.asarray(seed_indices)[done : done + k]
                sr = None
                if seed_rolls is not None:
                    sr = self._coerce_seed_rolls(seed_rolls)
                    sr = sr[done % len(sr) : done % len(sr) + k] if len(sr) > 1 else sr
                outs.append(self.generate(k, nsteps, key_name_index, infer_w, si, sr))
                done += k
            return np.concatenate(outs, axis=0)

        t0 = time.perf_counter()
        b = _bucket(n, self.BATCH_BUCKETS)
        t = _bucket(nsteps, self.STEP_BUCKETS)
        # solo bypass: with an empty queue, nothing in flight and a warm
        # bucket, coalescing could only add window latency
        batcher = self._batcher
        solo_claim = False
        if batcher is not None and (b, t) in self._warm and batcher.idle():
            with self._lock:
                if self._inflight == 0:
                    self._inflight += 1
                    solo_claim = True
                    batcher = None
        # the batcher pads the coalesced group; a solo request pads here
        m = n if batcher is not None else b

        user_seeds = None
        if seed_rolls is not None:
            user_seeds = self._coerce_seed_rolls(seed_rolls)
            seed_indices = np.zeros(m, dtype=np.int64)
        elif seed_indices is None:
            pool = np.arange(len(self.seed_bank))
            if key_name_index is not None and self.seed_keys is not None:
                pool = pool[np.asarray(self.seed_keys) == key_name_index]
                if len(pool) == 0:
                    raise ValueError(f"no seeds with key index {key_name_index}")
            with self._lock:
                seed_indices = self._rng.choice(pool, size=m, replace=len(pool) < m)
        else:
            seed_indices = np.resize(np.asarray(seed_indices), m)

        if user_seeds is not None:
            seeds = np.resize(user_seeds, (m,) + user_seeds.shape[1:])
        else:
            seeds = self.seed_bank[seed_indices]
        eye = np.eye(self.cfg.n_classes, dtype=np.float32)
        seeds_dev = None
        if user_seeds is not None and key_name_index is not None:
            ws = np.tile(eye[key_name_index], (m, 1))
        elif infer_w or user_seeds is not None:
            if batcher is not None or self.family == "cl_vae":
                # the batcher infers w once per coalesced group; a solo cl_vae
                # request leaves it to the sampler (w_vals=None)
                ws = None
            else:
                seeds_dev = self._to_device(seeds)
                ws = self._infer_ws(seeds_dev, m)
        else:
            if self.seed_keys is None:
                raise ValueError("true-key conditioning needs seed_keys")
            ws = eye[np.asarray(self.seed_keys)[seed_indices]]

        try:
            if batcher is not None:
                out = batcher.submit(seeds, ws, t)[:n, :nsteps]
            else:
                self._mark_bucket(b, t)
                if seeds_dev is None:
                    seeds_dev = self._to_device(seeds)
                ws_dev = (ws if ws is None or isinstance(ws, torch.Tensor)
                          else self._to_device(ws))
                out = self._run(seeds_dev, t, ws_dev)[:n, :nsteps].cpu().numpy()
        finally:
            if solo_claim:
                with self._lock:
                    self._inflight -= 1
        dt = time.perf_counter() - t0
        with self._lock:
            self.stats["requests"] += 1
            self.stats["songs"] += n
            self.stats["gen_seconds"] += dt
            self._latencies.append(dt)
            self._completions.append((time.perf_counter(), n))
            if len(self._latencies) > 1024:  # bounded window
                self._latencies = self._latencies[-1024:]
                self._completions = self._completions[-1024:]
        return out

    def latency_stats(self) -> dict:
        """p50/p95/p99 request latency (ms) and songs/sec over the recent
        window (completion timestamps, so overlapping requests count against
        wall-clock)."""
        with self._lock:
            lats = list(self._latencies)
            comps = list(self._completions)
        out = {"p50_ms": None, "p95_ms": None, "p99_ms": None, "songs_per_sec": None}
        if lats:
            q = np.percentile(np.asarray(lats) * 1e3, [50, 95, 99])
            out.update(p50_ms=float(q[0]), p95_ms=float(q[1]), p99_ms=float(q[2]))
        if len(comps) >= 2:
            span = comps[-1][0] - comps[0][0]
            if span > 0:
                out["songs_per_sec"] = sum(n for _, n in comps[1:]) / span
        return out
