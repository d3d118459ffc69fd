"""HTTP serving frontend for trained models of either family, on the card.

    python -m classifying_vae_lstm_tpu_torch.cli.serve -i artifacts/jsball_vrnn4.npz \\
        --train_file data/input/Piano-midi_all.pickle --port 8787
    python -m classifying_vae_lstm_tpu_torch.cli.serve -i artifacts/jsball_vae.npz \\
        --train_file data/input/Piano-midi_all.pickle --port 8787

Endpoints (JSON):
  GET  /healthz          -> {"ok": true}
  GET  /stats            -> engine counters, latency percentiles, kernel launches
  POST /generate         -> {"n": 2, "t": 64, "infer_w": true, "key": "C",
                             "format": "roll" | "midi_base64",
                             "seed_midi_base64": "..."}
                            returns rolls (nested lists) or base64 .mid files

The family (``--family auto``) is read from the checkpoint's args: cl_vae
checkpoints carry ``intermediate_class_dim``. A cl_vrnn engine seeds from
corpus windows, a cl_vae engine from their first frames; a seq-concat cl_vae
engine (``seq_length > 1``) from whole windows, flattened as in training,
and its ``t`` generated rows come back as ``t x seq_length`` frames of 88
pitches (the JAX frontend seeds it with frames it cannot read). Generation runs on
``--device`` (``cuda`` by default, where every request is one launch of the
family's whole-generation CUDA kernel; ``cpu`` runs its plain version). The
flags are the JAX frontend's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data import MidiWriter, PianoData, roll_from_smf_bytes
from ..ops import cuda_generate, cuda_generate_vae
from ..serving import DynamicBatcher, GenerationEngine
from ..train.checkpoint import load_model_args
from . import common


class Server(ThreadingHTTPServer):
    """The HTTP server, with a listen backlog that holds a burst of clients.

    socketserver's default backlog of 5 drops the connection requests of a
    larger burst while the accepting thread waits for the interpreter lock,
    and each dropped client retries only after TCP's 1 s initial timeout.
    """

    request_queue_size = 128


def build_engine(args) -> tuple[GenerationEngine, dict, common.SeqConcat | None]:
    """The engine, the corpus's key map and, for a seq-concat cl_vae
    checkpoint, its layout of rows (None otherwise)."""
    family = args.family
    if family == "auto":
        family = "cl_vae" if "intermediate_class_dim" in load_model_args(args.model_file) else "cl_vrnn"
    params, cfg, margs = common.load_model(args.model_file, family)
    layout = None
    if family == "cl_vae":
        layout = common.SeqConcat.of(args.train_file, margs)
        choice = getattr(args, "gen_backend", "auto")
        cfg = common.resolve_gen_backend(cfg, choice)
        if choice == "auto":
            print(f"gen_backend=auto -> {cfg.gen_backend}")
    else:
        cfg = common.resolve_lstm_backend(cfg, getattr(args, "lstm_backend", "auto"))
    squeeze = family == "cl_vae"
    P = PianoData(args.train_file, batch_size=1,
                  seq_length=layout.seq_length if layout else args.seed_len, squeeze_x=squeeze)
    if layout:
        seeds = layout.rows(P.x_test)
    else:
        seeds = P.x_test[:, 0] if squeeze and P.x_test.ndim == 3 else P.x_test
    engine = GenerationEngine(params, cfg, seeds, P.test_song_keys,
                              device=getattr(args, "device", "cuda"),
                              mesh=common.dp_mesh(args) if getattr(args, "dp", 1) > 1 else None,
                              dynamic_batching=getattr(args, "dynamic_batching", False),
                              batch_window_ms=getattr(args, "batch_window_ms",
                                                      DynamicBatcher.DEFAULT_WINDOW_MS))
    return engine, dict(P.key_map), layout


def _midi_b64(roll, is_jsb: bool) -> str:
    if is_jsb:
        roll = np.repeat(roll, 2, axis=0)
    with tempfile.NamedTemporaryFile(suffix=".mid", delete=False) as f:
        path = f.name
    try:
        MidiWriter().dump_sequence_to_midi(roll, path)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


def make_handler(engine: GenerationEngine, key_map: dict, is_jsb: bool, layout=None):
    """The request handler; ``layout`` (``common.SeqConcat``) maps a
    seq-concat engine's rows to piano rolls and a seed MIDI to a row."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                vae = engine.family == "cl_vae"
                kmod = cuda_generate_vae if vae else cuda_generate
                resolved = {"family": engine.family, "device": str(engine.device),
                            "mode": engine.mode,
                            "gen_path": "cuda_kernel" if engine.device.type == "cuda" else "plain",
                            "kernel_launches": kmod.LAUNCHES + kmod.INT8_LAUNCHES,
                            "int8_launches": kmod.INT8_LAUNCHES}
                if vae:
                    resolved["gen_backend"] = engine.cfg.gen_backend
                else:
                    resolved["lstm_backend"] = engine.cfg.lstm_backend
                self._send(200, {**engine.stats, **engine.latency_stats(), **resolved})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._send(400, {"error": f"invalid JSON body: {e}"})
                    return
                n = int(req.get("n", 1))
                t = int(req.get("t", 64))
                fmt = req.get("format", "roll")
                if n < 1 or t < 1:
                    self._send(400, {"error": "n and t must be >= 1"})
                    return
                max_n = engine.BATCH_BUCKETS[-1]
                max_t = engine.STEP_BUCKETS[-1]
                if n > max_n or t > max_t:
                    self._send(400, {"error": f"n <= {max_n} and t <= {max_t} "
                                              f"(largest warmed buckets)"})
                    return
                if fmt not in ("roll", "midi_base64"):
                    self._send(400, {"error": f"unknown format {fmt!r}",
                                     "known": ["roll", "midi_base64"]})
                    return
                key_idx = key_map.get(req["key"]) if "key" in req else None
                if "key" in req and key_idx is None:
                    self._send(400, {"error": f"unknown key {req['key']!r}",
                                     "known": sorted(key_map)})
                    return
                seed_rolls = None
                if "seed_midi_base64" in req:
                    try:
                        seed_rolls = roll_from_smf_bytes(
                            base64.b64decode(req["seed_midi_base64"]))
                    except Exception as e:  # noqa: BLE001 — malformed client bytes
                        self._send(400, {"error": f"bad seed MIDI: {e}"})
                        return
                    if len(seed_rolls) == 0:
                        self._send(400, {"error": "seed MIDI contains no notes"})
                        return
                    if layout:
                        seed_rolls = layout.rows(seed_rolls[:, :88])[None]
                rolls = engine.generate(n=n, nsteps=t, key_name_index=key_idx,
                                        infer_w=bool(req.get("infer_w", True)),
                                        seed_rolls=seed_rolls)
                if layout:
                    rolls = layout.rolls(rolls)
                if fmt == "midi_base64":
                    out = {"midi_base64": [_midi_b64(r, is_jsb) for r in rolls]}
                else:
                    out = {"rolls": rolls.astype(int).tolist()}
                self._send(200, {"n": n, "t": t, **out})
            except Exception as e:  # noqa: BLE001 — report to client
                self._send(500, {"error": str(e)})

    return Handler


def make_server(args) -> tuple[Server, GenerationEngine]:
    """Engine (warmed as ``--warmup`` says) behind a bound HTTP server;
    ``--port 0`` binds an ephemeral port (``httpd.server_address[1]``)."""
    engine, key_map, layout = build_engine(args)
    if args.warmup == "full":
        print("warming the full bucket grid...", flush=True)
        engine.warmup()
    elif args.warmup == "background":
        engine.warmup(background=True)
    is_jsb = "jsb" in args.train_file.lower()
    httpd = Server((args.host, args.port), make_handler(engine, key_map, is_jsb, layout))
    return httpd, engine


def serve(args):
    httpd, engine = make_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (device {engine.device})", flush=True)
    httpd.serve_forever()


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--model_file", type=str, required=True)
    parser.add_argument("--train_file", type=str, default=common.DEFAULT_TRAIN_FILE,
                        help="corpus providing seed windows")
    parser.add_argument("--seed_len", type=int, default=32, help="seed window length")
    parser.add_argument("--family", type=str, default="auto",
                        choices=["auto", "cl_vae", "cl_vrnn"],
                        help="'auto' reads the family from the checkpoint's args")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda: the whole-generation CUDA kernel; cpu: its plain version")
    parser.add_argument("--lstm_backend", type=str, default="auto",
                        choices=["auto", "keep", "xla", "pallas"],
                        help="cl_vrnn: 'auto' resolves to 'xla', 'keep' keeps the "
                             "checkpoint's; generation on cuda always runs a CUDA kernel, "
                             "and 'pallas' picks int8 weights for a bf16 checkpoint where "
                             "the JAX package does")
    parser.add_argument("--gen_backend", type=str, default="auto",
                        choices=["auto", "keep", "xla", "pallas"],
                        help="cl_vae: 'auto' resolves to 'xla'; generation on cuda always "
                             "runs a CUDA kernel, whose f32 frames equal the scan's, and "
                             "'pallas' picks int8 weights for a bf16 checkpoint where the "
                             "JAX package does")
    parser.add_argument("--dp", type=int, default=1,
                        help="split each batch's songs over N > 1 devices (the first N cards, "
                             "or the CPU N times with --device cpu); 1: one device")
    parser.add_argument("--dynamic_batching", action="store_true",
                        help="coalesce concurrent /generate requests into one "
                             "bucketed launch (bounded wait window)")
    parser.add_argument("--batch_window_ms", type=float,
                        default=DynamicBatcher.DEFAULT_WINDOW_MS,
                        help="max queueing wait for request coalescing (ms); solo "
                             "traffic bypasses the window")
    parser.add_argument("--warmup", type=str, default="full",
                        choices=["full", "background", "off"],
                        help="run the bucket grid before serving: 'full' blocks, "
                             "'background' serves at once while a thread warms "
                             "largest-first, 'off' warms lazily")
    return parser


def _main():
    serve(build_parser().parse_args())


if __name__ == "__main__":
    _main()
