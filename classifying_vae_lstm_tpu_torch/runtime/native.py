"""ctypes bindings for the native host runtime (``cvl_runtime.cpp``).

Counterpart of ``classifying_vae_lstm_tpu/runtime/native.py``, with the
same three entry points and semantics (quirk Q1's dropped final window
included). The library is built with g++ at first use, never at import:

    g++ -O3 -std=c++17 -fPIC -pthread -shared -o build/torch_runtime/libcvl_runtime-<hash>.so

beside the CUDA kernels' ``build/torch_kernels/``, named by a hash of the
source. The build is atomic: g++ writes a temporary file, which
``os.replace`` moves to the final name under an exclusive file lock, so
processes that build at once (test workers, say) never load a half-written
library. A compiler failure raises; nothing falls back to NumPy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "cvl_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_runtime"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """The built library's path under ``BUILD_DIR``, compiled first if it is
    not there; raises ``RuntimeError`` if g++ fails."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libcvl_runtime-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cvl_sliding_window_f32.restype = ctypes.c_int64
            lib.cvl_sliding_window_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.cvl_song_to_roll_f32.restype = ctypes.c_int32
            lib.cvl_song_to_roll_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.cvl_gather_rows_f32.restype = None
            lib.cvl_gather_rows_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library builds here (g++ at first use) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def sliding_window_native(roll: np.ndarray, seq_length: int, step_length: int = 1):
    """Sliding windows with the semantics of ``data.pianoroll.sliding_window``
    (quirk Q1: the final valid window is dropped), as float32."""
    lib = _load()
    roll = np.ascontiguousarray(roll, dtype=np.float32)
    T, D = roll.shape
    n = len(range(0, T - seq_length, step_length)) if T - seq_length > 0 else 0
    if n == 0:
        return np.array([])
    out = np.empty((n, seq_length, D), dtype=np.float32)
    got = lib.cvl_sliding_window_f32(roll.ctypes.data, T, D, seq_length, step_length,
                                     out.ctypes.data)
    assert got == n, (got, n)
    return out


def song_to_roll_native(song, offset: int = 21):
    """Song (per-frame note lists) -> [T, 88] binary float32 roll, with the
    octave-shift rule of ``data.pianoroll.song_to_pianoroll``."""
    lib = _load()
    offsets = np.zeros(len(song) + 1, dtype=np.int64)
    for t, step in enumerate(song):
        offsets[t + 1] = offsets[t] + len(step)
    notes = np.fromiter((n for step in song for n in step), dtype=np.int32,
                        count=int(offsets[-1]))
    out = np.zeros((len(song), 88), dtype=np.float32)
    lib.cvl_song_to_roll_f32(notes.ctypes.data, offsets.ctypes.data, len(song), offset,
                             out.ctypes.data)
    return out


def gather_rows(src: np.ndarray, perm: np.ndarray):
    """out[i] = src[perm[i]] as float32 (threaded)."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    flat = src.reshape(len(src), -1)
    out = np.empty((len(perm), flat.shape[1]), dtype=np.float32)
    lib.cvl_gather_rows_f32(flat.ctypes.data, perm.ctypes.data, len(perm), flat.shape[1],
                            out.ctypes.data)
    return out.reshape((len(perm),) + src.shape[1:])
