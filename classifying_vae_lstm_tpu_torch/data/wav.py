"""WAV rendering: binary piano-roll -> audio (pure NumPy and the stdlib).

Copy of ``classifying_vae_lstm_tpu/data/wav.py``: a small additive
synthesizer (3 harmonics, exponential decay, 5 ms attack/release ramps)
renders rolls to 16-bit PCM through the stdlib ``wave`` module. It runs on
the host; audio rendering is not a device workload.
"""

from __future__ import annotations

import os
import wave

import numpy as np


def midi_to_hz(pitch_index: np.ndarray, offset: int = 21) -> np.ndarray:
    """Piano-roll pitch index (0..87) -> frequency in Hz (A4=440, MIDI 69)."""
    midi = np.asarray(pitch_index) + offset
    return 440.0 * 2.0 ** ((midi - 69) / 12.0)


def render_roll(roll, frame_sec: float = 0.25, sr: int = 22050) -> np.ndarray:
    """Render a [T, 88] binary roll to a float waveform in [-1, 1]."""
    roll = np.asarray(roll)
    T, D = roll.shape
    spf = int(round(frame_sec * sr))
    n = T * spf
    t = np.arange(n) / sr
    sig = np.zeros(n)
    ramp = max(int(0.005 * sr), 1)
    kernel = np.ones(ramp) / ramp
    for p in np.nonzero(roll.any(axis=0))[0]:
        gate = np.repeat(roll[:, p].astype(np.float64), spf)
        gate = np.convolve(gate, kernel, mode="same")  # de-click
        f = float(midi_to_hz(p))
        tone = (
            np.sin(2 * np.pi * f * t)
            + 0.4 * np.sin(2 * np.pi * 2 * f * t)
            + 0.2 * np.sin(2 * np.pi * 3 * f * t)
        )
        # per-note exponential decay restarted at each onset
        onsets = np.flatnonzero(np.diff(np.concatenate([[0], roll[:, p]])) > 0) * spf
        if len(onsets):
            since = np.arange(n) - onsets[np.searchsorted(onsets, np.arange(n), side="right") - 1]
            env = np.exp(-since / (0.8 * sr))
        else:
            env = 1.0
        sig += gate * env * tone
    peak = np.abs(sig).max()
    return sig / peak if peak > 0 else sig


def write_wav(sig: np.ndarray, path: str, sr: int = 22050) -> str:
    pcm = np.clip(sig * 0.9, -1, 1)
    pcm = (pcm * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return path


def write_sample_wav(sample, outdir, fnm, isHalfAsSlow: bool = False,
                     frame_sec: float = 0.25, sr: int = 22050) -> str:
    """Mirror of :func:`.midi.write_sample`, rendering audio to ``<fnm>.wav``."""
    sample = np.asarray(sample)
    if isHalfAsSlow:
        sample = np.repeat(sample, 2, axis=0)
    path = os.path.join(outdir, fnm + ".wav")
    return write_wav(render_roll(sample, frame_sec, sr), path, sr)
