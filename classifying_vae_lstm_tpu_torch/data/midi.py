"""MIDI: binary piano-roll <-> Standard MIDI File bytes (pure NumPy).

Copy of what serving and the sample CLIs need from
``classifying_vae_lstm_tpu/data/midi.py``: :class:`MidiWriter` (the
reference's event semantics: format-1 file, 4/4 meta track, NoteOn/NoteOff
diffing, pitch offset +21, tick step 120, resolution 480, velocity 100),
:func:`write_sample` (``<fnm>.mid``, frames doubled for JSB corpora), the
round-trip parser :func:`read_midi_roll`, and the general SMF input path
(:func:`parse_smf`, :func:`quantize_notes`, :func:`roll_from_smf_bytes`,
:func:`midi_to_roll`) that seeds generation from a user's MIDI file, and the
key labelling of a parsed file (:func:`key_from_midi`: its key-signature
meta, else the Krumhansl-Schmuckler estimate :func:`estimate_key`) that a
corpus built from a MIDI directory uses (:mod:`.corpus`).
"""

from __future__ import annotations

import os
import struct

import numpy as np

RANGE = 128


def _vlq(value: int) -> bytes:
    """Encode a variable-length quantity (SMF delta time)."""
    if value < 0:
        raise ValueError(f"negative delta time: {value}")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _read_vlq(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload)) + payload


class MidiWriter:
    """Dump a binary piano-roll sequence to a .mid file.

    Mirrors the reference ``MidiWriter`` (``utils/midi_utils.py:11-98``).
    """

    def __init__(self, verbose: bool = False, default_vel: int = 100):
        self.verbose = verbose
        self.note_range = RANGE
        self.default_velocity = default_vel

    def _event(self, tick: int, status: int, *data: int) -> None:
        self._track.append(_vlq(tick) + bytes([status, *data]))

    def note_off(self, val: int, tick: int) -> int:
        self._event(tick, 0x80, val, 0)
        return 0

    def note_on(self, val: int, tick: int) -> int:
        self._event(tick, 0x90, val, self.default_velocity)
        return 0

    def dump_sequence_to_midi(
        self,
        seq,
        output_filename,
        time_step: int = 120,
        resolution: int = 480,
        metronome: int = 24,
        offset: int = 21,
        format: str = "final",
    ) -> None:
        if format == "icml":
            # seq is a list of lists of active MIDI notes per timestep
            sequence = np.zeros([len(seq), self.note_range])
            for t, tmstp in enumerate(seq):
                sequence[t, list(tmstp)] = 1
        elif format == "flat":
            sequence = np.reshape(seq, [-1, self.note_range])
        else:
            sequence = np.asarray(seq)

        # meta track: 4/4 time signature + end of track
        meta = _vlq(0) + bytes([0xFF, 0x58, 0x04, 4, 2, metronome, 8])
        meta += _vlq(0) + bytes([0xFF, 0x2F, 0x00])

        self._track: list[bytes] = []
        tick = time_step
        self.notes_on = {n: False for n in range(self.note_range)}
        for frame in sequence:
            notes = [int(n) + offset for n in np.nonzero(frame)[0]]
            # NoteOffs first; the first event in the frame consumes the tick
            for n in self.notes_on:
                if self.notes_on[n] and n not in notes:
                    tick = self.note_off(n, tick)
                    self.notes_on[n] = False
            for note in notes:
                if not self.notes_on[note]:
                    tick = self.note_on(note, tick)
                    self.notes_on[note] = True
            tick += time_step

        # flush out notes still sounding
        for n in self.notes_on:
            if self.notes_on[n]:
                self.note_off(n, tick)
                tick = 0
                self.notes_on[n] = False
        self._track.append(_vlq(0) + bytes([0xFF, 0x2F, 0x00]))

        header = _chunk(b"MThd", struct.pack(">HHH", 1, 2, resolution))
        data = header + _chunk(b"MTrk", meta) + _chunk(b"MTrk", b"".join(self._track))
        with open(output_filename, "wb") as f:
            f.write(data)


def write_sample(sample, outdir, fnm, isHalfAsSlow: bool = False) -> str:
    """Write a generated roll as ``<outdir>/<fnm>.mid``; ``isHalfAsSlow``
    doubles every frame (the JSB corpora's frame rate)."""
    sample = np.asarray(sample)
    if isHalfAsSlow:
        sample = np.repeat(sample, 2, axis=0)
    path = os.path.join(outdir, fnm + ".mid")
    MidiWriter().dump_sequence_to_midi(sample, path)
    return path


def read_midi_roll(path, time_step: int = 120, offset: int = 21, note_range: int = 88):
    """Parse a .mid written by :class:`MidiWriter` back into a binary roll
    (assumes the writer's fixed grid; trailing silent frames are not
    representable in the format and come back missing)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path} is not a MIDI file (missing MThd)")
    (ntracks,) = struct.unpack(">H", data[10:12])
    pos = 8 + struct.unpack(">I", data[4:8])[0]
    events = []  # (abs_tick, on/off, pitch)
    for _ in range(ntracks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError(f"{path}: bad track chunk")
        (length,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        tpos, end = pos + 8, pos + 8 + length
        abs_tick = 0
        while tpos < end:
            delta, tpos = _read_vlq(data, tpos)
            abs_tick += delta
            status = data[tpos]
            if status == 0xFF:  # meta
                mlen, mpos = _read_vlq(data, tpos + 2)
                tpos = mpos + mlen
            elif status in (0x80, 0x90):
                pitch, vel = data[tpos + 1], data[tpos + 2]
                events.append((abs_tick, status == 0x90 and vel > 0, pitch))
                tpos += 3
            else:
                raise ValueError(f"unexpected status byte {status:#x}")
        pos = end
    if not events:
        return np.zeros((0, note_range))
    # frame f's events sit at absolute tick (f+1)*time_step, and a final
    # flush of NoteOffs one frame past the end
    by_frame: dict[int, list] = {}
    for t, on, pitch in events:
        by_frame.setdefault(t // time_step - 1, []).append((on, pitch))
    last = max(by_frame)
    n_frames = last if all(not on for on, _ in by_frame[last]) else last + 1
    roll = np.zeros((n_frames, note_range))
    state = np.zeros(note_range, dtype=bool)
    for f in range(n_frames):
        for on, pitch in by_frame.get(f, []):
            state[pitch - offset] = on
        roll[f] = state
    return roll


def parse_smf(data: bytes):
    """General SMF parser: returns (division, notes, key_sig).

    ``notes`` is a list of (start_tick, end_tick, pitch) merged across all
    tracks (percussion channel 10 skipped); ``key_sig`` is the first key
    signature meta event as (sf, mi) or None. Handles running status, meta
    and sysex events, and all channel voice messages — the general MIDI
    *input* path the reference delegated to the py2 ``midi`` package.
    """
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    (hlen,) = struct.unpack(">I", data[4:8])
    _fmt, ntracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    pos = 8 + hlen
    notes = []
    key_sig = None
    for _ in range(ntracks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        (length,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        i, end = pos + 8, pos + 8 + length
        tick = 0
        status = 0
        active: dict = {}  # (channel, pitch) -> start tick
        while i < end:
            delta, i = _read_vlq(data, i)
            tick += delta
            b = data[i]
            if b & 0x80:
                status = b
                i += 1
            # else running status: reuse the previous status byte
            if status == 0xFF:  # meta
                mtype = data[i]
                mlen, i = _read_vlq(data, i + 1)
                if mtype == 0x59 and key_sig is None and mlen >= 2:
                    sf = struct.unpack("b", data[i : i + 1])[0]
                    key_sig = (sf, data[i + 1])
                i += mlen
                if mtype == 0x2F:
                    break
            elif status in (0xF0, 0xF7):  # sysex
                slen, i = _read_vlq(data, i)
                i += slen
            else:
                kind = status & 0xF0
                ch = status & 0x0F
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = data[i], data[i + 1]
                    i += 2
                    if ch != 9:  # skip percussion
                        if kind == 0x90 and d2 > 0:
                            active.setdefault((ch, d1), tick)
                        elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                            start = active.pop((ch, d1), None)
                            if start is not None and tick > start:
                                notes.append((start, tick, d1))
                elif kind in (0xC0, 0xD0):
                    i += 1
                else:
                    raise ValueError(f"unexpected status {status:#x}")
        for (ch, pitch), start in active.items():  # close hanging notes
            if tick > start:
                notes.append((start, tick, pitch))
        pos = end
    return division, notes, key_sig


def quantize_notes(division: int, notes, frames_per_beat: int = 2):
    """Sample note intervals onto a frame grid (eighth notes by default — the
    pickled-corpus convention); returns a list of per-frame pitch lists."""
    if not notes:
        return []
    fl = division / frames_per_beat
    n_frames = int(np.ceil(max(e for _, e, _ in notes) / fl))
    frames = [set() for _ in range(n_frames)]
    for start, endt, pitch in notes:
        f0 = int(np.ceil(start / fl - 1e-9))
        f1 = max(f0 + 1, int(np.ceil(endt / fl - 1e-9)))
        for f in range(f0, min(f1, n_frames)):
            frames[f].add(pitch)
    return [sorted(f) for f in frames]


def roll_from_smf_bytes(data: bytes, frames_per_beat: int = 2, offset: int = 21,
                        note_range: int = 88) -> np.ndarray:
    """SMF bytes -> binary [T, 88] piano roll; out-of-range pitches are
    octave-shifted into range like the reference's ``song_to_pianoroll``
    (utils/pianoroll.py:31-47)."""
    division, notes, _ = parse_smf(data)
    song = quantize_notes(division, notes, frames_per_beat)
    roll = np.zeros((len(song), note_range), dtype=np.float32)
    for t, frame in enumerate(song):
        for p in frame:
            q = p - offset
            while q < 0:
                q += 12
            while q >= note_range:
                q -= 12
            roll[t, q] = 1.0
    return roll


def midi_to_roll(path: str, frames_per_beat: int = 2, offset: int = 21,
                 note_range: int = 88) -> np.ndarray:
    """Parse any .mid file into a binary [T, 88] piano roll (the general
    MIDI-input path: seeding generation from a user's MIDI)."""
    with open(path, "rb") as f:
        return roll_from_smf_bytes(f.read(), frames_per_beat, offset, note_range)


# --- key labeling (MIDI input side) -----------------------------------------

# key-signature meta (sf, mi) -> reference key names (lowercase = minor,
# '-' = flat; the vocabulary of utils/pianoroll.py:7-25)
MAJOR_BY_SF = {0: "C", 1: "G", 2: "D", 3: "A", 4: "E", 5: "B", 6: "F#", 7: "C#",
               -1: "F", -2: "B-", -3: "E-", -4: "A-", -5: "D-", -6: "G-", -7: "C-"}
MINOR_BY_SF = {0: "a", 1: "e", 2: "b", 3: "f#", 4: "c#", 5: "g#", 6: "d#", 7: "a#",
               -1: "d", -2: "g", -3: "c", -4: "f", -5: "b-", -6: "e-", -7: "a-"}

# Krumhansl-Kessler major/minor pitch-class profiles
_KS_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_KS_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])
_MAJOR_NAMES = ["C", "D-", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]
_MINOR_NAMES = ["c", "c#", "d", "e-", "e", "f", "f#", "g", "g#", "a", "b-", "b"]


def estimate_key(notes) -> str:
    """Krumhansl-Schmuckler: correlate the duration-weighted pitch-class
    histogram against all 24 rotated profiles."""
    hist = np.zeros(12)
    for start, endt, pitch in notes:
        hist[pitch % 12] += endt - start
    if hist.sum() == 0:
        return "C"
    best, best_r = "C", -2.0
    for rot in range(12):
        h = np.roll(hist, -rot)
        for prof, names in ((_KS_MAJOR, _MAJOR_NAMES), (_KS_MINOR, _MINOR_NAMES)):
            r = np.corrcoef(h, prof)[0, 1]
            if r > best_r:
                best_r, best = r, names[rot]
    return best


def key_from_midi(key_sig, notes) -> str:
    """Key label for a parsed file: the key-signature meta when present,
    else the Krumhansl-Schmuckler estimate."""
    if key_sig is not None:
        sf, mi = key_sig
        table = MINOR_BY_SF if mi else MAJOR_BY_SF
        if sf in table:
            return table[sf]
    return estimate_key(notes)
