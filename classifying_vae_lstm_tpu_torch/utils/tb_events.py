"""Minimal TensorBoard scalar-event writer (and reader), dependency-free.

Copy of ``classifying_vae_lstm_tpu/utils/tb_events.py``. ``--do_log`` writes
a JSONL metrics file and, through this module, a TensorBoard event file, so
the per-epoch scalars open in TensorBoard beside the ``torch.profiler``
traces of ``--trace_dir``, without importing tensorboard into the training
process. The two packages' files are the same format: each reads the other's.

Implements just enough of the formats involved:

* protobuf wire encoding of ``Event{wall_time, step, summary{value{tag,
  simple_value}}}`` (tensorflow/core/util/event.proto);
* TFRecord framing: little-endian uint64 length + masked CRC32C of the
  length + payload + masked CRC32C of the payload;
* CRC32C (Castagnoli) with the TF record mask
  ``((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff``.

``read_scalar_events`` parses the same subset back (for tests and for the
JSONL -> TensorBoard converter).
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_event(wall_time: float, step: int | None = None,
                  file_version: str | None = None,
                  scalars: dict[str, float] | None = None) -> bytes:
    msg = bytearray()
    msg += _field(1, 1) + struct.pack("<d", wall_time)  # wall_time: double
    if step is not None:
        msg += _field(2, 0) + _varint(step)  # step: int64 (non-negative here)
    if file_version is not None:
        fv = file_version.encode()
        msg += _field(3, 2) + _varint(len(fv)) + fv
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            tb = tag.encode()
            val = bytearray()
            val += _field(1, 2) + _varint(len(tb)) + tb  # Value.tag
            val += _field(2, 5) + struct.pack("<f", float(value))  # simple_value
            summary += _field(1, 2) + _varint(len(val)) + bytes(val)  # Summary.value
        msg += _field(5, 2) + _varint(len(summary)) + bytes(summary)  # Event.summary
    return bytes(msg)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class ScalarEventWriter:
    """Append-only TB event file: ``<logdir>/events.out.tfevents.<ts>.<host>``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_encode_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        self._f.write(_record(_encode_event(time.time(), step=step, scalars=scalars)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire_type: int) -> int:
    """Advance past an unknown field; raise on malformed/unsupported types
    (wire types 3/4 — groups — would otherwise loop forever)."""
    if wire_type == 0:
        _, i = _read_varint(buf, i)
        return i
    if wire_type == 1:
        return i + 8
    if wire_type == 2:
        ln, i = _read_varint(buf, i)
        return i + ln
    if wire_type == 5:
        return i + 4
    raise ValueError(f"malformed event record: wire type {wire_type}")


def _parse_summary(buf: bytes) -> dict[str, float]:
    out = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        if key >> 3 == 1 and key & 7 == 2:  # Value
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
            j = 0
            tag, sv = None, None
            while j < len(val):
                k2, j = _read_varint(val, j)
                fn, wt = k2 >> 3, k2 & 7
                if fn == 1 and wt == 2:
                    ln2, j = _read_varint(val, j)
                    tag = val[j : j + ln2].decode()
                    j += ln2
                elif fn == 2 and wt == 5:
                    sv = struct.unpack("<f", val[j : j + 4])[0]
                    j += 4
                else:
                    j = _skip_field(val, j, wt)
            if tag is not None and sv is not None:
                out[tag] = sv
        else:
            i = _skip_field(buf, i, key & 7)
    return out


def read_scalar_events(path: str) -> list[tuple[int, dict[str, float]]]:
    """Parse an event file back to [(step, {tag: value})] (CRCs verified)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError("truncated event file: partial record header")
        (length,) = struct.unpack("<Q", data[i : i + 8])
        (hcrc,) = struct.unpack("<I", data[i + 8 : i + 12])
        if hcrc != _masked_crc(data[i : i + 8]):
            raise ValueError("event file header CRC mismatch")
        if i + 16 + length > len(data):
            raise ValueError("truncated event file: partial record payload")
        payload = data[i + 12 : i + 12 + length]
        (pcrc,) = struct.unpack("<I", data[i + 12 + length : i + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError("event file payload CRC mismatch")
        i += 16 + length
        # parse Event fields
        j = 0
        step, scalars = 0, {}
        while j < len(payload):
            key, j = _read_varint(payload, j)
            fn, wt = key >> 3, key & 7
            if fn == 1 and wt == 1:
                j += 8
            elif fn == 2 and wt == 0:
                step, j = _read_varint(payload, j)
            elif fn == 5 and wt == 2:
                ln, j = _read_varint(payload, j)
                scalars = _parse_summary(payload[j : j + ln])
                j += ln
            else:
                j = _skip_field(payload, j, wt)
        if scalars:
            out.append((step, scalars))
    return out


def jsonl_to_tb(jsonl_path: str, logdir: str) -> str:
    """Convert a ``--do_log`` JSONL metrics file to a TB event file."""
    import json

    w = ScalarEventWriter(logdir)
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            epoch = int(rec.pop("epoch", 0))
            w.add_scalars(epoch, {k: v for k, v in rec.items()
                                  if isinstance(v, (int, float))})
    w.close()
    return w.path


if __name__ == "__main__":  # python -m ...utils.tb_events run.jsonl <logdir>
    import sys

    print(jsonl_to_tb(sys.argv[1], sys.argv[2]))
