"""Dependency-free TensorBoard scalar writer (tfevents files); the
port's copy of tpupose/utils/tensorboard.py.

The reference declares tensorboard/log directories in its config but never
consumes them (reference: HPE/configs/default.py:102-106, SURVEY.md §5.5).
Here the capability is actually implemented: a pure-Python writer that
emits standard TFRecord-framed `Event` protos readable by TensorBoard —
no tensorflow/tensorboard package needed (nothing beyond the stdlib).

Wire format, hand-encoded:
  * TFRecord frame: u64le(len) · u32le(maskedcrc(len)) · payload ·
    u32le(maskedcrc(payload)), crc = CRC-32C (Castagnoli),
    masked = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.
  * Event proto: wall_time=1(double), step=2(int64),
    file_version=3(string) | summary=5(msg{ value=1(msg{ tag=1(string),
    simple_value=2(float) }) }).

Scalars only — the reference never logs anything richer, and scalars are
what its (unused) tensorboard config intended.
"""

from __future__ import annotations

import os
import socket
import struct
import time

from tpupose_torch.utils.logging import is_master

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), table-driven; only runs on small framing buffers.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding (just what Event needs).
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return bytes([(num << 3) | 1]) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return bytes([(num << 3) | 5]) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return bytes([(num << 3) | 0]) + _varint(v)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([(num << 3) | 2]) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)
    return (_field_double(1, wall_time) + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _frame(payload: bytes) -> bytes:
    hdr = struct.pack("<Q", len(payload))
    return (hdr + struct.pack("<I", _masked_crc(hdr)) + payload
            + struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class SummaryWriter:
    """Append scalar events to an events.out.tfevents file. Master-only,
    flushed per event so dashboards tail live runs."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._fh = None
        if not log_dir or not is_master():
            return  # empty dir -> disabled no-op writer
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self._fh = open(os.path.join(log_dir, name), "ab")
        self._fh.write(_frame(_version_event(time.time())))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        if self._fh is None:
            return
        self._fh.write(_frame(_scalar_event(tag, value, step, time.time())))
        self._fh.flush()

    def add_scalars(self, scalars: dict, step: int, prefix: str = ""):
        for k, v in scalars.items():
            try:
                self.add_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
