"""Minimal TensorBoard event-file writer (no tensorflow/tensorboard
dependency).

Parity target: the reference registers a TensorboardLoggerHook
(configs/train/1shot_split1.py:27-32) writing scalar curves (loss, PCK,
lr). TensorBoard's on-disk format is a TFRecord stream of serialized
`Event` protos; the subset needed for scalars is tiny, so the protobuf
encoding is done by hand here:

  Event { double wall_time = 1; int64 step = 2;
          oneof { string file_version = 3; Summary summary = 5; } }
  Summary { repeated Value value = 1; }
  Summary.Value { string tag = 1; float simple_value = 2; }

TFRecord framing: uint64-LE length, masked crc32c(length), payload,
masked crc32c(payload).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding

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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    val = _len_delim(1, tag.encode()) + _float(2, float(value))
    summary = _len_delim(1, val)
    return _double(1, wall_time) + _int64(2, step) + _len_delim(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


# ---------------------------------------------------------------- writer

class SummaryWriter:
    """Append-only scalar writer compatible with TensorBoard's loader."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, name), "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------- reader (for
# tests and offline inspection; parses only what the writer emits)

def read_scalars(path: str):
    """Parse an event file -> list of (tag, value, step)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt header crc"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt payload crc"
            out.extend(_parse_event(payload))
    return out


def _read_varint(buf, i):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _parse_event(buf):
    step = 0
    scalars = []
    for field, wire, val in _fields(buf):
        if field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:            # summary
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:           # value
                    tag, num = None, None
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            (num,) = struct.unpack("<f", v3)
                    if tag is not None and num is not None:
                        scalars.append((tag, num, step))
    return scalars
