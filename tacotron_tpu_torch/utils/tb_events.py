"""Dependency-free TensorBoard scalar event writer (and reader).

A copy of the JAX package's ``utils/tb_events.py``.  The reference logs its
training scalars as TF1 TensorBoard summaries (its ``train.py:50-77``); the
port's primary metrics sink
is ``metrics.jsonl`` (``utils/metrics.py``), but run dirs also get real
``events.out.tfevents.*`` files so stock TensorBoard points at them
unchanged.  No tensorflow/tensorboard import: the two protos involved are
tiny and stable, so they are serialized by hand.

Wire format (tensorflow/core/util/event.proto, summary.proto):

    Event  { double wall_time = 1; int64 step = 2;
             string file_version = 3; Summary summary = 5; }
    Summary{ repeated Value value = 1; }
    Value  { string tag = 1; float simple_value = 2; }

Framing (TFRecord): ``<uint64 len><uint32 masked_crc32c(len)><payload>
<uint32 masked_crc32c(payload)>`` with the Castagnoli CRC and TF's mask
rotation.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

# ------------------------------------------------------------------- crc32c

_CRC_TABLE: List[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ proto encode

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    buf = bytearray()
    buf += _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        buf += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        buf += _len_delim(3, file_version.encode("utf-8"))
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            v = (_len_delim(1, tag.encode("utf-8"))
                 + _key(2, 5) + struct.pack("<f", float(value)))
            summary += _len_delim(1, bytes(v))
        buf += _len_delim(5, bytes(summary))
    return bytes(buf)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------------- writer

class TBEventWriter:
    """Append TB scalar events to ``<logdir>/events.out.tfevents.*``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        self._file.write(_record(payload))
        self._file.flush()

    def scalars(self, step: int, values: Dict[str, float],
                wall_time: Optional[float] = None) -> None:
        """One Event carrying every (tag, simple_value) pair."""
        clean = {}
        for tag, value in values.items():
            try:
                clean[tag] = float(value)
            except (TypeError, ValueError):
                continue
        if clean:
            self._write(_event(wall_time or time.time(), int(step),
                               scalars=clean))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# ------------------------------------------------------------------- reader

def _iter_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError(f"corrupt record header in {path}")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError(f"corrupt record payload in {path}")
            yield payload


def _decode_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field, wire_type, raw) triples of one message."""
    i = 0
    while i < len(buf):
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, _varint(val)
        elif wire == 1:
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, buf[i:i + ln]
            i += ln
        elif wire == 5:
            yield field, wire, buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _read_varint(raw: bytes) -> int:
    val = 0
    shift = 0
    for b in raw:
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    return val


def read_tb_scalars(path: str) -> List[dict]:
    """Parse an events file back into ``[{step, wall_time, tag, value}]``
    (tests + ad-hoc analysis without a tensorboard install)."""
    out = []
    for payload in _iter_records(path):
        wall_time, step, summary = 0.0, 0, None
        for field, wire, raw in _decode_fields(payload):
            if field == 1 and wire == 1:
                (wall_time,) = struct.unpack("<d", raw)
            elif field == 2 and wire == 0:
                step = _read_varint(raw)
            elif field == 5 and wire == 2:
                summary = raw
        if summary is None:
            continue
        for field, wire, raw in _decode_fields(summary):
            if field != 1 or wire != 2:
                continue
            tag, value = None, None
            for f2, w2, r2 in _decode_fields(raw):
                if f2 == 1 and w2 == 2:
                    tag = r2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    (value,) = struct.unpack("<f", r2)
            if tag is not None and value is not None:
                out.append({"step": step, "wall_time": wall_time,
                            "tag": tag, "value": value})
    return out
