"""Pure-Python reader/writer for TF1 TensorBundle checkpoints (a copy of
the JAX package's ``compat/bundle.py``).

The published reference models (``son``/``park``, the reference's
``download.py:82-109``) are TF1 ``model.ckpt-N`` bundles:

- ``<prefix>.index`` — a LevelDB-format SSTable mapping tensor names to
  serialized ``BundleEntryProto``s (dtype, shape, shard, offset, size);
- ``<prefix>.data-00000-of-00001`` — the raw little-endian tensor bytes.

Both sides of the format are implemented here dependency-free so the
training/serving stack never needs TensorFlow at runtime: varint-prefixed
prefix-compressed table blocks with restart arrays and a fixed 48-byte
footer (magic ``0xdb4775248b80fb57``), and a minimal protobuf codec for
``BundleEntryProto``/``BundleHeaderProto``.  The writer exists so the codec
is round-trip tested without TF and so trained models can be exported
toward TF tooling.  The JAX package's copy is cross-validated against
TensorFlow itself (``tests/test_tf_oracle.py``), and this one writes the
same bytes (``tests/test_torch_compat.py``).

Only the features TF1 checkpoints actually use are supported: uncompressed
or snappy-compressed blocks (snappy raises a clear error — TF writes the
bundle index uncompressed), little-endian, no tensor slices.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

TABLE_MAGIC = 0xdb4775248b80fb57

# TF DataType enum values we support (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: np.dtype("bfloat16")
    if hasattr(np, "bfloat16") else np.uint16, 19: np.float16,
}
_DTYPE_CODES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
                np.dtype(np.int32): 3, np.dtype(np.int64): 9,
                np.dtype(np.float16): 19, np.dtype(np.bool_): 10}


# ------------------------------------------------------------------ varints

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


# ------------------------------------------------------------------- crc32c

def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- minimal proto codec

def _proto_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _proto_field(field: int, wire: int, payload) -> bytes:
    tag = _write_varint(field << 3 | wire)
    if wire == 0:
        return tag + _write_varint(payload)
    if wire == 2:
        return tag + _write_varint(len(payload)) + payload
    if wire == 5:
        return tag + struct.pack("<I", payload)
    raise ValueError(f"unsupported wire type {wire}")


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, value in _proto_fields(buf):
        if field == 2:  # Dim
            size = 0
            for f2, _, v2 in _proto_fields(value):
                if f2 == 1:
                    # zigzag NOT used; plain varint (sizes are non-negative)
                    size = v2
            dims.append(size)
    return tuple(dims)


def _encode_shape(shape: Tuple[int, ...]) -> bytes:
    out = b""
    for size in shape:
        dim = _proto_field(1, 0, size)
        out += _proto_field(2, 2, dim)
    return out


class BundleEntry:
    def __init__(self, dtype_code=1, shape=(), shard_id=0, offset=0, size=0,
                 crc=0):
        self.dtype_code = dtype_code
        self.shape = tuple(shape)
        self.shard_id = shard_id
        self.offset = offset
        self.size = size
        self.crc = crc

    @classmethod
    def parse(cls, buf: bytes) -> "BundleEntry":
        e = cls()
        for field, _, value in _proto_fields(buf):
            if field == 1:
                e.dtype_code = value
            elif field == 2:
                e.shape = _parse_shape(value)
            elif field == 3:
                e.shard_id = value
            elif field == 4:
                e.offset = value
            elif field == 5:
                e.size = value
            elif field == 6:
                e.crc = value
        return e

    def encode(self) -> bytes:
        out = _proto_field(1, 0, self.dtype_code)
        out += _proto_field(2, 2, _encode_shape(self.shape))
        if self.shard_id:
            out += _proto_field(3, 0, self.shard_id)
        if self.offset:
            out += _proto_field(4, 0, self.offset)
        out += _proto_field(5, 0, self.size)
        out += _proto_field(6, 5, self.crc)
        return out


# --------------------------------------------------------------- table read

def _parse_block(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Entries of one table block (already decompressed, no trailer)."""
    num_restarts = struct.unpack_from("<I", data, len(data) - 4)[0]
    limit = len(data) - 4 - num_restarts * 4
    entries = []
    pos = 0
    key = b""
    while pos < limit:
        shared, pos = _read_varint(data, pos)
        unshared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos:pos + unshared]
        pos += unshared
        value = data[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_block(f, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    f.seek(offset)
    raw = f.read(size + 5)  # block + 1-byte type + 4-byte crc
    block, ctype = raw[:size], raw[size]
    if ctype == 1:
        raise NotImplementedError(
            "snappy-compressed table block; TF writes bundle indexes "
            "uncompressed — is this really a checkpoint index?")
    if ctype != 0:
        raise ValueError(f"unknown block compression {ctype}")
    return _parse_block(block)


def read_index(index_path: str) -> Dict[str, BundleEntry]:
    """Parse ``<prefix>.index`` into {tensor_name: BundleEntry}."""
    with open(index_path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_size = f.tell()
        f.seek(file_size - 48)
        footer = f.read(48)
        magic = struct.unpack_from("<Q", footer, 40)[0]
        if magic != TABLE_MAGIC:
            raise ValueError(f"{index_path}: not an SSTable (bad magic)")
        pos = 0
        _, pos = _read_varint(footer, pos)        # metaindex offset
        _, pos = _read_varint(footer, pos)        # metaindex size
        idx_offset, pos = _read_varint(footer, pos)
        idx_size, pos = _read_varint(footer, pos)

        entries: Dict[str, BundleEntry] = {}
        for _, handle in _read_block(f, idx_offset, idx_size):
            hpos = 0
            off, hpos = _read_varint(handle, hpos)
            size, hpos = _read_varint(handle, hpos)
            for key, value in _read_block(f, off, size):
                if key == b"":
                    continue  # BundleHeaderProto
                entries[key.decode("utf-8")] = BundleEntry.parse(value)
        return entries


def read_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """``model.ckpt-N`` prefix -> {variable_name: ndarray}."""
    entries = read_index(prefix + ".index")
    shards: Dict[int, object] = {}
    num_shards = 1 + max((e.shard_id for e in entries.values()), default=0)
    tensors: Dict[str, np.ndarray] = {}
    try:
        for name, e in sorted(entries.items()):
            if e.shard_id not in shards:
                shard_path = (f"{prefix}.data-{e.shard_id:05d}"
                              f"-of-{num_shards:05d}")
                shards[e.shard_id] = open(shard_path, "rb")
            f = shards[e.shard_id]
            f.seek(e.offset)
            raw = f.read(e.size)
            dtype = _DTYPES.get(e.dtype_code)
            if dtype is None:
                raise ValueError(f"{name}: unsupported dtype code "
                                 f"{e.dtype_code}")
            tensors[name] = np.frombuffer(raw, dtype=dtype).reshape(e.shape)
    finally:
        for f in shards.values():
            f.close()
    return tensors


# -------------------------------------------------------------- table write

def _block_bytes(entries: List[Tuple[bytes, bytes]],
                 restart_interval: int = 16) -> bytes:
    out = bytearray()
    restarts = []
    prev_key = b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < len(prev_key) and shared < len(key)
                   and prev_key[shared] == key[shared]):
                shared += 1
        unshared = key[shared:]
        out += _write_varint(shared)
        out += _write_varint(len(unshared))
        out += _write_varint(len(value))
        out += unshared
        out += value
        prev_key = key
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


class _TableWriter:
    """Single-data-block SSTable writer (ample for checkpoint indexes)."""

    def __init__(self, f):
        self.f = f

    def _emit_block(self, block: bytes) -> Tuple[int, int]:
        offset = self.f.tell()
        self.f.write(block)
        self.f.write(bytes([0]))  # no compression
        self.f.write(struct.pack("<I", masked_crc32c(block + bytes([0]))))
        return offset, len(block)

    def write(self, entries: List[Tuple[bytes, bytes]]) -> None:
        data_handle = self._emit_block(_block_bytes(entries))
        last_key = entries[-1][0] if entries else b""
        handle_bytes = (_write_varint(data_handle[0])
                        + _write_varint(data_handle[1]))
        meta_handle = self._emit_block(_block_bytes([]))
        index_handle = self._emit_block(
            _block_bytes([(last_key + b"\x00", handle_bytes)]))
        footer = (_write_varint(meta_handle[0]) + _write_varint(meta_handle[1])
                  + _write_varint(index_handle[0])
                  + _write_varint(index_handle[1]))
        footer += bytes(40 - len(footer))
        footer += struct.pack("<Q", TABLE_MAGIC)
        self.f.write(footer)


def write_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as a TF1-compatible single-shard bundle."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data_path = f"{prefix}.data-00000-of-00001"
    entries: List[Tuple[bytes, bytes]] = []
    offset = 0
    with open(data_path, "wb") as f:
        header = _proto_field(1, 0, 1)  # num_shards = 1
        items = [(b"", header)]
        for name in sorted(tensors):
            # NOT ascontiguousarray: that guarantees ndim >= 1, silently
            # recording scalars (e.g. global_step) as shape (1,) — caught
            # by the tf.train.load_checkpoint oracle (test_tf_oracle.py).
            arr = np.asarray(tensors[name], order="C")
            code = _DTYPE_CODES.get(arr.dtype)
            if code is None:
                raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
            raw = arr.tobytes()
            f.write(raw)
            entry = BundleEntry(dtype_code=code, shape=arr.shape,
                                shard_id=0, offset=offset, size=len(raw),
                                crc=masked_crc32c(raw))
            items.append((name.encode("utf-8"), entry.encode()))
            offset += len(raw)
    with open(f"{prefix}.index", "wb") as f:
        _TableWriter(f).write(items)
