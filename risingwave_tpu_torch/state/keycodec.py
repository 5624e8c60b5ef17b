"""Memcomparable primary-key encoding.

Port of ``risingwave_tpu/state/keycodec.py`` (unchanged encoding).

Reference parity: src/common/src/util/ordered/ and the memcomparable crate —
encoded bytes compare (as unsigned byte strings) in the same order as the
SQL values they encode. Re-designed minimal: we encode host python values
(the state store is host-side; device state flushes through it at barriers).

Values are PHYSICAL: DECIMAL is its scaled-int64 payload, timestamps are µs
ints — the same representation device kernels and state-table rows use, so
the vectorized bulk encoder (state_table._encode_pks_bulk) and this scalar
codec produce identical bytes. Logical→physical normalization happens once,
at chunk ingest (chunk._make_column / types.decimal_to_scaled).

Layout per value:
  0x00                      NULL (nulls sort first, matching our iter tests)
  0x01 <payload>            non-null value

Payloads:
  bool        1 byte 0/1
  int         8 bytes big-endian with sign bit flipped (order-preserving)
  float       IEEE-754 bits; >=0: flip sign bit, <0: invert all bits
  str/bytes   utf-8/raw with 0x00 escaped as 0x00 0xFF, terminated 0x00 0x00
  Decimal     scaled int64 (exact fixed point), same as int
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

from risingwave_tpu_torch.common.types import DataType

_NULL = b"\x00"
_NONNULL = b"\x01"
_STR_TERM = b"\x00\x00"


def _encode_int(v: int) -> bytes:
    return struct.pack(">Q", (v + (1 << 63)) & ((1 << 64) - 1))


def _decode_int(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - (1 << 63)


def _encode_float(v: float) -> bytes:
    if v == 0.0:
        v = 0.0  # normalize -0.0: one SQL value, one key (matches hash.py)
    bits = struct.unpack(">Q", struct.pack(">d", v))[0]
    if bits & (1 << 63):
        bits = ~bits & ((1 << 64) - 1)   # negative: invert all
    else:
        bits |= 1 << 63                  # positive: flip sign bit
    return struct.pack(">Q", bits)


def _decode_float(b: bytes) -> float:
    bits = struct.unpack(">Q", b)[0]
    if bits & (1 << 63):
        bits &= ~(1 << 63) & ((1 << 64) - 1)
    else:
        bits = ~bits & ((1 << 64) - 1)
    return struct.unpack(">d", struct.pack(">Q", bits))[0]


def _encode_bytes(v: bytes) -> bytes:
    return v.replace(b"\x00", b"\x00\xff") + _STR_TERM


def _scan_bytes(buf: bytes, pos: int) -> Tuple[bytes, int]:
    out = bytearray()
    while True:
        i = buf.index(b"\x00", pos)
        out += buf[pos:i]
        nxt = buf[i + 1]
        if nxt == 0xFF:
            out += b"\x00"
            pos = i + 2
        elif nxt == 0x00:
            return bytes(out), i + 2
        else:
            raise ValueError("malformed escaped byte string")


def encode_value(v, dt: DataType) -> bytes:
    if v is None:
        return _NULL
    if dt == DataType.BOOLEAN:
        return _NONNULL + (b"\x01" if v else b"\x00")
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return _NONNULL + _encode_float(float(v))
    if dt == DataType.DECIMAL:
        # physical scaled-int64 payload (already scaled at chunk ingest)
        return _NONNULL + _encode_int(int(v))
    if dt == DataType.VARCHAR:
        return _NONNULL + _encode_bytes(str(v).encode("utf-8"))
    if dt == DataType.BYTEA:
        return _NONNULL + _encode_bytes(bytes(v))
    # all remaining device types are integral (ints, dates, timestamps)
    return _NONNULL + _encode_int(int(v))


def decode_value(buf: bytes, pos: int, dt: DataType):
    tag = buf[pos]
    pos += 1
    if tag == 0x00:
        return None, pos
    if dt == DataType.BOOLEAN:
        return buf[pos] == 1, pos + 1
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return _decode_float(buf[pos:pos + 8]), pos + 8
    if dt == DataType.DECIMAL:
        return _decode_int(buf[pos:pos + 8]), pos + 8
    if dt == DataType.VARCHAR:
        raw, pos = _scan_bytes(buf, pos)
        return raw.decode("utf-8"), pos
    if dt == DataType.BYTEA:
        return _scan_bytes(buf, pos)
    return _decode_int(buf[pos:pos + 8]), pos + 8


def encode_memcomparable(values: Sequence, types: Sequence[DataType]) -> bytes:
    """Encode a pk tuple → order-preserving bytes."""
    return b"".join(encode_value(v, t) for v, t in zip(values, types))


def decode_memcomparable(buf: bytes, types: Sequence[DataType]) -> tuple:
    out: List = []
    pos = 0
    for t in types:
        v, pos = decode_value(buf, pos, t)
        out.append(v)
    return tuple(out)


def encode_vnode_prefix(vnode: int) -> bytes:
    """2-byte big-endian vnode prefix (state_table.rs pk layout)."""
    return struct.pack(">H", vnode)
