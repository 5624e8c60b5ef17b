"""Columnar data batches: ``DataChunk`` and ``StreamChunk``.

Port of ``risingwave_tpu/common/chunk.py`` (reference parity:
src/common/src/array/data_chunk.rs:65 and stream_chunk.rs:87).

Chunks are host numpy columns padded to a power-of-two capacity, with one
boolean visibility array (the reference's visibility bitmap and the
padding mask in one). Per-column null validity is an optional boolean
array. ``StreamChunk`` adds an int8 ``ops`` vector with the four Op codes;
``signs()`` maps them to +1/-1, which is what aggregation kernels consume.
Chunks never move to the device themselves: a stateful operator packs the
lanes it needs into one int32 matrix and uploads that.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common import types as types_mod
from risingwave_tpu_torch.common.types import DataType, Schema


def next_pow2(n: int, floor: int = 8) -> int:
    """Pad row counts to power-of-two buckets (stable kernel shapes)."""
    c = floor
    while c < n:
        c <<= 1
    return c


class Op(enum.IntEnum):
    """Row operation in a stream chunk (stream_chunk.rs semantics)."""

    INSERT = 1
    DELETE = 2
    UPDATE_DELETE = 3
    UPDATE_INSERT = 4

    @property
    def is_insert(self) -> bool:
        return self in (Op.INSERT, Op.UPDATE_INSERT)

    @property
    def sign(self) -> int:
        return 1 if self.is_insert else -1


def ops_to_signs(ops: np.ndarray) -> np.ndarray:
    """+1 for INSERT/UPDATE_INSERT, -1 for DELETE/UPDATE_DELETE (int32)."""
    is_ins = (ops == Op.INSERT) | (ops == Op.UPDATE_INSERT)
    return np.where(is_ins, np.int32(1), np.int32(-1))


@dataclass
class Column:
    """One column: numpy values (device dtype or object) + null mask."""

    data_type: DataType
    values: np.ndarray
    validity: Optional[np.ndarray] = None  # True = non-null

    @property
    def is_device(self) -> bool:
        return self.data_type.is_device

    def __len__(self) -> int:
        return int(self.values.shape[0])


def _make_column(dt: DataType, values, capacity: int,
                 validity=None) -> Column:
    """Build a column from python/numpy values, padded to `capacity`.

    numpy-array inputs take the zero-copy fast path; python-list inputs
    do one object-array pass for null detection (test construction only —
    the ingest hot path feeds ready numpy arrays)."""
    n = len(values)
    if n > capacity:
        raise ValueError(f"{n} values exceed column capacity {capacity}")
    if dt.is_device:
        arr = np.zeros(capacity, dtype=dt.np_dtype)
        null_mask = None
        if n:
            if isinstance(values, np.ndarray) and values.dtype != object:
                if dt == DataType.DECIMAL:
                    if np.issubdtype(values.dtype, np.integer):
                        arr[:n] = values.astype(np.int64) * \
                            types_mod.DECIMAL_SCALE
                    else:
                        arr[:n] = np.rint(values * types_mod.DECIMAL_SCALE)
                else:
                    arr[:n] = values.astype(dt.np_dtype)
            else:
                obj = np.asarray(values, dtype=object)
                null_mask = obj == None  # noqa: E711  (elementwise)
                if null_mask.any():
                    obj = obj.copy()
                    obj[null_mask] = 0
                else:
                    null_mask = None
                if dt == DataType.DECIMAL:
                    obj = np.asarray(
                        [types_mod.decimal_to_scaled(v) for v in obj],
                        dtype=object)
                arr[:n] = obj.astype(dt.np_dtype)
        out_validity = None
        if validity is not None or null_mask is not None:
            val = np.ones(capacity, dtype=bool)
            if validity is not None:
                val[:n] = np.asarray(validity, dtype=bool)
            if null_mask is not None:
                val[:n] &= ~null_mask
            out_validity = val
        return Column(dt, arr, out_validity)
    arr = np.empty(capacity, dtype=object)
    arr[:n] = np.fromiter(values, dtype=object, count=n)
    out_validity = None
    if validity is not None:
        val = np.ones(capacity, dtype=bool)
        val[:n] = np.asarray(validity, dtype=bool)
        out_validity = val
    return Column(dt, arr, out_validity)


class DataChunk:
    """A batch of columns + visibility mask (data_chunk.rs:65 analog)."""

    def __init__(self, schema: Schema, columns: Sequence[Column],
                 visibility: np.ndarray):
        assert len(schema) == len(columns), (len(schema), len(columns))
        self.schema = schema
        self.columns: Tuple[Column, ...] = tuple(columns)
        self.visibility = visibility
        cap = int(visibility.shape[0])
        for c in self.columns:
            assert int(c.values.shape[0]) == cap, "column capacity mismatch"
        self._capacity = cap

    @staticmethod
    def from_pydict(schema: Schema, data: Dict[str, list],
                    capacity: Optional[int] = None) -> "DataChunk":
        ncols = [data[f.name] for f in schema]
        n = len(ncols[0]) if ncols else 0
        cap = capacity or next_pow2(max(n, 1))
        cols = [_make_column(f.data_type, vals, cap)
                for f, vals in zip(schema, ncols)]
        vis = np.zeros(cap, dtype=bool)
        vis[:n] = True
        return DataChunk(schema, cols, vis)

    @property
    def capacity(self) -> int:
        return self._capacity

    def cardinality(self) -> int:
        """Number of visible rows."""
        return int(np.sum(self.visibility))

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def to_pylist(self, compact: bool = True) -> List[tuple]:
        rows = []
        host_cols = [(c.values, c.validity, c.data_type)
                     for c in self.columns]
        for i in range(self._capacity):
            if compact and not self.visibility[i]:
                continue
            row = []
            for vals, val, dt in host_cols:
                if val is not None and not val[i]:
                    row.append(None)
                    continue
                v = vals[i]
                if dt.is_device:
                    v = v.item() if hasattr(v, "item") else v
                    if dt == DataType.BOOLEAN:
                        v = bool(v)
                    elif dt == DataType.DECIMAL:
                        v = types_mod.scaled_to_decimal(v)
                row.append(v)
            rows.append(tuple(row))
        return rows

    def __repr__(self) -> str:
        return (f"DataChunk(cap={self._capacity}, "
                f"rows={self.cardinality()}, schema={self.schema})")


class StreamChunk(DataChunk):
    """DataChunk + per-row Op vector (stream_chunk.rs:87 analog)."""

    def __init__(self, schema: Schema, columns: Sequence[Column],
                 visibility: np.ndarray, ops: np.ndarray):
        super().__init__(schema, columns, visibility)
        assert int(ops.shape[0]) == self._capacity
        self.ops = ops  # int8 [capacity]

    @staticmethod
    def from_pydict(schema: Schema, data: Dict[str, list],
                    ops: Optional[Sequence[int]] = None,
                    capacity: Optional[int] = None) -> "StreamChunk":
        base = DataChunk.from_pydict(schema, data, capacity=capacity)
        n = len(next(iter(data.values()))) if data else 0
        o = np.full(base.capacity, int(Op.INSERT), dtype=np.int8)
        if ops is not None:
            o[:n] = np.asarray([int(x) for x in ops], dtype=np.int8)
        return StreamChunk(schema, base.columns, base.visibility, o)

    def signs(self) -> np.ndarray:
        """+1/-1 per row (masked rows included; gate with visibility)."""
        return ops_to_signs(self.ops)

    def to_physical_records(self) -> Tuple[np.ndarray, List[tuple],
                                           np.ndarray]:
        """(visible_idx, rows, ops[visible]) with PHYSICAL values (DECIMAL
        as scaled int, timestamps as µs ints, NULL as None) — the
        representation state tables store."""
        idx = np.flatnonzero(self.visibility)
        cols: List[list] = []
        for c in self.columns:
            vals = c.values[idx]
            if c.validity is not None:
                nulls = ~c.validity[idx]
                if nulls.any():
                    out = vals.astype(object)
                    out[nulls] = None
                    cols.append(out.tolist())
                    continue
            cols.append(vals.tolist())
        rows = list(zip(*cols)) if cols else []
        return idx, rows, self.ops[idx]

    def to_records(self, compact: bool = True) -> List[tuple]:
        """[(Op, row-tuple)] for visible rows."""
        rows = super().to_pylist(compact=False)
        out = []
        for i, row in enumerate(rows):
            if compact and not self.visibility[i]:
                continue
            out.append((Op(int(self.ops[i])), row))
        return out

    def __repr__(self) -> str:
        return (f"StreamChunk(cap={self._capacity}, "
                f"rows={self.cardinality()}, schema={self.schema})")
