"""Shared key-lane building: chunk columns → int32 device key lanes.

Port of ``risingwave_tpu/stream/executors/keys.py`` (unchanged lanes).

The device key contract (ops/hash_table.py): every key column becomes
three int32 lanes — (hi, lo) bijective split of a 64-bit image of the
value plus a null-indicator lane (NULL is a distinct key, matching the
reference's group/join key semantics). Used by HashAgg group keys and
HashJoin join keys; host twin of the dispatch hashing.

Varchar (and other host-typed) keys: the reference serializes them into
its HashKey bytes (src/common/src/hash/key.rs:312,647 KeySerialized) so
equality is exact. Strings never ship to the device, so a
``KeyCodec`` INTERNS each distinct value to a dense int64 id — the id
lanes route/group on device exactly like native ints, and two distinct
strings can never merge (no hash-collision class at all). The interner
is per-operator host state, rebuilt on recovery from the state rows it
decodes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.types import DataType
from risingwave_tpu_torch.ops import lanes

LANES_PER_KEY = 3


class Interner:
    """Exact value↔int64-id bijection for one host-typed key column.

    BOUNDED BY LIVE STATE, not by stream history:
    ``gc(live_values)`` retires entries no live row references — ids
    stay STABLE for survivors (device rows store id lanes), retired
    ids go on a free list and are reused only after GC proves them
    unreferenced. Executors call gc at compaction/state-cleaning
    points, where the live value set is already in hand."""

    def __init__(self) -> None:
        self.to_id: Dict[object, int] = {}
        self.values: List[object] = []       # id → value (None = hole)
        self.free_ids: List[int] = []

    def __len__(self) -> int:
        return len(self.to_id)

    def _alloc(self, v) -> int:
        if self.free_ids:
            i = self.free_ids.pop()
            self.values[i] = v
        else:
            i = len(self.values)
            self.values.append(v)
        self.to_id[v] = i
        return i

    def intern_col(self, vals: np.ndarray) -> np.ndarray:
        """object array → int64 ids (vectorized over DISTINCT values)."""
        uniq, inverse = np.unique(vals, return_inverse=True)
        ids = np.empty(len(uniq), dtype=np.int64)
        to_id = self.to_id
        for i, v in enumerate(uniq.tolist()):
            got = to_id.get(v)
            if got is None:
                got = self._alloc(v)
            ids[i] = got
        return ids[inverse]

    def intern_one(self, v) -> int:
        got = self.to_id.get(v)
        if got is None:
            got = self._alloc(v)
        return got

    def gc(self, live_values) -> int:
        """Drop entries not in `live_values`; returns entries freed."""
        live = set(live_values)
        dead = [v for v in self.to_id if v not in live]
        for v in dead:
            i = self.to_id.pop(v)
            self.values[i] = None
            self.free_ids.append(i)
        return len(dead)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """id array → values. Unknown ids (NULL keys decode to id 0,
        which may not exist yet — e.g. a recovered interner whose rows
        were all NULL-keyed, ADVICE r3) map to None instead of raising."""
        out = np.empty(len(ids), dtype=object)
        vals = self.values
        n = len(vals)
        for i, x in enumerate(ids.tolist()):
            out[i] = vals[x] if 0 <= x < n else None
        return out


class KeyCodec:
    """Key-lane builder/decoder for a fixed key-column type list.

    Device-typed columns use the bijective i64 image; host-typed
    columns (varchar/bytea) go through a per-position Interner. A
    HashJoin shares ONE codec across both sides so equal strings get
    equal ids.
    """

    def __init__(self, types: Sequence[DataType]):
        self.types = list(types)
        self.interners: Dict[int, Interner] = {
            j: Interner() for j, dt in enumerate(self.types)
            if not dt.is_device}

    def interner_entries(self) -> int:
        return sum(len(it) for it in self.interners.values())

    def _col_i64(self, j: int, vals: np.ndarray) -> np.ndarray:
        it = self.interners.get(j)
        if it is None:
            return to_i64(vals)
        return it.intern_col(vals)

    def build(self, chunk: StreamChunk,
              indices: Sequence[int]) -> np.ndarray:
        cols = []
        for i in indices:
            c = chunk.columns[i]
            cols.append((np.asarray(c.values),
                         None if c.validity is None
                         else np.asarray(c.validity)))
        return self.build_arrays(cols)

    def build_arrays(self, cols: Sequence[Tuple[np.ndarray, np.ndarray]]
                     ) -> np.ndarray:
        n = len(cols[0][0])
        out = np.empty((n, LANES_PER_KEY * len(cols)), dtype=np.int32)
        for j, (vals, ok) in enumerate(cols):
            if j in self.interners:
                # Host-typed columns carry NULL as the None OBJECT, not
                # (only) a validity mask — and pad slots of a capacity-
                # padded chunk are arbitrary. Both must stay out of the
                # interner and read as null in the valid lane. The fill
                # must match the column's value type: np.unique sorts,
                # and str/bytes do not compare.
                bad = np.fromiter(
                    (not isinstance(v, (str, bytes))
                     for v in vals.tolist()), dtype=bool, count=n)
                ok = (~bad if ok is None else ok & ~bad)
                if bad.any():
                    vals = vals.copy()
                    vals[bad] = b"" if self.types[j] == DataType.BYTEA \
                        else ""
            v64 = self._col_i64(j, vals)
            if ok is not None:
                v64 = np.where(ok, v64, 0)
            hi, lo = lanes.split_i64(v64)
            out[:, LANES_PER_KEY * j] = hi
            out[:, LANES_PER_KEY * j + 1] = lo
            out[:, LANES_PER_KEY * j + 2] = \
                1 if ok is None else ok.astype(np.int32)
        return out

    def lanes_of_values(self, values: Sequence) -> np.ndarray:
        lane = np.zeros(LANES_PER_KEY * len(self.types), dtype=np.int32)
        for j, (v, dt) in enumerate(zip(values, self.types)):
            if v is None:
                continue
            it = self.interners.get(j)
            if it is not None:
                v64 = np.asarray([it.intern_one(v)], dtype=np.int64)
            else:
                v64 = to_i64(np.asarray([v], dtype=dt.np_dtype))
            hi, lo = lanes.split_i64(v64)
            lane[LANES_PER_KEY * j] = hi[0]
            lane[LANES_PER_KEY * j + 1] = lo[0]
            lane[LANES_PER_KEY * j + 2] = 1
        return lane

    def decode(self, keys: np.ndarray
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
        cols = []
        for j, dt in enumerate(self.types):
            hi = keys[:, LANES_PER_KEY * j]
            lo = keys[:, LANES_PER_KEY * j + 1]
            ok = keys[:, LANES_PER_KEY * j + 2] != 0
            v64 = lanes.merge_i64(hi, lo)
            it = self.interners.get(j)
            if it is not None:
                vals = it.lookup(np.where(ok, v64, 0))
            elif np.issubdtype(np.dtype(dt.np_dtype), np.floating):
                vals = v64.view(np.float64).astype(dt.np_dtype)
            else:
                vals = v64.astype(dt.np_dtype)
            cols.append((vals, ok))
        return cols


def to_i64(vals: np.ndarray) -> np.ndarray:
    """Column values → int64, bijective per distinct key.

    Floats are bit-cast (1.2 and 1.7 are distinct keys) with -0.0
    normalized so it groups with 0.0."""
    if np.issubdtype(np.dtype(vals.dtype), np.floating):
        vals = np.where(vals == 0, np.zeros((), dtype=vals.dtype), vals)
        return vals.astype(np.float64).view(np.int64)
    return vals.astype(np.int64)


