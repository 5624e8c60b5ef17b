"""DynamicFilterExecutor: filter a stream against a changing scalar.

Port of ``risingwave_tpu/stream/executors/dynamic_filter.py`` (reference
parity: src/stream/src/executor/dynamic_filter.rs:48). The left input is
the data stream, the right input carries the single-row dynamic bound
(e.g. ``WHERE v > (SELECT max(...) ...)``). Left rows are emitted when
they satisfy ``left_col ⊙ bound`` under the current bound; every left row
is kept in managed state, and when the bound moves at a barrier the
executor emits the transition: Inserts for stored rows that newly
satisfy, Deletes for rows that no longer do (one slice of a sorted list).

NULL semantics: a left row with a NULL filter column never matches; a
NULL or absent bound matches nothing (and retracts everything out).
"""

from __future__ import annotations

import bisect
from typing import AsyncIterator, Callable, List, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
from risingwave_tpu_torch.state.state_table import StateTable, to_logical_row
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.merge import barrier_align_2
from risingwave_tpu_torch.stream.message import Message, is_barrier

_OPS: dict = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class DynamicFilterExecutor(Executor):
    """``left_col ⊙ (single dynamic rhs value)`` (dynamic_filter.rs:48)."""

    def __init__(self, left: Executor, right: Executor,
                 left_col: int, comparator: str,
                 left_state: StateTable):
        assert comparator in _OPS, comparator
        super().__init__(ExecutorInfo(
            left.schema, list(left.pk_indices), "DynamicFilterExecutor"))
        self.left_in, self.right_in = left, right
        self.left_col = left_col
        self.cmp_name = comparator
        self.cmp: Callable = _OPS[comparator]
        self.state = left_state
        self.bound = None           # applied bound (last barrier)
        self._pending_bound = None  # latest rhs value seen this epoch
        self._rows: List[tuple] = []   # sorted (value, row)

    def _recover(self) -> None:
        for _pk, raw in self.state.iter_rows():
            row = to_logical_row(raw, self.schema)
            v = row[self.left_col]
            if v is not None:
                bisect.insort(self._rows, (v, row))

    def _emit_chunk(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        """Rows of this chunk that satisfy the current bound."""
        if self.bound is None:
            return None
        c = chunk.columns[self.left_col]
        vals = np.asarray(c.values)
        vis = np.asarray(chunk.visibility)
        ok = vis if c.validity is None else vis & np.asarray(c.validity)
        sat = np.zeros(chunk.capacity, dtype=bool)
        idx = np.flatnonzero(ok)
        if len(idx):
            sat[idx] = [bool(self.cmp(v, self.bound))
                        for v in vals[idx].tolist()]
        new_vis = vis & sat
        if not new_vis.any():
            return None
        return StreamChunk(chunk.schema, chunk.columns, new_vis, chunk.ops)

    def _pass_bounds(self, bound) -> tuple:
        """(start, end) slice of the sorted rows that pass under `bound`."""
        n = len(self._rows)
        gt = self.cmp_name in (">", ">=")
        strict = self.cmp_name in (">", "<")
        if bound is None:
            return (n, n) if gt else (0, 0)

        def key(e):
            return e[0]
        if gt:    # v > bound (strict) / v >= bound
            s = (bisect.bisect_right(self._rows, bound, key=key) if strict
                 else bisect.bisect_left(self._rows, bound, key=key))
            return (s, n)
        # v < bound (strict) / v <= bound
        e = (bisect.bisect_left(self._rows, bound, key=key) if strict
             else bisect.bisect_right(self._rows, bound, key=key))
        return (0, e)

    def _bound_transition(self) -> Optional[StreamChunk]:
        """The delta when the bound moves: both pass slices share an
        endpoint (gt: end n, lt: start 0), so the symmetric difference is
        one contiguous slice, O(rows that change)."""
        old, new = self.bound, self._pending_bound
        if old == new:
            return None
        so, eo = self._pass_bounds(old)
        self.bound = new
        sn, en = self._pass_bounds(new)
        if (so, eo) == (sn, en):
            return None
        deletes: list = []
        inserts: list = []
        if self.cmp_name in (">", ">="):
            if sn > so:       # bound rose: rows[so:sn] stopped passing
                deletes = [r for _v, r in self._rows[so:sn]]
            else:             # bound fell: rows[sn:so] started passing
                inserts = [r for _v, r in self._rows[sn:so]]
        else:
            if en > eo:       # bound rose: rows[eo:en] started passing
                inserts = [r for _v, r in self._rows[eo:en]]
            else:             # bound fell: rows[en:eo] stopped passing
                deletes = [r for _v, r in self._rows[en:eo]]
        if not deletes and not inserts:
            return None
        return self._rows_chunk(deletes, inserts)

    def _rows_chunk(self, deletes, inserts) -> StreamChunk:
        rows = list(deletes) + list(inserts)
        ops = np.asarray([int(Op.DELETE)] * len(deletes)
                         + [int(Op.INSERT)] * len(inserts), dtype=np.int8)
        cols: List[Column] = []
        for j, f in enumerate(self.schema):
            vals_l = [r[j] for r in rows]
            okm = np.asarray([v is not None for v in vals_l])
            if f.data_type.is_device:
                vals = np.asarray([0 if v is None else v for v in vals_l],
                                  dtype=f.data_type.np_dtype)
            else:
                vals = np.asarray(vals_l, dtype=object)
            cols.append(Column(f.data_type, vals,
                               None if okm.all() else okm))
        return StreamChunk(self.schema, cols,
                           np.ones(len(rows), dtype=bool), ops)

    async def execute(self) -> AsyncIterator[Message]:
        lit = self.left_in.execute()
        rit = self.right_in.execute()
        first_l = await lit.__anext__()
        first_r = await rit.__anext__()
        assert is_barrier(first_l) and is_barrier(first_r)
        self.state.init_epoch(first_l.epoch)
        self._recover()
        yield first_l
        async for tag, msg in barrier_align_2(lit, rit):
            if tag == "barrier":
                out = self._bound_transition()
                if out is not None:
                    yield out
                self.state.commit(msg.epoch)
                yield msg
            elif tag == "left":
                if not isinstance(msg, StreamChunk):
                    continue
                out = self._emit_chunk(msg)
                if out is not None:
                    yield out
                for op, row in msg.to_records():
                    v = row[self.left_col]
                    if op.is_insert:
                        self.state.insert(row)
                        if v is not None:
                            bisect.insort(self._rows, (v, row))
                    else:
                        self.state.delete(row)
                        if v is not None:
                            i = bisect.bisect_left(self._rows, (v, row))
                            if i < len(self._rows) \
                                    and self._rows[i][1] == row:
                                del self._rows[i]
            elif tag == "right":
                if not isinstance(msg, StreamChunk):
                    continue
                for op, row in msg.to_records():
                    if op.is_insert:
                        self._pending_bound = row[0]
                    elif self._pending_bound == row[0]:
                        self._pending_bound = None
