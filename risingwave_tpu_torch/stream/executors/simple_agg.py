"""SimpleAggExecutor and StatelessSimpleAggExecutor: single-group aggs.

Port of ``risingwave_tpu/stream/executors/simple_agg.py`` (reference
parity: src/stream/src/executor/simple_agg.rs:39, the global single-row
agg: its first flush emits an Insert, later flushes an update pair when
the row changed; and stateless_simple_agg.rs:21, per-chunk partial
aggregation whose partials a downstream SimpleAgg with SUM calls merges).

One group needs no hash table: each chunk reduces in one vectorized pass
and the scalar state lives on the host. Integer sums are exact Python
ints (no int64 or float64 accumulator, which would wrap or round past
2^63 or 2^53). MIN/MAX require append-only input, as on the hash agg.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.ops.hash_agg import AggKind
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.hash_agg import AggCall
from risingwave_tpu_torch.stream.message import (
    Message, is_barrier, is_chunk, is_watermark,
)

_SUM_OUT = {
    DataType.INT16: DataType.INT64, DataType.INT32: DataType.INT64,
    DataType.INT64: DataType.INT64,
    DataType.FLOAT32: DataType.FLOAT64, DataType.FLOAT64: DataType.FLOAT64,
}


def simple_agg_out_field(call: AggCall, input_schema: Schema,
                         name: str) -> Field:
    if call.kind == AggKind.COUNT:
        return Field(name, DataType.INT64)
    in_dt = input_schema[call.input_idx].data_type
    if call.kind == AggKind.SUM:
        return Field(name, _SUM_OUT[in_dt])
    return Field(name, in_dt)    # MIN/MAX


class _ScalarAcc:
    """One agg call's host accumulator (exact, sign-aware)."""

    def __init__(self, call: AggCall):
        self.call = call
        self.kind = call.kind
        self.count = 0          # non-null contributions (sign-weighted)
        self.value = None       # sum / min / max

    def apply(self, chunk: StreamChunk) -> None:
        vis = np.asarray(chunk.visibility)
        if not vis.any():
            return
        ops = np.asarray(chunk.ops)
        sign = np.where(
            (ops == int(Op.INSERT)) | (ops == int(Op.UPDATE_INSERT)),
            1, -1)
        if self.kind == AggKind.COUNT and self.call.input_idx is None:
            self.count += int(sign[vis].sum())
            return
        c = chunk.columns[self.call.input_idx]
        ok = vis if c.validity is None else vis & np.asarray(c.validity)
        if not ok.any():
            return
        vals = np.asarray(c.values)[ok]
        s = sign[ok]
        if self.kind == AggKind.COUNT:
            self.count += int(s.sum())
        elif self.kind == AggKind.SUM:
            self.count += int(s.sum())
            if np.issubdtype(vals.dtype, np.floating):
                d = float((vals * s).sum())
            else:
                # exact: Python ints never wrap
                d = sum(int(v) * int(g) for v, g in zip(vals, s))
            self.value = d if self.value is None else self.value + d
        else:                     # MIN / MAX: append-only input
            if (s < 0).any():
                raise ValueError(
                    f"{self.kind.value} with retractions requires the "
                    "materialized-input path: append-only input only")
            self.count += int(len(vals))
            m = (vals.max() if self.kind == AggKind.MAX
                 else vals.min()).item()
            if self.value is None:
                self.value = m
            elif self.kind == AggKind.MAX:
                self.value = max(self.value, m)
            else:
                self.value = min(self.value, m)

    def output(self):
        if self.kind == AggKind.COUNT:
            return self.count
        return self.value if self.count > 0 else None

    def partial_output(self):
        """The raw signed delta (the two-phase local half): a sum of -5
        over a retraction-only chunk reaches the merger as -5, not NULL."""
        if self.kind == AggKind.COUNT:
            return self.count
        return self.value

    # -- persistence: (value, count) per call ----------------------------
    def to_state(self) -> Tuple:
        return (self.output(), self.count)

    def restore(self, value, count: int) -> None:
        self.count = int(count)
        if self.kind != AggKind.COUNT:
            self.value = value


def simple_agg_state_schema(input_schema: Schema,
                            calls: Sequence[AggCall]
                            ) -> Tuple[Schema, List[int]]:
    """State-table schema: [pk] + (value, count) per call."""
    fields = [Field("pk", DataType.INT16)]
    for i, call in enumerate(calls):
        fields.append(simple_agg_out_field(call, input_schema, f"acc{i}"))
        fields.append(Field(f"cnt{i}", DataType.INT64))
    return Schema(fields), [0]


def _rows_chunk(schema: Schema, rows: Sequence[Tuple[Op, tuple]]
                ) -> StreamChunk:
    """A dense chunk of (op, row) pairs; NULL cells as validity."""
    cols: List[Column] = []
    for j, f in enumerate(schema):
        vals_l = [r[1][j] for r in rows]
        ok = np.asarray([v is not None for v in vals_l])
        if f.data_type.is_device:
            vals = np.asarray([0 if v is None else v for v in vals_l],
                              dtype=f.data_type.np_dtype)
        else:
            vals = np.asarray(vals_l, dtype=object)
        cols.append(Column(f.data_type, vals, None if ok.all() else ok))
    ops = np.asarray([int(r[0]) for r in rows], dtype=np.int8)
    return StreamChunk(schema, cols, np.ones(len(rows), dtype=bool), ops)


class SimpleAggExecutor(Executor):
    """Global single-row aggregation (simple_agg.rs:39 analog)."""

    def __init__(self, input_: Executor, calls: Sequence[AggCall],
                 state: StateTable,
                 output_names: Optional[Sequence[str]] = None,
                 append_only: bool = False):
        self.input = input_
        self.calls = list(calls)
        self.state = state
        self.append_only = append_only
        if not append_only and any(
                c.kind in (AggKind.MIN, AggKind.MAX) for c in self.calls):
            raise NotImplementedError(
                "MIN/MAX over retractable input needs the "
                "materialized-input path: pass append_only=True "
                "or use sum/count")
        names = list(output_names) if output_names else [
            f"agg{i}" for i in range(len(self.calls))]
        fields = [simple_agg_out_field(c, input_.schema, nm)
                  for c, nm in zip(self.calls, names)]
        super().__init__(ExecutorInfo(Schema(fields), [],
                                      "SimpleAggExecutor"))
        self.accs = [_ScalarAcc(c) for c in self.calls]
        self._last_row: Optional[Tuple] = None

    def _current_row(self) -> Tuple:
        return tuple(a.output() for a in self.accs)

    def _persist(self) -> None:
        row = (0,)
        for a in self.accs:
            row += a.to_state()
        old = self.state.get_row((0,))
        if old is None:
            self.state.insert(row)
        elif tuple(old) != row:
            self.state.update(tuple(old), row)

    def _emit(self) -> Optional[StreamChunk]:
        row = self._current_row()
        if self._last_row is None:
            chunk = _rows_chunk(self.schema, [(Op.INSERT, row)])
        elif row != self._last_row:
            chunk = _rows_chunk(self.schema,
                                [(Op.UPDATE_DELETE, self._last_row),
                                 (Op.UPDATE_INSERT, row)])
        else:
            return None
        self._last_row = row
        return chunk

    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first)
        self.state.init_epoch(first.epoch)
        row = self.state.get_row((0,))
        if row is not None:
            for i, a in enumerate(self.accs):
                a.restore(row[1 + 2 * i], row[2 + 2 * i])
            self._last_row = self._current_row()
        yield first
        async for msg in it:
            if is_chunk(msg):
                for a in self.accs:
                    a.apply(msg)
            elif is_barrier(msg):
                out = self._emit()
                if out is not None:
                    yield out
                self._persist()
                self.state.commit(msg.epoch)
                yield msg
            elif is_watermark(msg):
                pass    # one group: input watermarks do not propagate


class StatelessSimpleAggExecutor(Executor):
    """Per-chunk partial aggregation (stateless_simple_agg.rs:21 analog):
    one Insert row per non-empty chunk with that chunk's partials."""

    def __init__(self, input_: Executor, calls: Sequence[AggCall],
                 output_names: Optional[Sequence[str]] = None):
        self.input = input_
        self.calls = list(calls)
        names = list(output_names) if output_names else [
            f"agg{i}" for i in range(len(self.calls))]
        fields = [simple_agg_out_field(c, input_.schema, nm)
                  for c, nm in zip(self.calls, names)]
        super().__init__(ExecutorInfo(Schema(fields), [],
                                      "StatelessSimpleAggExecutor"))

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if is_chunk(msg):
                if not np.asarray(msg.visibility).any():
                    continue
                accs = [_ScalarAcc(c) for c in self.calls]
                for a in accs:
                    a.apply(msg)
                row = tuple(a.partial_output() for a in accs)
                yield _rows_chunk(self.schema, [(Op.INSERT, row)])
            elif is_watermark(msg):
                pass
            else:
                yield msg
