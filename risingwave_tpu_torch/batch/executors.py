"""Batch executors: pull-based iterators of DataChunks.

Port of ``risingwave_tpu/batch/executors.py`` (reference parity:
src/batch/src/executor/: row_seq_scan.rs, filter, project, hash_agg.rs,
join/hash_join.rs (inner), order_by.rs, limit, values). Host numpy and
Python over the streaming side's DataChunk: the queries read bounded
committed snapshots (an MV, or an operator's state table), and no kernel
runs here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.batch.storage_table import StorageTable, rows_to_chunk
from risingwave_tpu_torch.common.chunk import DataChunk
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.expr.expr import Expression
from risingwave_tpu_torch.ops.hash_agg import AggKind
from risingwave_tpu_torch.stream.executors.hash_agg import (
    AggCall, agg_output_schema,
)

# rows a join output chunk collects before it is yielded
JOIN_OUT_ROWS = 4096


class BatchExecutor:
    """A pull-based executor (batch/executor/mod.rs:92 analog)."""

    schema: Schema

    def execute(self) -> Iterator[DataChunk]:
        raise NotImplementedError


def collect(ex: BatchExecutor) -> List[tuple]:
    """Drain an executor into its visible rows."""
    out: List[tuple] = []
    for chunk in ex.execute():
        out.extend(chunk.to_pylist())
    return out


class BatchValues(BatchExecutor):
    def __init__(self, schema: Schema, rows: List[tuple]):
        self.schema = schema
        self.rows = rows

    def execute(self) -> Iterator[DataChunk]:
        if self.rows:
            yield rows_to_chunk(self.schema, self.rows)


class RowSeqScan(BatchExecutor):
    """A full scan of a storage table at a snapshot epoch."""

    def __init__(self, table: StorageTable, epoch: int,
                 chunk_size: int = 1024):
        self.table = table
        self.schema = table.schema
        self.epoch = epoch
        self.chunk_size = chunk_size

    def execute(self) -> Iterator[DataChunk]:
        yield from self.table.scan_chunks(self.epoch, self.chunk_size)


class BatchFilter(BatchExecutor):
    def __init__(self, child: BatchExecutor, predicate: Expression):
        self.child = child
        self.schema = child.schema
        self.predicate = predicate

    def execute(self) -> Iterator[DataChunk]:
        for chunk in self.child.execute():
            col = self.predicate.eval(chunk)
            keep = np.asarray(col.values).astype(bool)
            if col.validity is not None:
                keep &= np.asarray(col.validity)   # NULL drops the row
            out = chunk.mask(keep)
            if out.cardinality():
                yield out


class BatchProject(BatchExecutor):
    def __init__(self, child: BatchExecutor, exprs: Sequence[Expression],
                 names: Optional[Sequence[str]] = None):
        self.child = child
        self.exprs = list(exprs)
        cols = [e.eval(DataChunk.empty(child.schema)) for e in self.exprs]
        self.schema = Schema([
            Field(names[i] if names else f"col{i}", c.data_type)
            for i, c in enumerate(cols)])

    def execute(self) -> Iterator[DataChunk]:
        for chunk in self.child.execute():
            cols = [e.eval(chunk) for e in self.exprs]
            yield DataChunk(self.schema, cols, chunk.visibility)


class BatchHashAgg(BatchExecutor):
    """Blocking hash aggregation (batch/executor/hash_agg.rs analog): a
    host dict of groups, bounded by the snapshot it reads. SUM is exact
    (Python ints), DISTINCT dedups per (group, call), and
    APPROX_COUNT_DISTINCT counts an exact set (a bounded scan can afford
    what the streaming sketch estimates)."""

    def __init__(self, child: BatchExecutor, group_indices: Sequence[int],
                 agg_calls: Sequence[AggCall],
                 names: Optional[Sequence[str]] = None):
        self.child = child
        self.group_indices = list(group_indices)
        self.agg_calls = list(agg_calls)
        self.schema = agg_output_schema(child.schema, group_indices,
                                        agg_calls, names)

    def execute(self) -> Iterator[DataChunk]:
        groups: Dict[tuple, List] = {}
        seen: Dict[tuple, set] = {}      # DISTINCT: per (group, call)
        for chunk in self.child.execute():
            for row in chunk.to_pylist():
                gk = tuple(row[i] for i in self.group_indices)
                accs = groups.get(gk)
                if accs is None:
                    accs = groups[gk] = [None] * len(self.agg_calls)
                for j, call in enumerate(self.agg_calls):
                    v = None if call.input_idx is None \
                        else row[call.input_idx]
                    if call.distinct and v is not None:
                        s = seen.setdefault((gk, j), set())
                        if v in s:
                            continue
                        s.add(v)
                    accs[j] = _agg_step(call.kind, accs[j], v,
                                        call.input_idx is None)
        rows = []
        for gk, accs in groups.items():
            out = []
            for call, a in zip(self.agg_calls, accs):
                if call.kind == AggKind.COUNT:
                    out.append(a or 0)
                elif call.kind == AggKind.APPROX_COUNT_DISTINCT:
                    out.append(len(a) if isinstance(a, set) else 0)
                else:
                    out.append(a)
            rows.append(gk + tuple(out))
        if rows:
            yield rows_to_chunk(self.schema, rows)


def _agg_step(kind: AggKind, acc, v, count_star: bool):
    if kind == AggKind.COUNT:
        if count_star or v is not None:
            return (acc or 0) + 1
        return acc
    if kind == AggKind.APPROX_COUNT_DISTINCT:
        if v is None:
            return acc
        s = acc if isinstance(acc, set) else set()
        s.add(v)
        return s
    if v is None:
        return acc
    if acc is None:
        return v
    if kind == AggKind.SUM:
        return acc + v
    if kind == AggKind.MIN:
        return min(acc, v)
    if kind == AggKind.MAX:
        return max(acc, v)
    raise ValueError(kind)


class BatchHashJoin(BatchExecutor):
    """Inner equi-join: build the right side, probe with the left
    (hash_join.rs analog). A NULL key never matches."""

    def __init__(self, left: BatchExecutor, right: BatchExecutor,
                 left_keys: Sequence[int], right_keys: Sequence[int]):
        self.left, self.right = left, right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.schema = Schema(list(left.schema) + list(right.schema))

    def execute(self) -> Iterator[DataChunk]:
        build: Dict[tuple, List[tuple]] = {}
        for chunk in self.right.execute():
            for row in chunk.to_pylist():
                k = tuple(row[i] for i in self.right_keys)
                if None not in k:
                    build.setdefault(k, []).append(row)
        out: List[tuple] = []
        for chunk in self.left.execute():
            for row in chunk.to_pylist():
                k = tuple(row[i] for i in self.left_keys)
                if None in k:
                    continue
                for rrow in build.get(k, ()):
                    out.append(row + rrow)
            if len(out) >= JOIN_OUT_ROWS:
                yield rows_to_chunk(self.schema, out)
                out = []
        if out:
            yield rows_to_chunk(self.schema, out)


class BatchOrderBy(BatchExecutor):
    """A blocking sort; ``order_cols`` are (column, descending) pairs.
    NULLs sort last ascending and first descending (PostgreSQL's
    defaults)."""

    def __init__(self, child: BatchExecutor,
                 order_cols: Sequence[Tuple[int, bool]]):
        self.child = child
        self.schema = child.schema
        self.order_cols = list(order_cols)

    def execute(self) -> Iterator[DataChunk]:
        rows = collect(self.child)
        # one stable sort per column, the last column first
        for idx, desc in reversed(self.order_cols):
            rows.sort(key=lambda r: (True, 0) if r[idx] is None
                      else (False, r[idx]), reverse=desc)
        if rows:
            yield rows_to_chunk(self.schema, rows)


class BatchLimit(BatchExecutor):
    def __init__(self, child: BatchExecutor, limit: int, offset: int = 0):
        self.child = child
        self.schema = child.schema
        self.limit = limit
        self.offset = offset

    def execute(self) -> Iterator[DataChunk]:
        skip = self.offset
        left = self.limit
        for chunk in self.child.execute():
            rows = chunk.to_pylist()
            if skip:
                take = rows[skip:]
                skip = max(0, skip - len(rows))
                rows = take
            if not rows:
                continue
            if left <= 0:
                return
            rows = rows[:left]
            left -= len(rows)
            if rows:
                yield rows_to_chunk(self.schema, rows)
