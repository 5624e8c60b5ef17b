"""BackfillExecutor: MV-on-MV via snapshot read + upstream merge.

Reference parity: src/stream/src/executor/backfill/no_shuffle_backfill.rs:68
and chain.rs:28. The algorithm is the reference's:

  per epoch, read a bounded slice of the upstream MV's COMMITTED
  snapshot in pk order from the current progress position, emitting the
  rows as Inserts; forward live upstream deltas only for pks at or
  before the progress position (later pks will be seen by the advancing
  snapshot, which re-reads at each barrier's fresh committed epoch);
  when the snapshot is exhausted, mark done and become a passthrough.

Progress is a persisted (vnode-ordered) encoded pk position, so an
interrupted backfill resumes where it stopped instead of double-feeding
downstream operators. Ordering across vnodes follows the 2-byte
big-endian vnode prefix of the state-table key encoding — byte order of
the full encoded key IS the backfill scan order.

Port of ``risingwave_tpu/stream/executors/backfill.py``, unchanged but
for its imports. The snapshot rows flow as ordinary host chunks;
stateful downstream operators batch them into device steps exactly
like live traffic, so backfill is host code with no kernel of its own.
The snapshot is read in pk order and the live filter compares
memcomparable pks, so what the downstream MV nets to does not depend
on the order in which the upstream's changelog arrives within an epoch
(on the card a device agg flushes in K1's slot order).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.state.keycodec import encode_memcomparable
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, is_barrier, is_chunk, is_watermark,
)

# progress row: (pk=0, done flag, encoded position)
PROGRESS_SCHEMA = Schema([Field("pk", DataType.INT16),
                          Field("done", DataType.BOOLEAN),
                          Field("pos", DataType.BYTEA)])


class BackfillExecutor(Executor):
    """Snapshot-read an upstream MV, then switch to its live stream."""

    def __init__(self, upstream: Executor, mv_table: StateTable,
                 progress: StateTable,
                 snapshot_rows_per_epoch: int = 8192,
                 identity: str = "BackfillExecutor"):
        super().__init__(ExecutorInfo(
            upstream.schema, list(mv_table.pk_indices), identity))
        self.upstream = upstream
        self.mv_table = mv_table
        self.progress = progress
        self.rows_per_epoch = snapshot_rows_per_epoch
        self.done = False
        self.pos: Optional[bytes] = None    # last emitted encoded key

    # -- progress persistence --------------------------------------------
    def _load_progress(self) -> None:
        row = self.progress.get_row((0,))
        if row is not None:
            self.done = bool(row[1])
            self.pos = bytes(row[2]) if row[2] else None

    def _save_progress(self) -> None:
        old = self.progress.get_row((0,))
        new = (0, self.done, self.pos or b"")
        if old is None:
            self.progress.insert(new)
        elif tuple(old) != new:
            self.progress.update(tuple(old), new)

    # -- snapshot reading -------------------------------------------------
    def _read_snapshot_slice(self) -> List[tuple]:
        """Up to rows_per_epoch committed rows strictly after `pos`."""
        start = self.pos + b"\x00" if self.pos is not None else None
        out: List[tuple] = []
        last_key = None
        for key, row in self.mv_table.iter_encoded_range(start):
            out.append(row)
            last_key = key
            if len(out) >= self.rows_per_epoch:
                break
        if last_key is not None:
            self.pos = last_key
        if len(out) < self.rows_per_epoch:
            self.done = True
        return out

    def _snapshot_chunk(self, rows: List[tuple]) -> StreamChunk:
        cols = {f.name: [r[i] for r in rows]
                for i, f in enumerate(self.schema)}
        return StreamChunk.from_pydict(self.schema, cols)

    def _row_key(self, row: tuple) -> bytes:
        pk = tuple(row[i] for i in self.mv_table.pk_indices)
        return self.mv_table._encode_pk(pk)

    def _filter_live(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        """Forward only rows already covered by the snapshot scan."""
        if self.done:
            return chunk
        if self.pos is None:
            return None
        vis = np.asarray(chunk.visibility)
        idx, rows, _ops = chunk.to_physical_records()
        keep = np.zeros(chunk.capacity, dtype=bool)
        for i, row in zip(idx.tolist(), rows):
            if self._row_key(row) <= self.pos:
                keep[i] = True
        new_vis = vis & keep
        if not new_vis.any():
            return None
        return StreamChunk(chunk.schema, chunk.columns, new_vis,
                           chunk.ops)

    # -- main loop --------------------------------------------------------
    async def execute(self) -> AsyncIterator[Message]:
        it = self.upstream.execute()
        # The attach happens mid-epoch from the upstream's perspective:
        # operators emit their barrier-flush chunks BEFORE forwarding
        # the barrier, so the first messages may be epoch-N data. They
        # are covered by the first snapshot (read at N's committed
        # state) — drop until the subscription's first barrier.
        first = await it.__anext__()
        while not is_barrier(first):
            first = await it.__anext__()
        self.progress.init_epoch(first.epoch)
        self.mv_table.init_epoch(first.epoch)
        self._load_progress()
        yield first
        async for msg in it:
            if is_chunk(msg):
                out = self._filter_live(msg)
                if out is not None:
                    yield out
            elif is_barrier(msg):
                if not self.done:
                    # the snapshot advances to this barrier's committed
                    # epoch: rows changed since the last slice are read
                    # in their newest committed version
                    self.mv_table.init_epoch(msg.epoch)
                    rows = self._read_snapshot_slice()
                    if rows:
                        yield self._snapshot_chunk(rows)
                    self._save_progress()
                self.progress.commit(msg.epoch)
                yield msg
            elif is_watermark(msg):
                if self.done:
                    yield msg
                # during backfill watermarks are dropped: snapshot rows
                # below them are still in flight (reference buffers the
                # pending watermark; parity increment)
