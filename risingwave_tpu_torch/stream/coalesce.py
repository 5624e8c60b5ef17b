"""Chunk compaction and barrier-bounded coalescing for the streaming spine.

Port of ``risingwave_tpu/stream/coalesce.py``. Per-chunk costs downstream
(a keyed executor's pack and upload, exchange credit) are paid per chunk,
not per row, so small or sparse chunks are merged into dense,
right-sized ones:

- ``compact(chunk)``: drop invisible rows (one vectorized gather),
  keeping UpdateDelete/UpdateInsert pairs atomic: a pair whose halves
  are split by visibility degrades to plain Delete/Insert. Output
  capacity is the next power-of-two bucket.
- ``ChunkCoalescer``: an accumulator that merges consecutive small chunks
  up to a target cardinality. It never holds a chunk across a barrier:
  its owner flushes it before forwarding one. Watermarks re-sequence to
  the next flush point instead of forcing one (a watermark is a monotone
  lower bound: the buffered rows preceded it and later rows satisfy it),
  and never cross a barrier.
- ``CoalesceExecutor``: the executor-chain form, in front of a keyed
  executor.

The coalescer only merges whole compacted chunks (no splits), so update
pairs that survived compaction stay adjacent.
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import (
    Column, Op, StreamChunk, next_pow2,
)
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, Watermark, is_chunk
from risingwave_tpu_torch.utils.metrics import STREAMING as _METRICS

# default target cardinality of a coalesced chunk (0 disables coalescing)
DEFAULT_TARGET_ROWS = 4096
# linger bound: a buffer holding this many chunks flushes even below the
# row target (bounds host memory and per-flush merge work; the barrier
# bounds latency)
DEFAULT_MAX_CHUNKS = 64


def compact(chunk: StreamChunk) -> Optional[StreamChunk]:
    """Dense copy of a chunk's visible rows; None when none are.

    Visible rows gather into a fresh next-pow-2-capacity chunk whose
    visibility is a full prefix. UpdateDelete/UpdateInsert pairs whose
    halves straddle the visibility mask degrade to Delete/Insert; pairs
    that survive whole stay adjacent because the gather keeps row order.
    An already-dense chunk (visible rows a full prefix of a right-sized
    bucket) returns the original object with ``dense_rows`` stamped.
    """
    vis = np.asarray(chunk.visibility)
    idx = np.flatnonzero(vis)
    t = int(len(idx))
    if t == 0:
        return None
    ops = np.asarray(chunk.ops)
    # fast path: a fully visible chunk cannot straddle a pair; a masked
    # tail can only straddle at the boundary (U- at t-1, its U+ masked)
    if t == chunk.capacity or (
            int(idx[-1]) == t - 1
            and next_pow2(t) == chunk.capacity
            and not (ops[t - 1] == int(Op.UPDATE_DELETE)
                     and ops[t] == int(Op.UPDATE_INSERT))):
        chunk.dense_rows = t
        return chunk
    is_ud = ops == int(Op.UPDATE_DELETE)
    is_ui = ops == int(Op.UPDATE_INSERT)
    next_vis = np.roll(vis, -1)
    next_vis[-1] = False
    prev_vis = np.roll(vis, 1)
    prev_vis[0] = False
    next_is_ui = np.roll(is_ui, -1)
    next_is_ui[-1] = False
    prev_is_ud = np.roll(is_ud, 1)
    prev_is_ud[0] = False
    # U- whose U+ half is invisible -> DELETE; U+ whose U- is -> INSERT
    degrade_del = vis & is_ud & next_is_ui & ~next_vis
    degrade_ins = vis & is_ui & prev_is_ud & ~prev_vis
    if degrade_del.any() or degrade_ins.any():
        ops = ops.copy()
        ops[degrade_del] = int(Op.DELETE)
        ops[degrade_ins] = int(Op.INSERT)
    cap = next_pow2(t)
    cols: List[Column] = []
    for c in chunk.columns:
        vals = np.asarray(c.values)
        if c.is_device:
            out = np.zeros(cap, dtype=vals.dtype)
        else:
            out = np.empty(cap, dtype=object)
        out[:t] = vals[idx]
        validity = None
        if c.validity is not None:
            v = np.ones(cap, dtype=bool)
            v[:t] = np.asarray(c.validity)[idx]
            validity = v
        cols.append(Column(c.data_type, out, validity))
    new_vis = np.zeros(cap, dtype=bool)
    new_vis[:t] = True
    new_ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
    new_ops[:t] = ops[idx]
    out_chunk = StreamChunk(chunk.schema, cols, new_vis, new_ops)
    out_chunk.dense_rows = t
    if chunk.capacity > cap:
        _METRICS.compaction_rows_saved.inc(chunk.capacity - cap)
    return out_chunk


def merge_chunks(chunks: Sequence[StreamChunk]) -> StreamChunk:
    """Concatenate compacted chunks (dense prefixes) into one dense chunk.
    Whole-chunk concatenation only: update pairs never split."""
    assert chunks, "merge_chunks needs at least one chunk"
    if len(chunks) == 1:
        return chunks[0]
    schema = chunks[0].schema
    sizes = [c.dense_rows if c.dense_rows is not None
             else c.cardinality() for c in chunks]
    total = int(sum(sizes))
    cap = next_pow2(max(total, 1))
    cols: List[Column] = []
    for j in range(len(schema)):
        dt = schema[j].data_type
        if dt.is_device:
            first = np.asarray(chunks[0].columns[j].values)
            out = np.zeros(cap, dtype=first.dtype)
        else:
            out = np.empty(cap, dtype=object)
        has_validity = any(c.columns[j].validity is not None
                           for c in chunks)
        validity = np.ones(cap, dtype=bool) if has_validity else None
        at = 0
        for c, n in zip(chunks, sizes):
            col = c.columns[j]
            out[at:at + n] = np.asarray(col.values)[:n]
            if has_validity and col.validity is not None:
                validity[at:at + n] = np.asarray(col.validity)[:n]
            at += n
        cols.append(Column(dt, out, validity))
    vis = np.zeros(cap, dtype=bool)
    vis[:total] = True
    ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
    at = 0
    for c, n in zip(chunks, sizes):
        ops[at:at + n] = np.asarray(c.ops)[:n]
        at += n
    out_chunk = StreamChunk(schema, cols, vis, ops)
    out_chunk.dense_rows = total
    return out_chunk


class ChunkCoalescer:
    """Barrier-bounded accumulator of small chunks.

    ``push(chunk)`` returns the chunks ready to emit now (possibly none);
    ``flush()`` drains whatever is buffered. The owner calls ``flush()``
    before forwarding any barrier: that call is what bounds the linger.
    """

    def __init__(self, target_rows: int = DEFAULT_TARGET_ROWS,
                 max_chunks: int = DEFAULT_MAX_CHUNKS):
        self.target_rows = max(1, int(target_rows))
        self.max_chunks = max(1, int(max_chunks))
        self._buf: List[StreamChunk] = []
        self._rows = 0
        # col_idx -> latest held watermark (monotone per column, so the
        # newest subsumes older ones)
        self._held_wms: dict = {}

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def buffered_rows(self) -> int:
        return self._rows

    def push(self, chunk: StreamChunk) -> List[StreamChunk]:
        _METRICS.coalesce_chunks_in.inc()
        c = compact(chunk)
        if c is None:
            return []                       # empty chunks vanish here
        t = c.dense_rows
        out: List[StreamChunk] = []
        if t >= self.target_rows:
            # a big chunk passes through; buffered older rows go first
            f = self.flush()
            if f is not None:
                out.append(f)
            _METRICS.coalesce_chunks_out.inc()
            out.append(c)
            return out
        self._buf.append(c)
        self._rows += t
        if self._rows >= self.target_rows or \
                len(self._buf) >= self.max_chunks:
            out.append(self.flush())
        return out

    def push_watermark(self, wm: Watermark) -> List[Message]:
        """With an empty buffer a watermark passes straight through;
        otherwise it is held (latest per column wins) and released by
        ``drain_watermarks()`` right after the buffered rows."""
        if not self._buf:
            return [wm]
        self._held_wms[wm.col_idx] = wm
        return []

    def drain_watermarks(self) -> List[Message]:
        """Held watermarks, to emit right after a flushed batch (and
        always before a barrier)."""
        if not self._held_wms:
            return []
        out = list(self._held_wms.values())
        self._held_wms.clear()
        return out

    def flush(self) -> Optional[StreamChunk]:
        if not self._buf:
            return None
        merged = merge_chunks(self._buf)
        self._buf = []
        self._rows = 0
        _METRICS.coalesce_chunks_out.inc()
        return merged


class CoalesceExecutor(Executor):
    """Coalescing in front of a keyed executor: each of its device steps
    then carries a dense, right-sized batch. Control messages flush the
    buffer first and are never delayed."""

    def __init__(self, input_: Executor,
                 target_rows: int = DEFAULT_TARGET_ROWS,
                 max_chunks: int = DEFAULT_MAX_CHUNKS):
        self.input = input_
        self.target_rows = int(target_rows)
        self.max_chunks = int(max_chunks)
        super().__init__(ExecutorInfo(
            input_.schema, list(input_.pk_indices), "CoalesceExecutor"))

    async def execute(self) -> AsyncIterator[Message]:
        co = ChunkCoalescer(self.target_rows, self.max_chunks)
        async for msg in self.input.execute():
            if is_chunk(msg):
                outs = co.push(msg)
                for out in outs:
                    yield out
                if outs:
                    # a flush happened: release the watermarks held
                    # behind the buffered rows
                    for wm in co.drain_watermarks():
                        yield wm
            elif isinstance(msg, Watermark):
                for out in co.push_watermark(msg):
                    yield out
            else:
                # whatever lingers goes out before the barrier (same
                # epoch, same order)
                f = co.flush()
                if f is not None:
                    yield f
                for wm in co.drain_watermarks():
                    yield wm
                yield msg
        # upstream ended without a trailing barrier (a bounded source or
        # a test pipeline): the buffered rows are data, so flush them
        f = co.flush()
        if f is not None:
            yield f
        for wm in co.drain_watermarks():
            yield wm
