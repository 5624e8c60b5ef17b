"""WatermarkFilterExecutor: generate event-time watermarks, drop late rows.

Port of ``risingwave_tpu/stream/executors/watermark_filter.py``
(reference parity: src/stream/src/executor/watermark_filter.rs:48): the
watermark is max(event_time) - delay, advanced monotonically; rows below
the watermark already emitted are filtered out; the watermark persists in
a state table at barriers and is restored on recovery.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

import numpy as np

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Message, Watermark, is_barrier, is_chunk,
)

WATERMARK_STATE_SCHEMA = Schema([Field("pk", DataType.INT16),
                                 Field("watermark", DataType.TIMESTAMP)])


class WatermarkFilterExecutor(Executor):
    """Event-time watermark generator + late-row filter."""

    def __init__(self, input_: Executor, time_col: int, delay: Interval,
                 state: Optional[StateTable] = None):
        super().__init__(ExecutorInfo(
            input_.schema, list(input_.pk_indices),
            "WatermarkFilterExecutor"))
        self.input = input_
        self.time_col = time_col
        self.delay = delay.usecs
        self.state = state
        self.current: Optional[int] = None

    def _persist(self) -> None:
        if self.state is None or self.current is None:
            return
        old = self.state.get_row((0,))
        row = (0, int(self.current))
        if old is None:
            self.state.insert(row)
        elif tuple(old) != row:
            self.state.update(tuple(old), row)

    async def execute(self) -> AsyncIterator[Message]:
        first_seen = False
        async for msg in self.input.execute():
            if is_barrier(msg):
                if not first_seen:
                    first_seen = True
                    if self.state is not None:
                        self.state.init_epoch(msg.epoch)
                        row = self.state.get_row((0,))
                        if row is not None:
                            self.current = int(row[1])
                    yield msg
                    if self.current is not None:
                        yield Watermark(self.time_col, DataType.TIMESTAMP,
                                        self.current)
                    continue
                self._persist()
                if self.state is not None:
                    self.state.commit(msg.epoch)
                yield msg
            elif is_chunk(msg):
                out = self._apply(msg)
                if out is not None:
                    yield out
                    if self.current is not None:
                        yield Watermark(self.time_col, DataType.TIMESTAMP,
                                        self.current)
            elif isinstance(msg, Watermark):
                # upstream watermarks on other columns pass through
                if msg.col_idx != self.time_col:
                    yield msg

    def _apply(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        c = chunk.columns[self.time_col]
        ts = c.values.astype(np.int64)
        vis = chunk.visibility
        ok = vis if c.validity is None else vis & c.validity
        # a row is late only relative to the watermark already EMITTED
        # (before this chunk)
        prev_wm = self.current
        if ok.any():
            mx = int(ts[ok].max()) - self.delay
            if self.current is None or mx > self.current:
                self.current = mx
        if prev_wm is None:
            return chunk
        late = ok & (ts < prev_wm)
        if not late.any():
            return chunk
        new_vis = vis & ~late
        if not new_vis.any():
            return None
        return StreamChunk(chunk.schema, chunk.columns, new_vis, chunk.ops)
