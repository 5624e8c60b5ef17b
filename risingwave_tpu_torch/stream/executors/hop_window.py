"""HopWindowExecutor: expand rows into their sliding (hop) windows.

Port of ``risingwave_tpu/stream/executors/hop_window.py`` (:27; reference
parity: src/stream/src/executor/hop_window.rs:91). With
``units = window_size / window_slide`` (which must divide exactly), each
input row belongs to ``units`` windows; copy i carries the i-th covering
window, whose start is

    floor(ts / slide) * slide - i * slide,   i in 0..units-1

and whose end is start + size. All of it is vectorized over the chunk.

Output chunks are copy-major and come in power-of-two groups of copies:
``units`` = 5 gives one chunk of 4 copies and one of 1, each of a
power-of-two capacity, so a U-/U+ pair stays adjacent inside every copy
and no chunk ends with a dangling U-. Rows whose timestamp is NULL are
dropped. A watermark on the time column re-derives to the window_start
column (the last window a bound on ts can still open); other watermarks
are consumed.

The same expansion runs on the card when the fusion rule absorbs a hop
into an agg's prelude (``ops/fused.py`` ``_expand_hop``, ``agg_prelude``).
"""

from __future__ import annotations

from typing import AsyncIterator, List

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, Watermark, is_chunk


class HopWindowExecutor(Executor):
    """Sliding-window expansion (hop_window.rs:91 analog)."""

    def __init__(self, input_: Executor, time_col: int,
                 window_slide: Interval, window_size: Interval,
                 pk_indices: List[int] = ()):
        slide, size = window_slide.usecs, window_size.usecs
        if slide <= 0 or size % slide != 0:
            raise ValueError(
                f"window_size {size}us not divisible by slide {slide}us")
        self.units = size // slide
        self.slide = slide
        self.size = size
        self.time_col = time_col
        fields = [Field(f.name, f.data_type) for f in input_.schema]
        fields.append(Field("window_start", DataType.TIMESTAMP))
        fields.append(Field("window_end", DataType.TIMESTAMP))
        super().__init__(ExecutorInfo(Schema(fields), list(pk_indices),
                                      "HopWindowExecutor"))
        self.input = input_

    def _expand(self, msg: StreamChunk):
        """The chunk's copies, in power-of-two groups of copies."""
        c = msg.columns[self.time_col]
        vis = msg.visibility
        if c.validity is not None:
            vis = vis & c.validity
        base = (c.values.astype(np.int64) // self.slide) * self.slide
        i = 0
        while i < self.units:
            g = 1 << ((self.units - i).bit_length() - 1)
            starts = np.concatenate([base - (i + j) * self.slide
                                     for j in range(g)])
            cols = [Column(col.data_type, np.tile(col.values, g),
                           None if col.validity is None
                           else np.tile(col.validity, g))
                    for col in msg.columns]
            cols.append(Column(DataType.TIMESTAMP, starts, None))
            cols.append(Column(DataType.TIMESTAMP, starts + self.size, None))
            yield StreamChunk(self.schema, cols, np.tile(vis, g),
                              np.tile(msg.ops, g))
            i += g

    async def execute(self) -> AsyncIterator[Message]:
        ws_idx = len(self.input.schema)
        async for msg in self.input.execute():
            if isinstance(msg, Watermark):
                if msg.col_idx == self.time_col:
                    # a bound on ts is a bound on the last window's start
                    base = (int(msg.value) // self.slide) * self.slide
                    yield Watermark(ws_idx, DataType.TIMESTAMP,
                                    base - (self.units - 1) * self.slide)
                continue
            if not is_chunk(msg):
                yield msg
                continue
            for out in self._expand(msg):
                yield out
