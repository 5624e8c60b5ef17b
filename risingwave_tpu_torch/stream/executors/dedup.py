"""AppendOnlyDedupExecutor: the first row per dedup key of an append-only
stream.

Port of ``risingwave_tpu/stream/executors/dedup.py`` (reference parity:
src/stream/src/executor/dedup/append_only_dedup.rs). Rows whose dedup key
was already seen drop; seen keys persist through a StateTable, so a
restart resumes without re-emitting. Dedup keys ride the port's
``KeyCodec`` lanes (varchar keys interned), and membership is a host set
of lane tuples (exact).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.executors.keys import KeyCodec
from risingwave_tpu_torch.stream.message import Message, is_barrier, is_chunk


class AppendOnlyDedupExecutor(Executor):
    """Keep the first row per dedup key of an append-only stream."""

    def __init__(self, input_: Executor, dedup_indices: Sequence[int],
                 state: StateTable,
                 identity: str = "AppendOnlyDedupExecutor"):
        super().__init__(ExecutorInfo(
            input_.schema, list(dedup_indices), identity))
        self.input = input_
        self.dedup_indices = list(dedup_indices)
        self.codec = KeyCodec(
            [input_.schema[i].data_type for i in dedup_indices])
        self.state = state
        self._seen: Set[Tuple[int, ...]] = set()

    def _apply(self, chunk: StreamChunk) -> Optional[StreamChunk]:
        lanes = self.codec.build(chunk, self.dedup_indices)
        vis = np.asarray(chunk.visibility)
        keep = np.zeros(chunk.capacity, dtype=bool)
        idx, rows, _ops = chunk.to_physical_records()
        new_rows: List[tuple] = []
        for i, row in zip(idx.tolist(), rows):
            key = tuple(lanes[i].tolist())
            if key in self._seen:
                continue
            self._seen.add(key)
            keep[i] = True
            new_rows.append(row)
        for row in new_rows:
            self.state.insert(tuple(row[i] for i in self.dedup_indices))
        out_vis = vis & keep
        if not out_vis.any():
            return None
        return StreamChunk(chunk.schema, chunk.columns, out_vis, chunk.ops)

    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first)
        self.state.init_epoch(first.epoch)
        for pk, _row in self.state.iter_rows():
            self._seen.add(
                tuple(self.codec.lanes_of_values(list(pk)).tolist()))
        yield first
        async for msg in it:
            if is_chunk(msg):
                out = self._apply(msg)
                if out is not None:
                    yield out
            elif is_barrier(msg):
                self.state.commit(msg.epoch)
                yield msg
            else:
                yield msg
