"""MaterializeExecutor: sink a stream into its materialized-view table.

Port of ``risingwave_tpu/stream/executors/materialize.py`` (reference
parity: src/stream/src/executor/mview/materialize.rs:53): apply each
StreamChunk to the MV's StateTable, commit on barrier, forward messages
downstream. Only the reference's default conflict behavior (no check:
the upstream's ops are trusted) is ported.
"""

from __future__ import annotations

from typing import AsyncIterator

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, is_barrier, is_chunk


class MaterializeExecutor(Executor):
    """Materialize a changelog into a StateTable (materialize.rs:53)."""

    def __init__(self, input_: Executor, table: StateTable):
        self.input = input_
        self.table = table
        super().__init__(ExecutorInfo(input_.schema, list(table.pk_indices),
                                      "MaterializeExecutor"))

    async def execute(self) -> AsyncIterator[Message]:
        it = self.input.execute()
        first = await it.__anext__()
        assert is_barrier(first), "executor protocol: first message is " \
            f"the init barrier, got {first!r}"
        self.table.init_epoch(first.epoch)
        yield first
        async for msg in it:
            if is_chunk(msg):
                self._apply(msg)
            elif is_barrier(msg):
                self.table.commit(msg.epoch)
            yield msg

    def _apply(self, chunk: StreamChunk) -> None:
        # all-insert epochs stage past the memtable and land in the store
        # as one bulk ingest at the barrier
        self.table.write_chunk(chunk, defer=True)
