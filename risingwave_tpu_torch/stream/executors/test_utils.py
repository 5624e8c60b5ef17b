"""Test scaffolding: MockSource.

Port of ``risingwave_tpu/stream/executors/test_utils.py``.

Reference parity: src/stream/src/executor/test_utils.rs:46 — `MockSource`
feeds hand-built chunks/barriers into an executor chain; every reference
executor test is written against it, and ours are too (SURVEY §4 lesson:
executor-level tests = MockSource + MemoryStateStore fake).
"""

from __future__ import annotations

from typing import AsyncIterator, Iterable, List, Optional

from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.exchange import ChannelClosed, channel_for_test
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import Message, is_barrier


class MockSource(Executor):
    """Replays a scripted message list, or drains a channel if fed live."""

    def __init__(self, schema: Schema, messages: Iterable[Message] = (),
                 pk_indices: Optional[List[int]] = None,
                 stop_after_script: bool = True):
        super().__init__(ExecutorInfo(schema, pk_indices or [], "MockSource"))
        self.messages = list(messages)
        self.stop_after_script = stop_after_script
        self._tx, self._rx = channel_for_test()

    @staticmethod
    def channel(schema: Schema, pk_indices: Optional[List[int]] = None):
        """(sender, MockSource) pair for driving a chain interactively."""
        src = MockSource(schema, [], pk_indices, stop_after_script=False)
        return src._tx, src

    async def execute(self) -> AsyncIterator[Message]:
        for msg in self.messages:
            yield msg
        if self.stop_after_script:
            return
        while True:
            try:
                msg = await self._rx.recv()
            except ChannelClosed:
                return
            yield msg


async def collect_until_n_barriers(executor: Executor, n: int
                                   ) -> List[Message]:
    """Drive an executor until `n` barriers have been observed."""
    out: List[Message] = []
    seen = 0
    async for msg in executor.execute():
        out.append(msg)
        if is_barrier(msg):
            seen += 1
            if seen >= n:
                break
    return out
