"""SourceExecutor: turn a split reader into a barrier-respecting stream.

Port of ``risingwave_tpu/stream/executors/source.py`` (reference parity:
src/stream/src/executor/source/source_executor.rs:42, the barrier-select
loop :358-428): between two barriers the executor pulls chunks from its
reader; an arriving barrier wins the select (after the epoch's first
chunk, and after ``min_chunks`` when set). The split offset persists in a
split-state table at every barrier so recovery resumes where the
committed epoch left off, one row per split for a reader that consumes
several (``splits()`` / ``seek_split``, the filelog multi-reader). A
log-style reader (``unbounded``: filelog, the DML channel) that has no
complete record parks the source on its barrier channel until the next
epoch instead of ending the stream. The reference's freshness and
metrics hooks are not ported. Readers are typed by
``connectors/base.py``'s ``SplitReader``.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.connectors.base import SplitReader
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.exchange import ChannelClosed, Receiver
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Barrier, Message, is_barrier,
)


class SourceExecutor(Executor):
    """Drives one split reader; barriers arrive via an injected channel."""

    def __init__(self, reader: SplitReader, barrier_rx: Receiver,
                 split_state: Optional[StateTable] = None,
                 actor_id: int = 0,
                 rate_limit_chunks_per_barrier: Optional[int] = None,
                 min_chunks_per_barrier: Optional[int] = None,
                 identity: str = "SourceExecutor"):
        super().__init__(ExecutorInfo(reader.schema, [], identity))
        self.reader = reader
        self.barrier_rx = barrier_rx
        self.split_state = split_state
        self.actor_id = actor_id
        # max chunks generated per barrier interval (FlowControl analog)
        self.rate_limit = rate_limit_chunks_per_barrier
        # chunks generated per epoch BEFORE a waiting barrier may win the
        # select: back-to-back injection would otherwise starve epochs
        # down to one chunk. None = the reference behavior.
        self.min_chunks = min_chunks_per_barrier
        self.paused = False

    def _recover_offset(self) -> None:
        if self.split_state is None:
            return
        splits = getattr(self.reader, "splits", None)
        if splits is not None:
            # multi-split reader: one durable row per split
            for split_id, _off in splits():
                row = self.split_state.get_row((split_id,))
                if row is not None:
                    self.reader.seek_split(split_id, row[1])
            return
        row = self.split_state.get_row((self.reader.split_id,))
        if row is not None:
            self.reader.seek(row[1])

    def _persist_one(self, split_id: str, offset: int) -> None:
        row = (split_id, offset)
        old = self.split_state.get_row((split_id,))
        if old is None:
            self.split_state.insert(row)
        elif tuple(old) != row:
            self.split_state.update(old, row)

    def _persist_offset(self) -> None:
        if self.split_state is None:
            return
        splits = getattr(self.reader, "splits", None)
        if splits is not None:
            for split_id, off in splits():
                self._persist_one(split_id, off)
            return
        self._persist_one(self.reader.split_id, self.reader.offset)

    def _handle_barrier(self, barrier: Barrier) -> None:
        if barrier.is_pause():
            self.paused = True
        elif barrier.is_resume():
            self.paused = False
        self._persist_offset()
        if self.split_state is not None:
            self.split_state.commit(barrier.epoch)

    async def execute(self) -> AsyncIterator[Message]:
        # protocol: the first message is the init barrier
        first = await self.barrier_rx.recv()
        assert is_barrier(first), f"source got {first!r} before init barrier"
        if self.split_state is not None:
            self.split_state.init_epoch(first.epoch)
        self._recover_offset()
        self.paused = first.is_pause()
        yield first
        if first.is_stop(self.actor_id):
            return

        exhausted = False
        idle = False
        chunks_this_epoch = 0
        while True:
            # the barrier wins the select — except for the FIRST chunk of
            # an epoch, generated before looking at the channel, so
            # back-to-back injection cannot starve the stream
            barrier: Optional[Barrier] = None
            can_generate = not (self.paused or exhausted or idle or (
                self.rate_limit is not None
                and chunks_this_epoch >= self.rate_limit))
            if not can_generate:
                try:
                    barrier = await self.barrier_rx.recv()
                except ChannelClosed:
                    return
            elif chunks_this_epoch > 0 and (
                    self.min_chunks is None
                    or chunks_this_epoch >= self.min_chunks):
                try:
                    barrier = self.barrier_rx.try_recv()
                except ChannelClosed:
                    return
            if barrier is not None:
                assert is_barrier(barrier)
                self._handle_barrier(barrier)
                chunks_this_epoch = 0
                idle = False            # log sources re-poll per epoch
                yield barrier
                if barrier.is_stop(self.actor_id):
                    return
                continue
            chunk = self.reader.next_chunk()
            if chunk is None:
                if getattr(self.reader, "unbounded", False):
                    # log-style source with no complete records yet:
                    # park on the barrier channel (not a busy-poll)
                    idle = True
                else:
                    exhausted = True
                continue
            chunks_this_epoch += 1
            yield chunk
            # yield to the event loop so the barrier injector can run
            await asyncio.sleep(0)
