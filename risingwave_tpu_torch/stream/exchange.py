"""Exchange channels: bounded, permit-based message passing between actors.

Port of ``risingwave_tpu/stream/exchange.py`` (reference parity:
src/stream/src/executor/exchange/permit.rs:35,75,111,152): bounded
channels with separate budgets for data chunks (cost = rows, capped) and
barriers, so backpressure on data never blocks checkpoints for long. The
port drops the reference's per-edge metrics and backpressure meters.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

from risingwave_tpu_torch.common.chunk import StreamChunk
from risingwave_tpu_torch.stream.message import Barrier, Message


class ChannelClosed(Exception):
    """recv after the sender closed the channel and it drained."""


class _Shared:
    def __init__(self, chunk_permits: int, barrier_permits: int,
                 max_chunk_cost: int):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.chunk_permits = chunk_permits
        self.barrier_permits = barrier_permits
        self.max_chunk_cost = max_chunk_cost
        self.cond = asyncio.Condition()


class Sender:
    def __init__(self, shared: _Shared):
        self._s = shared

    async def send(self, msg: Message) -> None:
        s = self._s
        if isinstance(msg, StreamChunk):
            cost = max(1, min(msg.capacity, s.max_chunk_cost))
            async with s.cond:
                await s.cond.wait_for(lambda: s.chunk_permits >= cost)
                s.chunk_permits -= cost
            s.queue.put_nowait(("chunk", cost, msg))
        elif isinstance(msg, Barrier):
            async with s.cond:
                await s.cond.wait_for(lambda: s.barrier_permits >= 1)
                s.barrier_permits -= 1
            s.queue.put_nowait(("barrier", 1, msg))
        else:  # watermarks are control-plane: unmetered
            s.queue.put_nowait(("watermark", 0, msg))

    def close(self) -> None:
        self._s.queue.put_nowait(("eos", 0, None))


class Receiver:
    def __init__(self, shared: _Shared):
        self._s = shared
        self._notifies: set = set()   # pending permit-return tasks

    async def recv(self) -> Message:
        s = self._s
        kind, cost, msg = await s.queue.get()
        if kind == "eos":
            raise ChannelClosed
        if cost:
            async with s.cond:
                if kind == "chunk":
                    s.chunk_permits += cost
                else:
                    s.barrier_permits += 1
                s.cond.notify_all()
        return msg

    def try_recv(self) -> Optional[Message]:
        """Non-blocking recv: None if empty (source barrier-select path)."""
        s = self._s
        try:
            kind, cost, msg = s.queue.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if kind == "eos":
            raise ChannelClosed
        if cost:
            if kind == "chunk":
                s.chunk_permits += cost
            else:
                s.barrier_permits += 1
            # return permits without blocking: schedule the notify
            task = asyncio.get_running_loop().create_task(self._notify())
            self._notifies.add(task)
            task.add_done_callback(self._notifies.discard)
        return msg

    async def _notify(self) -> None:
        async with self._s.cond:
            self._s.cond.notify_all()


def channel(chunk_permits: int = 32768, barrier_permits: int = 4,
            max_chunk_cost: Optional[int] = None
            ) -> Tuple[Sender, Receiver]:
    """Bounded exchange channel (permit.rs:35 `channel` analog)."""
    if max_chunk_cost is None:
        max_chunk_cost = max(1, chunk_permits // 2)
    shared = _Shared(chunk_permits, barrier_permits, max_chunk_cost)
    return Sender(shared), Receiver(shared)


def channel_for_test() -> Tuple[Sender, Receiver]:
    return channel(chunk_permits=1 << 20, barrier_permits=64)
