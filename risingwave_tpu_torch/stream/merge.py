"""Barrier alignment of two input streams for binary operators.

Port of ``barrier_align_n`` (:267) and ``barrier_align_2`` (:313) of
``risingwave_tpu/stream/merge.py`` (reference parity:
src/stream/src/executor/barrier_align.rs:34,43). An input that reaches a
barrier is not pulled again until every input reaches the same barrier;
then one aligned barrier is yielded. This is the Chandy-Lamport cut:
everything before the barrier on every input is in epoch N, everything
after in N+1. The merge executor and its coalescing are not ported.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, List, Optional

from risingwave_tpu_torch.stream.message import Barrier, Message, is_barrier


async def barrier_align_n(inputs: List[AsyncIterator[Message]]
                          ) -> AsyncIterator[tuple]:
    """N-way alignment: yields (input_idx, msg) for data and
    ("barrier", Barrier) once per aligned set. Ends when any input
    ends."""
    async def nxt(it):
        try:
            return await it.__anext__()
        except StopAsyncIteration:
            return None

    n = len(inputs)
    futs = [asyncio.ensure_future(nxt(it)) for it in inputs]
    parked: List[Optional[Barrier]] = [None] * n
    try:
        while True:
            if all(b is not None for b in parked):
                epochs = {b.epoch.curr.value for b in parked}
                assert len(epochs) == 1, \
                    f"misaligned barriers across inputs: {parked}"
                yield ("barrier", parked[0])
                parked = [None] * n
                futs = [asyncio.ensure_future(nxt(it)) for it in inputs]
                continue
            waits = {futs[i] for i in range(n) if parked[i] is None}
            done, _ = await asyncio.wait(
                waits, return_when=asyncio.FIRST_COMPLETED)
            for i in range(n):
                if parked[i] is not None or futs[i] not in done:
                    continue
                msg = futs[i].result()
                if msg is None:
                    return
                if is_barrier(msg):
                    parked[i] = msg
                else:
                    yield (i, msg)
                    futs[i] = asyncio.ensure_future(nxt(inputs[i]))
    finally:
        for f in futs:
            f.cancel()


async def barrier_align_2(left: AsyncIterator[Message],
                          right: AsyncIterator[Message]
                          ) -> AsyncIterator[tuple]:
    """2-way alignment for binary operators: ("left"|"right"|"barrier",
    msg)."""
    tags = {0: "left", 1: "right"}
    async for tag, msg in barrier_align_n([left, right]):
        yield (tags.get(tag, tag), msg)
