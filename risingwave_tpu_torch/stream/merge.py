"""Fan-in: barrier alignment, the merge executors and their coalescing.

Port of ``risingwave_tpu/stream/merge.py`` (reference parity:
src/stream/src/executor/merge.rs:36,112 and barrier_align.rs:34,43). An
input that reaches a barrier is not pulled again until every input
reaches the same barrier; then one aligned barrier is emitted. This is
the Chandy-Lamport cut: everything before the barrier on every input is
in epoch N, everything after in N+1. Watermarks follow the reference's
BufferedWatermarks: the minimum across inputs, monotonically.

``MergeExecutor`` merges exchange channels (``stream/exchange.py``
receivers), ``MergeExecutors`` executor streams. Both optionally
coalesce the merged data stream (``coalesce_rows``): a parallel fan-in
delivers small compacted slivers, and merging them back into dense
target-sized batches keeps the downstream keyed executor's step count
independent of upstream parallelism. Barriers flush the buffer first;
watermarks re-sequence to the next flush (``stream/coalesce.py``).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, List, Optional

from risingwave_tpu_torch.stream.coalesce import (
    DEFAULT_MAX_CHUNKS, ChunkCoalescer,
)
from risingwave_tpu_torch.stream.exchange import ChannelClosed, Receiver
from risingwave_tpu_torch.stream.executor import Executor, ExecutorInfo
from risingwave_tpu_torch.stream.message import (
    Barrier, Message, Watermark, is_barrier,
)


class _WatermarkAligner:
    """Per-column min-watermark across N inputs (monotonic output)."""

    def __init__(self, n_inputs: int):
        self.n = n_inputs
        self.per_col: Dict[int, Dict[int, object]] = {}
        self.emitted: Dict[int, object] = {}

    def update(self, input_idx: int, wm: Watermark) -> Optional[Watermark]:
        seen = self.per_col.setdefault(wm.col_idx, {})
        seen[input_idx] = wm.value
        if len(seen) < self.n:
            return None
        lo = min(seen.values())
        if wm.col_idx in self.emitted and lo <= self.emitted[wm.col_idx]:
            return None
        self.emitted[wm.col_idx] = lo
        return Watermark(wm.col_idx, wm.data_type, lo)

    def remove_input(self, input_idx: int) -> None:
        for seen in self.per_col.values():
            seen.pop(input_idx, None)


def _coalescer(rows: Optional[int], chunks: int) -> Optional[ChunkCoalescer]:
    if not rows or rows <= 0:
        return None
    return ChunkCoalescer(rows, chunks)


class MergeExecutor(Executor):
    """Merge N upstream channels into one aligned stream.

    ``coalesce_rows`` (None: off) merges consecutive small data chunks up
    to that cardinality before yielding; a barrier flushes first."""

    def __init__(self, info: ExecutorInfo, inputs: List[Receiver],
                 actor_id: int = 0,
                 coalesce_rows: Optional[int] = None,
                 coalesce_chunks: int = DEFAULT_MAX_CHUNKS):
        super().__init__(info)
        self.inputs = list(inputs)
        self.actor_id = actor_id
        self.coalesce_rows = coalesce_rows
        self.coalesce_chunks = coalesce_chunks

    async def execute(self) -> AsyncIterator[Message]:
        n = len(self.inputs)
        assert n > 0, "MergeExecutor needs at least one input"
        wm_align = _WatermarkAligner(n)
        co = _coalescer(self.coalesce_rows, self.coalesce_chunks)
        out: asyncio.Queue = asyncio.Queue(maxsize=16)
        # per-input gate: a pump proceeds past a barrier only when the
        # alignment releases it for the next epoch
        gates = [asyncio.Event() for _ in range(n)]
        barrier_box: List[Optional[Barrier]] = [None] * n
        arrived: asyncio.Queue = asyncio.Queue()  # inputs at a barrier

        async def pump(i: int, rx: Receiver):
            try:
                while True:
                    msg = await rx.recv()
                    if is_barrier(msg):
                        barrier_box[i] = msg
                        gates[i].clear()
                        arrived.put_nowait(i)
                        await gates[i].wait()   # until all aligned
                        if barrier_box[i] is StopIteration:   # stopped
                            return
                    else:
                        await out.put((i, msg))
            except ChannelClosed:
                arrived.put_nowait((i, "closed"))

        def handle(i: int, msg) -> List[Message]:
            """One data or watermark message through the aligner and the
            coalescer, if any: what to yield."""
            if isinstance(msg, Watermark):
                w = wm_align.update(i, msg)
                if w is None:
                    return []
                if co is None:
                    return [w]
                # re-sequence to the next flush: watermark-per-chunk
                # upstreams must not force per-sliver batches
                return co.push_watermark(w)
            if co is None:
                return [msg]
            outs: List[Message] = co.push(msg)
            if outs:
                outs += co.drain_watermarks()
            return outs

        pumps = [asyncio.ensure_future(pump(i, rx))
                 for i, rx in enumerate(self.inputs)]
        live = set(range(n))
        try:
            while live:
                pending_barrier: Dict[int, Barrier] = {}
                closed: set = set()
                # drain data until every live input parks at a barrier
                while len(pending_barrier) + len(closed) < len(live):
                    getter = asyncio.ensure_future(out.get())
                    arr = asyncio.ensure_future(arrived.get())
                    done, _ = await asyncio.wait(
                        {getter, arr}, return_when=asyncio.FIRST_COMPLETED)
                    if getter in done:
                        i, msg = getter.result()
                        for m in handle(i, msg):
                            yield m
                    else:
                        getter.cancel()
                    if arr in done:
                        ev = arr.result()
                        if isinstance(ev, tuple):   # (i, "closed")
                            closed.add(ev[0])
                        else:
                            pending_barrier[ev] = barrier_box[ev]
                    else:
                        arr.cancel()
                # every live input is parked at its gate (or closed), so
                # no pump enqueues concurrently: what the alignment race
                # left in the queue precedes the barriers and must not
                # slip into the next epoch
                while True:
                    try:
                        i, msg = out.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    for m in handle(i, msg):
                        yield m
                for i in closed:
                    live.discard(i)
                    wm_align.remove_input(i)
                    wm_align.n = max(1, len(live))
                if co is not None:
                    # the aligned barrier never trails a lingering batch
                    # or a held watermark
                    f = co.flush()
                    if f is not None:
                        yield f
                    for wm in co.drain_watermarks():
                        yield wm
                if not pending_barrier:
                    return      # every upstream closed without a barrier
                barriers = list(pending_barrier.values())
                epochs = {b.epoch.curr.value for b in barriers}
                assert len(epochs) == 1, \
                    f"misaligned barriers across inputs: {barriers}"
                yield barriers[0].with_passed(self.actor_id)
                stop = barriers[0].is_stop(self.actor_id)
                for i in pending_barrier:
                    if stop:
                        barrier_box[i] = StopIteration
                    gates[i].set()
                if stop:
                    return
        finally:
            for p in pumps:
                p.cancel()
            for rx in self.inputs:
                rx.close()


class MergeExecutors(Executor):
    """Merge N upstream executors into one barrier-aligned stream (the
    channel-free variant: each input is an executor stream)."""

    def __init__(self, info: ExecutorInfo, inputs: List[Executor],
                 actor_id: int = 0,
                 coalesce_rows: Optional[int] = None,
                 coalesce_chunks: int = DEFAULT_MAX_CHUNKS):
        super().__init__(info)
        self.inputs = list(inputs)
        self.actor_id = actor_id
        self.coalesce_rows = coalesce_rows
        self.coalesce_chunks = coalesce_chunks

    async def execute(self) -> AsyncIterator[Message]:
        assert self.inputs, "MergeExecutors needs at least one input"
        wm_align = _WatermarkAligner(len(self.inputs))
        co = _coalescer(self.coalesce_rows, self.coalesce_chunks)
        async for tag, msg in barrier_align_n(
                [i.execute() for i in self.inputs]):
            if tag == "barrier":
                if co is not None:
                    f = co.flush()    # a barrier never waits on lingering rows
                    if f is not None:
                        yield f
                    for wm in co.drain_watermarks():
                        yield wm
                yield msg.with_passed(self.actor_id)
                if msg.is_stop(self.actor_id):
                    return
            elif isinstance(msg, Watermark):
                w = wm_align.update(tag, msg)
                if w is not None:
                    if co is None:
                        yield w
                    else:
                        for m in co.push_watermark(w):
                            yield m
            elif co is not None:
                outs = co.push(msg)
                for merged in outs:
                    yield merged
                if outs:
                    for wm in co.drain_watermarks():
                        yield wm
            else:
                yield msg


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
