"""Fan-out: DispatchExecutor with hash/broadcast/simple dispatchers.

Port of ``risingwave_tpu/stream/dispatch.py`` (reference parity:
src/stream/src/executor/dispatch.rs:45 DispatchExecutor, :343 the
dispatcher enum, :507 Broadcast, :582-690 HashDataDispatcher). The hash
dispatcher routes each row by the vnode of its distribution key, the
same vnode K1's row hash (B1) gives (``common/hash.py``), and hands each
output its slice COMPACTED to a dense chunk (``stream/coalesce.compact``)
so a slice pays its true exchange credit; zero-row slices are not sent.
UpdateDelete/UpdateInsert pairs split across outputs degrade to
Delete/Insert. Routing is one vectorized host pass: chunks are host
numpy here, and nothing on this path touches the card.
"""

from __future__ import annotations

import abc
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.hash import VnodeMapping
from risingwave_tpu_torch.stream.exchange import ChannelClosed, Sender
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.message import (
    Barrier, Message, UpdateMutation, Watermark, is_barrier, is_chunk,
)


class Output:
    """One downstream edge: a named sender (dispatch.rs `Output` analog)."""

    def __init__(self, downstream_actor_id: int, sender: Sender):
        self.actor_id = downstream_actor_id
        self.sender = sender

    async def send(self, msg: Message) -> None:
        await self.sender.send(msg)

    def close(self) -> None:
        self.sender.close()


class Dispatcher(abc.ABC):
    dispatcher_id: int = 0

    @abc.abstractmethod
    async def dispatch_data(self, chunk: StreamChunk) -> None: ...

    @abc.abstractmethod
    async def dispatch_barrier(self, barrier: Barrier) -> None: ...

    async def dispatch_watermark(self, wm: Watermark) -> None:
        for out in self.outputs():
            await out.send(wm)

    @abc.abstractmethod
    def outputs(self) -> List[Output]: ...

    def update_outputs(self, new_outputs: List[Output]) -> None:
        """Swap downstream set at a barrier (scaling)."""
        self._set_outputs(new_outputs)

    @abc.abstractmethod
    def _set_outputs(self, outputs: List[Output]) -> None: ...

    def close(self) -> None:
        for out in self.outputs():
            out.close()


def _is_empty(chunk: StreamChunk) -> bool:
    """Zero visible rows: nothing downstream could do with it but pay
    a send + a recv + (for keyed executors) a device dispatch.
    Compacted chunks answer from ``dense_rows``."""
    if chunk.dense_rows is not None:
        return chunk.dense_rows == 0
    return not np.asarray(chunk.visibility).any()


class SimpleDispatcher(Dispatcher):
    """Single downstream (DispatcherType::SIMPLE)."""

    def __init__(self, output: Output, dispatcher_id: int = 0):
        self._output = output
        self.dispatcher_id = dispatcher_id

    async def dispatch_data(self, chunk: StreamChunk) -> None:
        if _is_empty(chunk):
            return
        await self._output.send(chunk)

    async def dispatch_barrier(self, barrier: Barrier) -> None:
        await self._output.send(barrier)

    def outputs(self) -> List[Output]:
        return [self._output]

    def _set_outputs(self, outputs: List[Output]) -> None:
        assert len(outputs) == 1
        self._output = outputs[0]


class BroadcastDispatcher(Dispatcher):
    """Replicate everything to every downstream (dispatch.rs:507)."""

    def __init__(self, outputs: Sequence[Output], dispatcher_id: int = 0):
        self._outputs = list(outputs)
        self.dispatcher_id = dispatcher_id

    async def dispatch_data(self, chunk: StreamChunk) -> None:
        if _is_empty(chunk):
            return
        for out in self._outputs:
            await out.send(chunk)

    async def dispatch_barrier(self, barrier: Barrier) -> None:
        for out in self._outputs:
            await out.send(barrier)

    def outputs(self) -> List[Output]:
        return list(self._outputs)

    def _set_outputs(self, outputs: List[Output]) -> None:
        self._outputs = list(outputs)


class RoundRobinDispatcher(Dispatcher):
    """Rotate chunks across outputs (stateless fragments only)."""

    def __init__(self, outputs: Sequence[Output], dispatcher_id: int = 0):
        self._outputs = list(outputs)
        self._cur = 0
        self.dispatcher_id = dispatcher_id

    async def dispatch_data(self, chunk: StreamChunk) -> None:
        if _is_empty(chunk):
            return
        await self._outputs[self._cur].send(chunk)
        self._cur = (self._cur + 1) % len(self._outputs)

    async def dispatch_barrier(self, barrier: Barrier) -> None:
        for out in self._outputs:
            await out.send(barrier)

    def outputs(self) -> List[Output]:
        return list(self._outputs)

    def _set_outputs(self, outputs: List[Output]) -> None:
        self._outputs = list(outputs)
        self._cur = 0


class HashDispatcher(Dispatcher):
    """Route rows by vnode of the distribution key (dispatch.rs:582).

    The chunk is hashed once (vectorized); each output receives the chunk
    with visibility restricted to its vnodes. UpdateDelete/UpdateInsert
    pairs whose halves would land on different outputs are degraded to
    Delete+Insert (dispatch.rs:640-ish invariant: a downstream must never
    see half an update pair).
    """

    def __init__(self, outputs: Sequence[Output], dist_key_indices: List[int],
                 mapping: Optional[VnodeMapping] = None,
                 dispatcher_id: int = 0):
        self._outputs = list(outputs)
        self.dist_key_indices = list(dist_key_indices)
        self.mapping = mapping or VnodeMapping.new_uniform(len(self._outputs))
        self.dispatcher_id = dispatcher_id

    def _route(self, chunk: StreamChunk) -> np.ndarray:
        """vnode → output index per row (one vectorized host pass).

        Chunks are host-resident here; the device twin of this routing is
        the all-to-all permutation in parallel/ (same hash bits).
        """
        from risingwave_tpu_torch.common.hash import hash_strings_host, \
            vnodes_of_host
        key_cols = []
        for i in self.dist_key_indices:
            col = chunk.columns[i]
            if col.is_device:
                key_cols.append(np.asarray(col.values))
            else:
                key_cols.append(hash_strings_host(
                    np.asarray(col.values), chunk.capacity))
        vn = vnodes_of_host(key_cols)
        return np.asarray(self.mapping.owners)[vn]

    async def dispatch_data(self, chunk: StreamChunk) -> None:
        owner = self._route(chunk)
        ops = np.asarray(chunk.ops)
        vis = np.asarray(chunk.visibility)
        # atomicity of update pairs: U- at i pairs with U+ at i+1
        new_ops = ops.copy()
        idx = np.flatnonzero(vis & (ops == int(Op.UPDATE_DELETE)))
        for i in idx:
            j = i + 1
            if j < len(ops) and ops[j] == int(Op.UPDATE_INSERT) \
                    and owner[i] != owner[j]:
                new_ops[i] = int(Op.DELETE)
                new_ops[j] = int(Op.INSERT)
        out_ops = new_ops if (new_ops != ops).any() else chunk.ops
        vis_host = np.asarray(chunk.visibility)
        from risingwave_tpu_torch.stream.coalesce import compact
        for oi, out in enumerate(self._outputs):
            sub_vis = vis_host & (owner == oi)
            # compact each slice: a 1/N-visible full-capacity chunk
            # would charge N× its true exchange credit, ship N× its
            # wire bytes and cost a full device dispatch downstream.
            # Slices with zero visible rows are suppressed entirely.
            sub = compact(StreamChunk(chunk.schema, chunk.columns,
                                      sub_vis, out_ops))
            if sub is None:
                continue
            await out.send(sub)

    async def dispatch_barrier(self, barrier: Barrier) -> None:
        # apply mapping updates carried by the barrier BEFORE forwarding:
        # post-barrier chunks must use the new routing
        m = barrier.mutation
        if isinstance(m, UpdateMutation) and \
                self.dispatcher_id in m.dispatcher_updates:
            self.update_outputs(m.dispatcher_updates[self.dispatcher_id])
        for out in self._outputs:
            await out.send(barrier)

    def outputs(self) -> List[Output]:
        return list(self._outputs)

    def _set_outputs(self, outputs: List[Output]) -> None:
        if len(outputs) != self.mapping.num_owners():
            self.mapping = self.mapping.rebalance(len(outputs))
        self._outputs = list(outputs)


class DispatchExecutor:
    """Drives one upstream executor into N dispatchers (dispatch.rs:45)."""

    def __init__(self, upstream: Executor, dispatchers: Sequence[Dispatcher],
                 actor_id: int = 0):
        self.upstream = upstream
        self.dispatchers = list(dispatchers)
        self.actor_id = actor_id

    async def run(self) -> None:
        try:
            async for msg in self.upstream.execute():
                for d in self.dispatchers:
                    if is_chunk(msg):
                        await d.dispatch_data(msg)
                    elif is_barrier(msg):
                        await d.dispatch_barrier(msg)
                    else:
                        await d.dispatch_watermark(msg)
                if is_barrier(msg) and msg.is_stop(self.actor_id):
                    break
        finally:
            for d in self.dispatchers:
                d.close()
