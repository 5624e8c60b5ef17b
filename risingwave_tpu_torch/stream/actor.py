"""Actors and the local barrier manager.

Port of ``risingwave_tpu/stream/actor.py`` (reference parity:
src/stream/src/executor/actor.rs:36 and src/stream/src/task/
barrier_manager.rs:103,119): an actor is one asyncio task driving an
executor chain; the LocalBarrierManager sends injected barriers to source
actors through registered senders and collects per-actor completion per
epoch. The port covers one alignment domain and actors with no
dispatchers (the q7 pipeline is one actor); the reference's monitoring,
metrics and domain scoping are not ported.

Barrier collection is the device sync point: an actor reports a barrier
collected after its executors flushed device state for the epoch.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence, Set

from risingwave_tpu_torch.stream.exchange import Sender
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.message import Barrier, is_barrier


class Actor:
    """One dataflow task: an executor chain and its barrier reports."""

    def __init__(self, actor_id: int, consumer: Executor,
                 dispatchers: Sequence = (),
                 barrier_manager: Optional["LocalBarrierManager"] = None,
                 fragment: str = ""):
        if dispatchers:
            raise NotImplementedError(
                "dispatchers are not ported: an actor here ends its chain")
        self.actor_id = actor_id
        self.consumer = consumer
        self.barrier_manager = barrier_manager
        self.fragment = fragment
        self.failure: Optional[BaseException] = None

    async def run(self) -> None:
        try:
            await self._run_consumer()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — reported to the manager
            self.failure = e
            if self.barrier_manager is None:
                raise
            self.barrier_manager.notify_failure(self.actor_id, e)

    async def _run_consumer(self) -> None:
        async for msg in self.consumer.execute():
            if not is_barrier(msg):
                continue
            barrier = msg.with_passed(self.actor_id)
            if self.barrier_manager is not None:
                self.barrier_manager.collect(self.actor_id, barrier)
            if barrier.is_stop(self.actor_id):
                break
            # let the barrier loop observe the collect before this task
            # runs into the next epoch's first chunk
            await asyncio.sleep(0)

    def spawn(self) -> asyncio.Task:
        return asyncio.ensure_future(self.run())


class LocalBarrierManager:
    """Collects per-actor barrier completions (barrier_manager.rs:119)."""

    def __init__(self):
        self._barrier_senders: Dict[int, List[Sender]] = {}
        self._expected_actors: Set[int] = set()
        self._collected: Dict[int, Set[int]] = {}   # epoch -> actor ids
        self._complete: Dict[int, asyncio.Event] = {}
        self._barriers: Dict[int, Barrier] = {}
        self._failed: Optional[BaseException] = None

    def register_sender(self, actor_id: int, sender: Sender) -> None:
        """Source-like actors receive injected barriers via these senders."""
        self._barrier_senders.setdefault(actor_id, []).append(sender)

    def set_expected_actors(self, actor_ids: Sequence[int]) -> None:
        self._expected_actors = set(actor_ids)

    async def send_barrier(self, barrier: Barrier) -> None:
        epoch = barrier.epoch.curr.value
        self._collected.setdefault(epoch, set())
        ev = self._complete.setdefault(epoch, asyncio.Event())
        self._barriers[epoch] = barrier
        for senders in list(self._barrier_senders.values()):
            for s in senders:
                await s.send(barrier)
        if not self._expected_actors or \
                self._collected[epoch] >= self._expected_actors:
            ev.set()

    def collect(self, actor_id: int, barrier: Barrier) -> None:
        epoch = barrier.epoch.curr.value
        got = self._collected.setdefault(epoch, set())
        got.add(actor_id)
        ev = self._complete.setdefault(epoch, asyncio.Event())
        if self._expected_actors and got >= self._expected_actors:
            ev.set()

    def notify_failure(self, actor_id: int, err: BaseException) -> None:
        self._failed = err
        for ev in self._complete.values():
            ev.set()

    async def await_epoch_complete(self, epoch: int) -> Barrier:
        """Block until every expected actor collected `epoch`."""
        ev = self._complete.setdefault(epoch, asyncio.Event())
        if self._failed is not None:
            ev.set()
        await ev.wait()
        self._collected.pop(epoch, None)
        self._complete.pop(epoch, None)
        barrier = self._barriers.pop(epoch, None)
        if self._failed is not None:
            raise RuntimeError(
                f"actor failure during epoch {epoch:#x}") from self._failed
        return barrier
