"""The barrier/checkpoint loop: the system heartbeat.

Port of ``risingwave_tpu/meta/barrier.py`` (reference parity:
src/meta/src/barrier/mod.rs:128,558,652): issue the next epoch, inject its
barrier at the sources, keep barriers in flight, and on collection seal
the ended epoch and commit it at checkpoints. In memory and single
domain: the port commits a checkpoint with the store's own ``sync`` at
collection, where the reference hands it to its asynchronous SST uploader
(``storage/uploader.py``, which pulls in the whole LSM — not ported yet).
Barrier latency is measured inject → commit, as in the reference.

The one-domain half that a SQL session drives is ported too:
``checkpoint_frequency`` with ``_next_kind`` (:419), ``schedule_mutation``
(:375) and ``EpochProfiler`` (:125) with ``drop_first``. The reference's
profiler also keeps rows moved per actor, read from the executor
monitor's counters (``ROADMAP.md`` item 12), which the port does not
have yet: its profiles hold no such column rather than a made-up one.
Barrier domains (``meta/domains.py``) are item 12 as well.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
from risingwave_tpu_torch.state.store import StateStore
from risingwave_tpu_torch.stream.actor import LocalBarrierManager
from risingwave_tpu_torch.stream.message import Barrier, BarrierKind, Mutation


@dataclass
class BarrierStats:
    """Collected per-epoch latencies (meta barrier_latency analog)."""

    completed_epochs: List[int] = field(default_factory=list)
    latencies_s: List[float] = field(default_factory=list)

    def p99_latency_s(self) -> float:
        """Exact quantile over the raw observations (the reference's
        index convention: sorted[min(n - 1, int(n * q))])."""
        return exact_quantile(self.latencies_s, 0.99)


def exact_quantile(xs: List[float], q: float) -> float:
    """sorted[min(n - 1, int(n * q))], 0.0 when empty (the reference's
    ``utils/metrics.exact_quantile``)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(len(s) * q))]


@dataclass
class EpochProfile:
    """One barrier's breakdown (the reference's ``EpochProfile``)."""

    epoch: int
    kind: str                         # "barrier" | "checkpoint"
    inject_to_collect_s: float
    collect_to_commit_s: float
    in_flight: int                    # window depth at collection
    slowest_actor: Optional[int] = None
    slowest_actor_lag_s: float = 0.0  # first-collect → last-collect
    upload_s: float = 0.0             # no asynchronous uploader: 0
    queue_depth: int = 0
    domain: str = ""                  # one domain: ""

    @property
    def total_s(self) -> float:
        return self.inject_to_collect_s + self.collect_to_commit_s


class EpochProfiler:
    """Barrier-aligned snapshots: each collection split into
    inject→collect and collect→commit, with the slowest actor."""

    def __init__(self, capacity: int = 1 << 16):
        self.profiles: Deque[EpochProfile] = deque(maxlen=capacity)

    def record(self, epoch: int, kind: str, inject_to_collect_s: float,
               collect_to_commit_s: float, in_flight: int,
               collect_times: Dict[int, float]) -> EpochProfile:
        prof = EpochProfile(epoch, kind, inject_to_collect_s,
                            collect_to_commit_s, in_flight)
        if collect_times:
            slowest = max(collect_times, key=collect_times.get)
            prof.slowest_actor = slowest
            prof.slowest_actor_lag_s = (collect_times[slowest]
                                        - min(collect_times.values()))
        self.profiles.append(prof)
        return prof

    def drop_first(self, n: int) -> None:
        """Discard the oldest n profiles (warmup epochs)."""
        for _ in range(min(n, len(self.profiles))):
            self.profiles.popleft()

    def rows(self) -> List[tuple]:
        """The ``rw_barrier_latency`` payload, in the reference's column
        order."""
        return [(p.epoch, p.kind, p.inject_to_collect_s,
                 p.collect_to_commit_s, p.total_s, p.in_flight,
                 p.slowest_actor, p.slowest_actor_lag_s,
                 p.upload_s, p.queue_depth, p.domain)
                for p in self.profiles]

    def p99_breakdown(self) -> Dict[str, float]:
        profs = list(self.profiles)
        return {
            "inject_to_collect_s": exact_quantile(
                [p.inject_to_collect_s for p in profs], 0.99),
            "collect_to_commit_s": exact_quantile(
                [p.collect_to_commit_s for p in profs], 0.99),
            "upload_s": 0.0,
        }


class BarrierLoop:
    """Explicitly stepped barrier manager over one LocalBarrierManager:
    ``inject`` / ``collect_next`` for pipelined drivers,
    ``inject_and_collect`` for tests and the SQL session, ``run`` for a
    wall-clock heartbeat. Every
    ``checkpoint_frequency``-th barrier after the initial one is a
    checkpoint (default 1: every one); ``force_checkpoint`` makes one
    now."""

    # run()'s in-flight window (the reference's default)
    IN_FLIGHT_BARRIERS = 10

    def __init__(self, local: LocalBarrierManager, store: StateStore,
                 checkpoint_frequency: int = 1, interval_ms: int = 250):
        self.local = local
        self.store = store
        self.checkpoint_frequency = max(1, checkpoint_frequency)
        self.interval_ms = interval_ms          # run()'s wall-clock tick
        self._stopped = False
        self.stats = BarrierStats()
        self.profiler = EpochProfiler()
        self._epoch: Optional[Epoch] = None
        self._barriers_since_checkpoint = 0
        self._inject_times = {}
        self._in_flight: List[int] = []       # injected, not yet collected
        self._pending_mutations: List[Mutation] = []

    @property
    def in_flight_count(self) -> int:
        return len(self._in_flight)

    def schedule_mutation(self, mutation: Mutation) -> None:
        """Ride the next barrier that carries no mutation of its own."""
        self._pending_mutations.append(mutation)

    def _next_kind(self, force_checkpoint: bool) -> BarrierKind:
        if self._epoch is None:
            return BarrierKind.INITIAL
        self._barriers_since_checkpoint += 1
        if force_checkpoint or (self._barriers_since_checkpoint
                                >= self.checkpoint_frequency):
            return BarrierKind.CHECKPOINT
        return BarrierKind.BARRIER

    async def inject(self, mutation: Optional[Mutation] = None,
                     force_checkpoint: bool = False) -> Barrier:
        """Issue the next epoch and send its barrier to source actors."""
        kind = self._next_kind(force_checkpoint)
        if self._epoch is None:
            curr = Epoch.now()
            # recovery: the initial barrier's prev is the committed epoch,
            # so state-table reads see the checkpointed data
            recovered = Epoch(self.store.committed_epoch())
            if curr.value <= recovered.value:
                curr = Epoch(recovered.value + 1)
            pair = EpochPair(curr=curr, prev=recovered)
        else:
            curr = self._epoch.next()
            pair = EpochPair(curr=curr, prev=self._epoch)
        self._epoch = curr
        if mutation is None and self._pending_mutations:
            mutation = self._pending_mutations.pop(0)
        barrier = Barrier(pair, kind, mutation)
        self._inject_times[curr.value] = time.monotonic()
        self._in_flight.append(curr.value)
        if kind.is_checkpoint:
            self._barriers_since_checkpoint = 0
        await self.local.send_barrier(barrier)
        return barrier

    async def collect_next(self) -> Barrier:
        """Await the oldest in-flight epoch; seal the epoch it ended and
        commit it when the barrier is a checkpoint."""
        assert self._in_flight, "nothing in flight"
        epoch = self._in_flight.pop(0)
        barrier = await self.local.await_epoch_complete(epoch)
        t_collect = time.monotonic()
        # the epoch whose data this barrier flushed is the one that ENDED:
        # barrier.epoch.prev (the INITIAL barrier's prev is INVALID or the
        # recovered epoch: nothing new to commit)
        prev = barrier.epoch.prev.value
        if prev > self.store.committed_epoch():
            self.store.seal_epoch(prev, barrier.is_checkpoint)
            if barrier.is_checkpoint:
                self.store.sync(prev)
        t0 = self._inject_times.pop(epoch)
        now = time.monotonic()
        self.stats.latencies_s.append(now - t0)
        self.stats.completed_epochs.append(epoch)
        self.profiler.record(
            epoch, "checkpoint" if barrier.is_checkpoint else "barrier",
            inject_to_collect_s=t_collect - t0,
            collect_to_commit_s=now - t_collect,
            in_flight=len(self._in_flight),
            collect_times=self.local.take_collect_times(epoch))
        return barrier

    async def inject_and_collect(
            self, mutation: Optional[Mutation] = None,
            force_checkpoint: bool = False) -> Barrier:
        await self.inject(mutation, force_checkpoint)
        barrier = None
        while self._in_flight:
            barrier = await self.collect_next()
        return barrier

    async def run(self, stop_after: Optional[int] = None) -> None:
        """Tick-inject-collect until ``stop()`` (or ``stop_after``
        barriers): a barrier is injected every ``interval_ms`` while the
        in-flight window has room, and collections overlap the ticks
        (the reference's ``run``, :737, on the wall clock)."""
        n = 0
        collector = None
        interval = self.interval_ms / 1000
        next_tick = time.monotonic()      # first barrier fires at once
        try:
            while not self._stopped and (stop_after is None
                                         or n < stop_after):
                if time.monotonic() >= next_tick:
                    if len(self._in_flight) < self.IN_FLIGHT_BARRIERS:
                        await self.inject()
                        n += 1
                    next_tick = max(next_tick + interval, time.monotonic())
                if collector is None and self._in_flight:
                    collector = asyncio.ensure_future(self.collect_next())
                delay = max(0.0, next_tick - time.monotonic())
                sleeper = asyncio.ensure_future(asyncio.sleep(delay))
                waits = {sleeper} | ({collector} if collector else set())
                done, _ = await asyncio.wait(
                    waits, return_when=asyncio.FIRST_COMPLETED)
                if collector in done:
                    collector.result()
                    collector = None
                if sleeper not in done:
                    sleeper.cancel()
            # drain: a running collector holds an epoch already popped from
            # the in-flight list; await it too, or the last epoch never
            # commits
            while collector is not None or self._in_flight:
                if collector is not None:
                    await collector
                    collector = None
                else:
                    await self.collect_next()
        finally:
            if collector is not None:
                collector.cancel()

    def stop(self) -> None:
        self._stopped = True
