"""The barrier/checkpoint loop: the system heartbeat.

Port of ``risingwave_tpu/meta/barrier.py`` (reference parity:
src/meta/src/barrier/mod.rs:128,558,652): issue the next epoch, inject its
barrier at the sources, keep barriers in flight, and on collection seal
the ended epoch and commit it at checkpoints. In memory and single
domain: the port commits a checkpoint with the store's own ``sync`` at
collection, where the reference hands it to its asynchronous SST uploader
(``storage/uploader.py``, which pulls in the whole LSM — not ported yet).
Barrier latency is measured inject → commit, as in the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

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
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))]


class BarrierLoop:
    """Explicitly stepped barrier manager over one LocalBarrierManager:
    ``inject`` / ``collect_next`` for pipelined drivers,
    ``inject_and_collect`` for tests. Every barrier after the initial one
    is a checkpoint (the reference's default checkpoint_frequency 1)."""

    def __init__(self, local: LocalBarrierManager, store: StateStore):
        self.local = local
        self.store = store
        self.stats = BarrierStats()
        self._epoch: Optional[Epoch] = None
        self._inject_times = {}
        self._in_flight: List[int] = []       # injected, not yet collected

    @property
    def in_flight_count(self) -> int:
        return len(self._in_flight)

    async def inject(self, mutation: Optional[Mutation] = None) -> Barrier:
        """Issue the next epoch and send its barrier to source actors."""
        kind = BarrierKind.INITIAL if self._epoch is None \
            else BarrierKind.CHECKPOINT
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
        barrier = Barrier(pair, kind, mutation)
        self._inject_times[curr.value] = time.monotonic()
        self._in_flight.append(curr.value)
        await self.local.send_barrier(barrier)
        return barrier

    async def collect_next(self) -> Barrier:
        """Await the oldest in-flight epoch; seal the epoch it ended and
        commit it when the barrier is a checkpoint."""
        assert self._in_flight, "nothing in flight"
        epoch = self._in_flight.pop(0)
        barrier = await self.local.await_epoch_complete(epoch)
        # the epoch whose data this barrier flushed is the one that ENDED:
        # barrier.epoch.prev (the INITIAL barrier's prev is INVALID or the
        # recovered epoch: nothing new to commit)
        prev = barrier.epoch.prev.value
        if prev > self.store.committed_epoch():
            self.store.seal_epoch(prev, barrier.is_checkpoint)
            if barrier.is_checkpoint:
                self.store.sync(prev)
        t0 = self._inject_times.pop(epoch)
        self.stats.latencies_s.append(time.monotonic() - t0)
        self.stats.completed_epochs.append(epoch)
        return barrier

    async def inject_and_collect(
            self, mutation: Optional[Mutation] = None) -> Barrier:
        await self.inject(mutation)
        barrier = None
        while self._in_flight:
            barrier = await self.collect_next()
        return barrier
