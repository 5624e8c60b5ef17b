"""Hand-built Nexmark pipelines: q7-core (hash agg on the device).

Port of ``build_q7`` (:134) and ``drive_to_completion`` (:283) of
``risingwave_tpu/models/nexmark.py``:

    Nexmark bid source → [WatermarkFilter] → project(tumble_start(
    date_time, window), price) → HashAggExecutor(MAX(price), COUNT(*),
    append-only, device kernels) → materialize

driven by a ``BarrierLoop`` over ``MemoryStateStore``. With
``watermark_delay`` the agg retires closed windows on the device.
``device=None`` means the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions. The reference's monitoring, fusion, mesh, coalescing
and tiering options are not ported and raise NotImplementedError.

``from_jax_state`` / ``to_numpy_state`` (from ``ops/hash_agg.py``) carry
grouped-agg device state across the two packages as numpy arrays:
a reference ``AggState`` (``ht.TableState`` + group_rows, dirty, accs,
emitted_*) into the port's ``AggState`` on a given device, and back into
the reference's layout. Nothing here imports JAX.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.connectors.nexmark import (
    NexmarkConfig, NexmarkSplitReader,
)
from risingwave_tpu_torch.expr.expr import InputRef, tumble_start
from risingwave_tpu_torch.meta.barrier import BarrierLoop
from risingwave_tpu_torch.ops.hash_agg import (  # noqa: F401 (re-export)
    AggKind, from_jax_state, to_numpy_state,
)
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream.actor import Actor, LocalBarrierManager
from risingwave_tpu_torch.stream.exchange import channel_for_test
from risingwave_tpu_torch.stream.executors.hash_agg import (
    AggCall, HashAggExecutor, agg_state_schema,
)
from risingwave_tpu_torch.stream.executors.materialize import (
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
from risingwave_tpu_torch.stream.executors.source import SourceExecutor
from risingwave_tpu_torch.stream.executors.watermark_filter import (
    WATERMARK_STATE_SCHEMA, WatermarkFilterExecutor,
)
from risingwave_tpu_torch.stream.message import StopMutation
from risingwave_tpu_torch.utils.device import resolve_device

SPLIT_STATE_SCHEMA = Schema([Field("split_id", DataType.VARCHAR),
                             Field("offset", DataType.INT64)])
DEFAULT_WINDOW = Interval(usecs=10_000_000)   # 10 seconds


@dataclass
class Pipeline:
    """A runnable hand-built plan: one actor + its barrier loop."""

    actor: Actor
    loop: BarrierLoop
    mv_table: StateTable
    readers: Dict[int, NexmarkSplitReader]

    @property
    def reader(self) -> NexmarkSplitReader:
        assert len(self.readers) == 1
        return next(iter(self.readers.values()))


def _source(local: LocalBarrierManager, store, actor_id: int,
            cfg: NexmarkConfig, table_id: int,
            rate_limit: Optional[int],
            min_chunks: Optional[int] = None) -> SourceExecutor:
    reader = NexmarkSplitReader(cfg)
    tx, rx = channel_for_test()
    split_state = StateTable(table_id, SPLIT_STATE_SCHEMA, [0], store)
    local.register_sender(actor_id, tx)
    return SourceExecutor(reader, rx, split_state, actor_id=actor_id,
                          rate_limit_chunks_per_barrier=rate_limit,
                          min_chunks_per_barrier=min_chunks)


def build_q7(store, cfg: NexmarkConfig,
             rate_limit: Optional[int] = 4,
             window: Interval = DEFAULT_WINDOW,
             min_chunks: Optional[int] = None,
             watermark_delay: Optional[Interval] = None,
             mesh=None,
             coalesce_rows: Optional[int] = None,
             tier_cap: Optional[int] = None,
             fusion: bool = False,
             device=None) -> Pipeline:
    """q7-core: MAX(price), COUNT(*) per tumbling window (device agg).

    With ``watermark_delay``, a WatermarkFilter generates event-time
    watermarks on date_time; the projection derives a window_start
    watermark through tumble_start, and the agg retires closed windows
    (bounded state)."""
    for what, given in (("mesh", mesh), ("coalesce_rows", coalesce_rows),
                        ("tier_cap", tier_cap), ("fusion", fusion)):
        if given:
            raise NotImplementedError(f"build_q7 {what} is not ported")
    if not isinstance(store, MemoryStateStore):
        raise NotImplementedError(
            "only MemoryStateStore is ported (no hummock store yet)")
    device = resolve_device(device)
    local = LocalBarrierManager()
    source = _source(local, store, 1, cfg, 1, rate_limit, min_chunks)
    s = source.schema
    upstream = source
    derivations = None
    if watermark_delay is not None:
        wm_state = StateTable(10, WATERMARK_STATE_SCHEMA, [0], store)
        upstream = WatermarkFilterExecutor(
            source, s.index_of("date_time"), watermark_delay, wm_state)
        w = window.exact_usecs()
        derivations = {s.index_of("date_time"): (0, lambda v: v - v % w)}
    project = ProjectExecutor(
        upstream,
        exprs=[tumble_start(
            InputRef(s.index_of("date_time"), DataType.TIMESTAMP), window),
            InputRef(s.index_of("price"), DataType.INT64)],
        names=["window_start", "price"],
        watermark_derivations=derivations)
    calls = [AggCall(AggKind.MAX, 1), AggCall(AggKind.COUNT)]
    agg_schema, agg_pk = agg_state_schema(project.schema, [0], calls)
    agg_state = StateTable(2, agg_schema, agg_pk, store,
                           dist_key_indices=[0])
    agg = HashAggExecutor(project, [0], calls, agg_state,
                          append_only=True,
                          output_names=["max_price", "bid_count"],
                          device=device)
    mv_table = StateTable(3, agg.schema, [0], store)  # pk = window_start
    mat = MaterializeExecutor(agg, mv_table)
    local.set_expected_actors([1])
    actor = Actor(1, mat, barrier_manager=local, fragment="nexmark-q7")
    return Pipeline(actor, BarrierLoop(local, store), mv_table,
                    {1: source.reader})


def drive_to_completion(pipeline: Pipeline, targets: Dict[int, int],
                        max_epochs: int = 500, in_flight: int = 2):
    """Async driver: barrier-tick until every reader hits its target
    offset, then a Stop barrier. Barriers are pipelined up to
    `in_flight`; recorded barrier latency is inject → commit and so
    includes queueing behind earlier in-flight barriers.

    Returns a coroutine giving (timed_elapsed_s, timed_rows), measured
    after a warmup epoch (whose latency is dropped from the stats)."""
    in_flight_w = max(1, in_flight)

    async def run():
        task = pipeline.actor.spawn()
        loop = pipeline.loop
        readers = pipeline.readers
        await loop.inject_and_collect()      # warmup epoch
        warm_rows = sum(r.offset for r in readers.values())
        warm_epochs = len(loop.stats.latencies_s)
        t0 = time.perf_counter()

        def done() -> bool:
            return all(readers[a].offset >= t for a, t in targets.items())

        injected = 0
        while not done():
            if injected >= max_epochs:
                raise RuntimeError(
                    f"sources stalled: "
                    f"{ {a: readers[a].offset for a in targets} } "
                    f"vs {targets}")
            while loop.in_flight_count < in_flight_w \
                    and injected < max_epochs:
                await loop.inject()
                injected += 1
            await loop.collect_next()
        while loop.in_flight_count:
            await loop.collect_next()
        elapsed = time.perf_counter() - t0
        timed_rows = sum(r.offset for r in readers.values()) - warm_rows
        await loop.inject_and_collect(
            mutation=StopMutation(frozenset(readers.keys())))
        await task
        if pipeline.actor.failure is not None:
            raise pipeline.actor.failure
        loop.stats.latencies_s = loop.stats.latencies_s[warm_epochs:]
        return elapsed, timed_rows

    return run()

