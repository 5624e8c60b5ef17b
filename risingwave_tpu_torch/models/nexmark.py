"""Hand-built Nexmark pipelines: q1 (a stateless projection), q7-core
(hash agg on the device) and q8 (windowed join on the device).

Port of ``build_q1`` (:109), ``build_q7`` (:134), ``build_q8`` (:208),
``_finish``'s fusion (:87) and ``drive_to_completion`` (:283) of
``risingwave_tpu/models/nexmark.py``:

    q1  Nexmark bid source → RowIdGen → project(auction, bidder,
        0.908 * price as DECIMAL, date_time, _row_id) → materialize
    q7  Nexmark bid source → [WatermarkFilter] → project(tumble_start(
        date_time, window), price) → HashAggExecutor(MAX(price),
        COUNT(*), append-only, device kernels) → materialize
    q8  person source → project(id, name, tumble_start) ─┐
        auction source → project(seller, tumble_start) →  ├→ inner
        HashAggExecutor COUNT dedup → project(seller,     │  HashJoin
        starttime) ───────────────────────────────────────┘  → project
        → materialize

driven by a ``BarrierLoop`` over ``MemoryStateStore``. With
``watermark_delay`` q7's agg retires closed windows on the device.
``device=None`` means the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions. ``fusion=True`` rewrites the plan with the fragment
fusion rule (``frontend/opt``), as the reference's ``_finish`` does:
q1's row-id generation and projection become one FusedFragmentExecutor
(``fused_chain``), q7's and q8's aggs absorb their tumble projections
(``agg_prelude``), and q8's join sides absorb theirs (``join_prelude``).
``build_q7(mesh=ShardMesh(n))`` runs q7's agg vnode-sharded over n
logical shards of one card (``parallel/agg.ShardedAggKernel``), and
``build_q8(mesh=ShardMesh(n))`` q8's join (``parallel/join.
ShardedJoinKernel``), each unfused or fused. ``build_q7(tier_cap=n)``
puts q7's agg under the cold tier (``state/tier.py``) on one device. The
reference's coalescing option is not ported and raises
NotImplementedError, as does a tier cap on a mesh.

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

from risingwave_tpu_torch.common.chunk import presize_cap, presize_flush_cap
from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.connectors.nexmark import (
    NexmarkConfig, NexmarkSplitReader,
)
from risingwave_tpu_torch.expr.expr import InputRef, lit, tumble_start
from risingwave_tpu_torch.meta.barrier import BarrierLoop
from risingwave_tpu_torch.ops.hash_agg import (  # noqa: F401 (re-export)
    AggKind, from_jax_state, to_numpy_state,
)
from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream.actor import Actor, LocalBarrierManager
from risingwave_tpu_torch.stream.exchange import channel_for_test
from risingwave_tpu_torch.stream.executors.hash_agg import (
    AggCall, HashAggExecutor, agg_state_schema,
)
from risingwave_tpu_torch.stream.executors.hash_join import HashJoinExecutor
from risingwave_tpu_torch.stream.executors.keys import LANES_PER_KEY
from risingwave_tpu_torch.stream.executors.materialize import (
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.executors.row_id_gen import RowIdGenExecutor
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


def _finish(local: LocalBarrierManager, store, mat: MaterializeExecutor,
            mv_table: StateTable, actor_id: int,
            readers: Dict[int, NexmarkSplitReader], fragment: str,
            fusion: bool, device) -> Pipeline:
    if fusion:
        # the same rule and checker the reference's SQL sessions apply
        # under SET stream_fusion
        from risingwave_tpu_torch.frontend.opt import rewrite_stream_plan
        mat, _report = rewrite_stream_plan(mat, "none", fusion=True,
                                           device=device)
    local.set_expected_actors([actor_id])
    actor = Actor(actor_id, mat, barrier_manager=local, fragment=fragment)
    return Pipeline(actor, BarrierLoop(local, store), mv_table, readers)


def _check_store(store) -> None:
    if not isinstance(store, MemoryStateStore):
        raise NotImplementedError(
            "only MemoryStateStore is ported (no hummock store yet)")


def build_q1(store, cfg: NexmarkConfig,
             rate_limit: Optional[int] = 3,
             min_chunks: Optional[int] = None,
             fusion: bool = False, device=None) -> Pipeline:
    """q1: SELECT auction, bidder, 0.908 * price, date_time FROM bid, with
    a generated ``_row_id`` as the MV's pk."""
    _check_store(store)
    device = resolve_device(device)
    local = LocalBarrierManager()
    source = _source(local, store, 1, cfg, 1, rate_limit, min_chunks)
    row_id = RowIdGenExecutor(source)
    s = row_id.schema
    project = ProjectExecutor(
        row_id,
        exprs=[InputRef(s.index_of("auction"), DataType.INT64),
               InputRef(s.index_of("bidder"), DataType.INT64),
               lit("0.908", DataType.DECIMAL)
               * InputRef(s.index_of("price"), DataType.INT64),
               InputRef(s.index_of("date_time"), DataType.TIMESTAMP),
               InputRef(s.index_of("_row_id"), DataType.SERIAL)],
        names=["auction", "bidder", "price", "date_time", "_row_id"])
    mv_table = StateTable(2, project.schema, [4], store)  # pk = _row_id
    mat = MaterializeExecutor(project, mv_table)
    return _finish(local, store, mat, mv_table, 1, {1: source.reader},
                   "nexmark-q1", fusion, device)


def build_q7(store, cfg: NexmarkConfig,
             rate_limit: Optional[int] = 4,
             window: Interval = DEFAULT_WINDOW,
             min_chunks: Optional[int] = None,
             watermark_delay: Optional[Interval] = None,
             mesh: Optional[ShardMesh] = None,
             shard_capacity: int = 1 << 14,
             coalesce_rows: Optional[int] = None,
             tier_cap: Optional[int] = None,
             fusion: bool = False,
             device=None) -> Pipeline:
    """q7-core: MAX(price), COUNT(*) per tumbling window (device agg).

    With ``watermark_delay``, a WatermarkFilter generates event-time
    watermarks on date_time; the projection derives a window_start
    watermark through tumble_start, and the agg retires closed windows
    (bounded state).

    With ``mesh`` (a ``ShardMesh`` on the pipeline's device), the agg runs
    vnode-sharded over its shards, ``shard_capacity`` slots each: the
    reference's hash dispatch to N parallel actors (dispatch.rs:582)
    becomes one routing kernel per step.

    With ``tier_cap`` (one device only), the agg keeps at most about that
    many groups on the card after each checkpoint barrier: older groups
    are evicted and reload when a later chunk touches them."""
    if coalesce_rows:
        raise NotImplementedError("build_q7 coalesce_rows is not ported")
    if tier_cap is not None and mesh is not None:
        raise NotImplementedError(
            "build_q7 tier_cap with a mesh: the sharded kernel has no "
            "targeted eviction (the reference drops the cap there)")
    _check_store(store)
    device = resolve_device(device)
    if mesh is not None:
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"build_q7 takes a ShardMesh, got {mesh!r}")
        if mesh.device != device:
            raise ValueError(f"the mesh is on {mesh.device}, the pipeline "
                             f"on {device}")
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
    kernel = None
    if mesh is not None:
        kernel = ShardedAggKernel(
            mesh, key_width=LANES_PER_KEY * 1,
            specs=[c.spec(project.schema) for c in calls],
            capacity=shard_capacity)
    # tier_cap: a resident-group cap on the agg (state/tier.py)
    agg = HashAggExecutor(project, [0], calls, agg_state,
                          append_only=True,
                          output_names=["max_price", "bid_count"],
                          kernel=kernel, tier_cap=tier_cap, device=device)
    mv_table = StateTable(3, agg.schema, [0], store)  # pk = window_start
    mat = MaterializeExecutor(agg, mv_table)
    return _finish(local, store, mat, mv_table, 1, {1: source.reader},
                   "nexmark-q7", fusion, device)


def build_q8(store, cfg_p: NexmarkConfig, cfg_a: NexmarkConfig,
             rate_limit: Optional[int] = 4,
             window: Interval = DEFAULT_WINDOW,
             min_chunks: Optional[int] = None, mesh=None,
             fusion: bool = False, device=None) -> Pipeline:
    """q8: persons who created an auction in the same tumbling window.

    Two sources → projects → auction-side hash-agg dedup → inner
    HashJoin (device matcher) → project → materialize. Capacities are
    presized from the known Nexmark cardinalities, as the reference
    does.

    With ``mesh`` (a ``ShardMesh`` on the pipeline's device), the join
    runs on the vnode-sharded matcher (``parallel/join.
    ShardedJoinKernel``) at its default capacities, as the reference's
    does: both sides' rows route to their key's owner shard, the
    reference's hash dispatch to N parallel join actors
    (dispatch.rs:582)."""
    _check_store(store)
    device = resolve_device(device)
    if mesh is not None:
        if not isinstance(mesh, ShardMesh):
            raise TypeError(f"build_q8 takes a ShardMesh, got {mesh!r}")
        if mesh.device != device:
            raise ValueError(f"the mesh is on {mesh.device}, the pipeline "
                             f"on {device}")
    local = LocalBarrierManager()
    persons = _source(local, store, 1, cfg_p, 1, rate_limit, min_chunks)
    ps = persons.schema
    p_proj = ProjectExecutor(
        persons,
        exprs=[InputRef(ps.index_of("id"), DataType.INT64),
               InputRef(ps.index_of("name"), DataType.VARCHAR),
               tumble_start(InputRef(ps.index_of("date_time"),
                                     DataType.TIMESTAMP), window)],
        names=["id", "name", "starttime"])
    auctions = _source(local, store, 2, cfg_a, 2, rate_limit, min_chunks)
    asch = auctions.schema
    a_proj = ProjectExecutor(
        auctions,
        exprs=[InputRef(asch.index_of("seller"), DataType.INT64),
               tumble_start(InputRef(asch.index_of("date_time"),
                                     DataType.TIMESTAMP), window)],
        names=["seller", "starttime"])
    calls = [AggCall(AggKind.COUNT)]
    agg_sch, agg_pk = agg_state_schema(a_proj.schema, [0, 1], calls)
    n_p = max(cfg_p.event_num // 50, 1)
    n_a = max(cfg_a.event_num * 3 // 50, 1)
    a_dedup = HashAggExecutor(
        a_proj, [0, 1], calls,
        StateTable(3, agg_sch, agg_pk, store, dist_key_indices=[0]),
        append_only=True, output_names=["seller", "starttime", "_cnt"],
        kernel_capacity=presize_cap(n_a, 1 << 18),
        flush_capacity=presize_flush_cap(n_a), device=device)
    a_dedup_proj = ProjectExecutor(
        a_dedup,
        exprs=[InputRef(0, DataType.INT64),
               InputRef(1, DataType.TIMESTAMP)],
        names=["seller", "starttime"])
    lt = StateTable(4, p_proj.schema, [0, 2], store, dist_key_indices=[0])
    rt = StateTable(5, a_dedup_proj.schema, [0, 1], store,
                    dist_key_indices=[0])
    join_opts = None if mesh is not None else {
        "key_capacity": presize_cap(max(n_p, n_a)),
        "row_capacity": presize_cap(max(n_p, n_a)),
        "probe_capacity": 1 << 16,
    }
    join = HashJoinExecutor(p_proj, a_dedup_proj,
                            left_keys=[0, 2], right_keys=[0, 1],
                            left_table=lt, right_table=rt, mesh=mesh,
                            shard_opts=join_opts, device=device)
    out = ProjectExecutor(
        join,
        exprs=[InputRef(0, DataType.INT64),
               InputRef(1, DataType.VARCHAR),
               InputRef(2, DataType.TIMESTAMP)],
        names=["id", "name", "starttime"])
    mv = StateTable(6, out.schema, [0, 2], store)
    mat = MaterializeExecutor(out, mv)
    return _finish(local, store, mat, mv, 7,
                   {1: persons.reader, 2: auctions.reader}, "nexmark-q8",
                   fusion, device)


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

