"""Planner: bound SELECT → streaming executor chain or batch tree.

Reference parity: src/frontend/src/planner/ + optimizer/mod.rs:346
(gen_stream_plan) + the fragmenter — collapsed: the supported SQL
surface maps directly onto executor chains (source → [tumble-project]
→ [filter] → [join] → [pre-agg project → hash-agg] → project →
materialize), so the logical/physical split and exchange insertion are
not yet needed (single-fragment plans; the dispatch layer exists under
stream/ for when the fragmenter lands).

Supported streaming shapes: MV over one source (optionally TUMBLE) or
over another MV (backfill chain), WHERE conjuncts as filters over the
join chain (the frontend/opt filter_pushdown rule sinks them below
joins, gated by join kind), multi-way left-deep
INNER/LEFT/RIGHT/FULL joins of sources on equi-keys, GROUP BY with
count/sum/min/max/avg (+DISTINCT) over arbitrary expressions, ORDER
BY/LIMIT TopN, EXPLAIN. Batch: scan/filter/project/agg/join/order/
limit over committed MV snapshots.

Port of ``risingwave_tpu/frontend/planner.py`` for one device: the same
plans, executor for executor and state table for state table, with the
catalog ids handed out in the reference's order (the id-base contract:
state tables are compared by id). Every keyed executor the planner
builds, and every fused block the rewrite makes, runs on the planner's
``device`` (None: the card). With a ``mesh`` (a ``ShardMesh`` of logical
shards on that device) every GROUP BY runs on a ``ShardedAggKernel`` and
every stream join on the ``ShardedJoinKernel`` (the reference's device
mesh); the mesh branches allocate no catalog id, so a plan's ids do not
depend on its parallelism. MV on MV attaches a chain edge to the
upstream MV's actor (``_chain_upstream_mv``) that the session wires in
only after the whole plan validated; the temporal join probes such a
chain as of process time. Left to later items, each refused with
``NotImplementedError`` naming it: the distributed plan
(``dist_parallelism``, ``ROADMAP.md`` item 10d), the inlined view
expansion of the distributed session (``inline_mvs``), the segmented
filelog reader and sinks (item 13), and the system tables of unported
subsystems (items 11-13).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.expr.expr import Expression, InputRef, tumble_start
from risingwave_tpu_torch.frontend import ast
from risingwave_tpu_torch.frontend.binder import (
    BindError, Binder, Scope, expr_name,
)
from risingwave_tpu_torch.frontend.catalog import Catalog, MvCatalog, SourceCatalog
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.executors.hash_agg import (
    AggCall, HashAggExecutor, agg_state_schema,
)
from risingwave_tpu_torch.stream.executors.hash_join import (
    HashJoinExecutor, JoinType,
)
from risingwave_tpu_torch.stream.executors.materialize import MaterializeExecutor
from risingwave_tpu_torch.stream.executors.row_id_gen import RowIdGenExecutor
from risingwave_tpu_torch.stream.executors.simple import (
    FilterExecutor, ProjectExecutor,
)
from risingwave_tpu_torch.stream.executors.source import SourceExecutor
from risingwave_tpu_torch.utils.device import resolve_device

SPLIT_STATE_SCHEMA = Schema([Field("split_id", DataType.VARCHAR),
                             Field("offset", DataType.INT64)])


class PlanError(ValueError):
    pass


def not_ported(what: str, item: str) -> NotImplementedError:
    """The refusal of a statement or option that a later item ports."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item {item})")


@dataclass
class StreamPlan:
    """Everything the session needs to deploy one MV pipeline."""

    consumer: MaterializeExecutor
    mv: MvCatalog
    readers: Dict[int, object]          # actor_id → split reader
    # MV-on-MV chain edges: (upstream actor id, Output) to attach at
    # deploy (NOT at plan time — a failed plan must leak nothing)
    attaches: List[tuple] = field(default_factory=list)


def _source_reader(src: SourceCatalog):
    opts = src.options
    connector = opts.get("connector", "").lower()
    if connector == "nexmark":
        from risingwave_tpu_torch.connectors.nexmark import (
            NexmarkConfig, NexmarkSplitReader,
        )
        cfg = NexmarkConfig(
            table_type=opts.get("nexmark.table.type", "bid"),
            event_num=int(opts.get("nexmark.event.num", 1 << 62)),
            max_chunk_size=int(opts.get("nexmark.max.chunk.size", 1024)),
            min_event_gap_in_ns=int(
                opts.get("nexmark.min.event.gap.in.ns", 100_000)),
            seed=int(opts.get("nexmark.seed", 0x5EED0)),
            generate_strings=str(opts.get(
                "nexmark.generate.strings", "true")).lower()
            not in ("false", "0"),
        )
        return NexmarkSplitReader(cfg)
    if connector == "datagen":
        from risingwave_tpu_torch.connectors.datagen import (
            DatagenConfig, DatagenSplitReader,
        )
        return DatagenSplitReader(DatagenConfig.from_options(opts))
    if connector == "filelog":
        from risingwave_tpu_torch.connectors.filelog import (
            FileLogEnumerator, FileLogSplitReader,
        )
        path = opts.get("path")
        topic = opts.get("topic", src.name)
        if not path:
            raise PlanError("filelog source needs path='...'")
        part = int(opts.get("partition", 0))
        if opts.get("segmented", "").lower() in ("true", "1"):
            # a filelog SINK's output: sinks are item 13
            raise not_ported("segmented='true' (the filelog sink's "
                             "segmented reader)", "13")
        if "partitions" in opts:
            # explicit split subset (the scheduler stamps each source
            # actor's assignment here — the split-rebalancing
            # contract); "" is a legal EMPTY assignment: scale-out
            # past the partition count leaves idle source actors
            from risingwave_tpu_torch.connectors.filelog import (
                FileLogMultiReader,
            )
            spec = str(opts["partitions"]).strip()
            parts = [int(p) for p in spec.split(",") if p != ""]
            return FileLogMultiReader(
                path, topic, parts, src.schema,
                fmt=opts.get("format", "json"),
                max_chunk_size=int(opts.get("max.chunk.size", 1024)),
                options=opts)
        splits = FileLogEnumerator(path, topic).list_splits()
        # bare single-pipeline sources: one reader drives partition 0
        # (the distributed scheduler assigns explicit partition sets)
        if splits and not any(
                int(s.split_id.rsplit("-", 1)[1]) == part
                for s in splits):
            raise PlanError(
                f"filelog partition {part} not found in {path!r}")
        return FileLogSplitReader(
            path, topic, part, src.schema,
            fmt=opts.get("format", "json"),
            max_chunk_size=int(opts.get("max.chunk.size", 1024)),
            options=opts)
    if connector == "tpch":
        from risingwave_tpu_torch.connectors.tpch import (
            TpchConfig, TpchSplitReader,
        )
        return TpchSplitReader(TpchConfig(
            table=opts.get("tpch.table", "lineitem"),
            customers=int(opts.get("tpch.customers", 1500)),
            orders=int(opts.get("tpch.orders", 15000)),
            max_chunk_size=int(opts.get("tpch.max.chunk.size", 1024)),
        ))
    raise PlanError(f"unknown connector {connector!r}")


def source_schema(options: Dict[str, str],
                  columns=None) -> Schema:
    connector = options.get("connector", "").lower()
    if columns is not None:
        fields = []
        for name, type_name in columns:
            try:
                fields.append(Field(name, DataType.from_sql(type_name)))
            except KeyError:
                raise PlanError(f"unknown type {type_name!r}")
        return Schema(fields)
    if connector == "nexmark":
        from risingwave_tpu_torch.connectors.nexmark import TABLE_SCHEMAS
        return TABLE_SCHEMAS[options.get("nexmark.table.type", "bid")]
    if connector == "datagen":
        from risingwave_tpu_torch.connectors.datagen import DatagenConfig
        return DatagenConfig.from_options(options).schema
    if connector == "tpch":
        from risingwave_tpu_torch.connectors.tpch import TABLE_SCHEMAS
        return TABLE_SCHEMAS[options.get("tpch.table", "lineitem")]
    if connector == "filelog":
        raise PlanError(
            "filelog sources need an explicit column list: "
            "CREATE SOURCE t (a INT, ...) WITH (...)")
    raise PlanError(f"unknown connector {connector!r}")


class StreamPlanner:
    """Plans one CREATE MATERIALIZED VIEW into an executor chain."""

    def __init__(self, catalog: Catalog, store, local, definition: str,
                 mesh=None, actors=None, dist_parallelism: int = 1,
                 join_state_cap=None, inline_mvs=None,
                 chunk_target_rows: Optional[int] = None,
                 coalesce_linger_chunks: Optional[int] = None,
                 state_tier_cap: Optional[int] = None, device=None):
        from risingwave_tpu_torch.stream.coalesce import (
            DEFAULT_MAX_CHUNKS, DEFAULT_TARGET_ROWS,
        )
        if max(1, dist_parallelism) != 1:
            # the local/global agg split and the fragmenter's cut
            raise not_ported("dist_parallelism > 1 (the distributed "
                             "plan)", "10d")
        if inline_mvs:
            # the distributed session's view expansion
            raise not_ported("inline_mvs (MV on MV inlined)", "13")
        self.catalog = catalog
        self.store = store
        # adaptive coalescing in front of keyed executors (session var
        # stream_chunk_target_rows; 0 disables — the oracle-equivalence
        # tests compare on vs off)
        self.chunk_target_rows = DEFAULT_TARGET_ROWS \
            if chunk_target_rows is None else chunk_target_rows
        self.coalesce_linger_chunks = DEFAULT_MAX_CHUNKS \
            if coalesce_linger_chunks is None else coalesce_linger_chunks
        self.local = local           # LocalBarrierManager
        self.definition = definition
        # every keyed executor of the plan runs here (None: the card)
        self.device = resolve_device(device)
        # non-None ⇒ sharded GROUP BY and join plans over its shards
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh is on {mesh.device}, the plan on "
                             f"{self.device}")
        self.mesh = mesh
        # resident-row cap per join side: INNER joins get the
        # cold-state tier (evict to the state table, reload on probe
        # miss — managed_state/join/mod.rs:379-420)
        self.join_state_cap = join_state_cap
        # unified state-tiering cap (SET state_tier_cap, state/tier.py):
        # resident-key cap per stateful executor cache — applies to
        # hash-agg groups AND join sides (where it takes precedence
        # over the legacy join_state_cap)
        self.state_tier_cap = state_tier_cap
        self.actors = actors or {}   # actor_id → Actor (MV-on-MV attach)
        self.readers: Dict[int, object] = {}
        # chain edges produced by _chain_upstream_mv, attached by the
        # session once the WHOLE plan has validated
        self.pending_attaches: List[tuple] = []
        self.registered_senders: List[int] = []   # cleanup on failure
        self._actor_id = 0           # the MV's actor id (Output tag)

    def _coalesced(self, ex: Executor) -> Executor:
        """Adaptive coalescing in front of a keyed executor's input:
        every device dispatch then carries a dense target-sized batch
        instead of per-upstream-chunk slivers (stream/coalesce.py).
        Disabled when stream_chunk_target_rows = 0."""
        if not self.chunk_target_rows or self.chunk_target_rows <= 0:
            return ex
        from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
        return CoalesceExecutor(ex, self.chunk_target_rows,
                                self.coalesce_linger_chunks)

    # -- source chains ---------------------------------------------------
    def _base_chain(self, item, rate_limit: Optional[int],
                    min_chunks: Optional[int]
                    ) -> Tuple[Executor, Scope, List[str]]:
        """FROM item → executor + scope (+ dependent source names)."""
        from risingwave_tpu_torch.stream.exchange import channel_for_test

        if isinstance(item, ast.Subquery):
            return self._plan_derived(item.select, item.alias,
                                      rate_limit, min_chunks)
        if isinstance(item, (ast.Tumble, ast.Hop)):
            ref, alias = item.table, item.alias or item.table.name
        elif isinstance(item, ast.TableRef):
            ref, alias = item, item.alias or item.name
        else:
            raise PlanError(f"unsupported FROM item {item!r}")
        obj = self.catalog.resolve(ref.name)
        if isinstance(obj, MvCatalog):
            if isinstance(item, (ast.Tumble, ast.Hop)):
                raise PlanError(
                    "TUMBLE/HOP over an MV not supported yet")
            ex, scope = self._chain_upstream_mv(obj, alias)
            return ex, scope, [obj.name]
        assert isinstance(obj, SourceCatalog)
        reader = _source_reader(obj)
        tx, rx = channel_for_test()
        split_state = StateTable(self.catalog.next_id(),
                                 SPLIT_STATE_SCHEMA, [0], self.store)
        # source sender id: unique per source instance (shares the
        # catalog id space; the barrier manager only needs uniqueness)
        sid = self.catalog.next_id()
        self.local.register_sender(sid, tx)
        self.registered_senders.append(sid)
        ex: Executor = SourceExecutor(
            reader, rx, split_state, actor_id=sid,
            rate_limit_chunks_per_barrier=rate_limit,
            min_chunks_per_barrier=min_chunks)
        self.readers[sid] = reader
        scope = Scope.of(obj.schema, alias)
        # event-time watermarks from SQL: WITH (watermark.column='ts',
        # watermark.delay='4 seconds') — the WATERMARK FOR clause's
        # role (source/watermark.rs), driving state cleaning and EOWC
        wm_col_name = obj.options.get("watermark.column")
        wm_idx = None
        self._wm_scope_cols = set()
        if wm_col_name:
            from risingwave_tpu_torch.stream.executors.watermark_filter \
                import WATERMARK_STATE_SCHEMA, WatermarkFilterExecutor
            wm_idx, wdt = scope.find(wm_col_name, None)
            if wdt not in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
                raise PlanError(
                    "watermark.column must be a timestamp")
            delay = _parse_interval_opt(
                obj.options.get("watermark.delay", "0 seconds"))
            wm_state = StateTable(self.catalog.next_id(),
                                  WATERMARK_STATE_SCHEMA, [0],
                                  self.store)
            ex = WatermarkFilterExecutor(ex, wm_idx, delay, wm_state)
            self._wm_scope_cols.add(wm_idx)
        if isinstance(item, ast.Tumble):
            idx, dt = scope.find(item.time_col, None)
            if dt not in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
                raise PlanError("TUMBLE time column must be a timestamp")
            exprs = [InputRef(i, f.data_type)
                     for i, f in enumerate(scope.schema)]
            names = [f.name for f in scope.schema]
            exprs.append(tumble_start(InputRef(idx, dt),
                                      Interval(usecs=item.window_usecs)))
            names.append("window_start")
            derivs = {}
            if wm_idx is not None:
                # identity for the raw column AND (when it is the
                # tumble column) the floored window_start image — one
                # input watermark derives both outputs
                derivs[wm_idx] = [wm_idx]
                if wm_idx == idx:
                    w = item.window_usecs
                    derivs[idx].append(
                        (len(exprs) - 1,
                         (lambda v, _w=w: v - v % _w)))
                    self._wm_scope_cols.add(len(exprs) - 1)
            ex = ProjectExecutor(ex, exprs, names,
                                 watermark_derivations=derivs)
            scope = Scope(ex.schema,
                          scope.qualifiers + [alias])
        elif isinstance(item, ast.Hop):
            from risingwave_tpu_torch.stream.executors.hop_window import (
                HopWindowExecutor,
            )
            idx, dt = scope.find(item.time_col, None)
            if dt not in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
                raise PlanError("HOP time column must be a timestamp")
            ex = HopWindowExecutor(
                ex, idx, Interval(usecs=item.slide_usecs),
                Interval(usecs=item.size_usecs))
            # schema gains window_start/window_end, same qualifier
            scope = Scope(ex.schema,
                          scope.qualifiers + [alias, alias])
        return ex, scope, [obj.name]

    def _plan_derived(self, sel, alias, rate_limit, min_chunks):
        """Derived table: plan an inner SELECT as this fragment's
        upstream chain (binder/bind_query subquery analog — shared by
        FROM-subqueries and inlined views). Hidden pk columns stay in
        the executor schema but out of the visible scope; the derived
        pk is STAMPED onto the executor so a consumer join keys its
        state by it — fresh row ids instead would orphan every U-
        retraction half and leave stale rows in join state."""
        from risingwave_tpu_torch.stream.executor import ExecutorInfo

        ex, pk, deps, n_vis = self._plan_query(
            sel, self._actor_id, rate_limit, min_chunks)
        ex._info = ExecutorInfo(ex.schema, list(pk), ex.identity)
        self._wm_scope_cols = set()   # wm feed unproven through
        self._eowc_wm_col = None      # inner value is meaningless
        #                               against the OUTER schema
        vis = Schema(list(ex.schema)[:n_vis])
        return ex, Scope(vis, [alias] * n_vis), deps

    def _chain_upstream_mv(self, mv: MvCatalog, alias: str):
        """FROM <mv>: attach a new output to the upstream MV's actor
        (chain.rs:28) and backfill its committed snapshot
        (no_shuffle_backfill.rs:68). The attach happens under the
        session's barrier lock — the pipeline is quiescent between
        barrier rounds, so mutating the dispatcher's output set is the
        Mutation::Add analog without the RPC hop."""
        from risingwave_tpu_torch.stream.dispatch import Output
        from risingwave_tpu_torch.stream.exchange import channel_for_test
        from risingwave_tpu_torch.stream.executor import ExecutorInfo
        from risingwave_tpu_torch.stream.executors.backfill import (
            PROGRESS_SCHEMA, BackfillExecutor,
        )
        from risingwave_tpu_torch.stream.executors.simple import (
            ReceiverExecutor,
        )

        upstream = self.actors.get(mv.actor_id)
        if upstream is None or not upstream.dispatchers:
            raise PlanError(
                f"upstream MV {mv.name!r} has no attachable actor")
        tx, rx = channel_for_test()
        # deferred: the session attaches AFTER the whole plan validates
        # (a failed CREATE must not leave an orphan output that blocks
        # the upstream on exhausted permits), tagged with the DOWNSTREAM
        # actor id so drops can detach exactly this edge
        self.pending_attaches.append(
            (mv.actor_id, Output(self._actor_id, tx)))
        recv = ReceiverExecutor(
            ExecutorInfo(mv.schema, list(mv.pk_indices),
                         f"Chain({mv.name})"), rx)
        mv_read = StateTable(mv.table_id, mv.schema, mv.pk_indices,
                             self.store)
        progress = StateTable(self.catalog.next_id(), PROGRESS_SCHEMA,
                              [0], self.store)
        ex = BackfillExecutor(recv, mv_read, progress,
                              identity=f"Backfill({mv.name})")
        # the backfill snapshot replays the MV's TABLE as inserts and
        # the live tail is the MV's changelog — the chain is
        # append-only exactly when the MV's own changelog is
        # (_derive_append_only reads this hint at the chain boundary)
        ex.append_only_hint = mv.append_only
        # expose only the MV's user-facing columns (hidden _row_id /
        # group-key plumbing stays out of downstream scopes)
        return ex, Scope.of(mv.visible_schema, alias)

    # -- the main plan ---------------------------------------------------
    def plan(self, name: str, sel: ast.Select, actor_id: int,
             rate_limit: Optional[int] = 8,
             min_chunks: Optional[int] = None,
             emit_on_window_close: bool = False) -> StreamPlan:
        self._actor_id = actor_id
        self._eowc_wm_col = None
        ex, pk, deps, nvis = self._plan_query(sel, actor_id,
                                              rate_limit, min_chunks)
        if emit_on_window_close:
            # gate results behind the window watermark (sort_buffer.rs
            # / AggGroup::create_eowc semantics as a downstream gate)
            from risingwave_tpu_torch.stream.executors.eowc import (
                EowcGateExecutor,
            )
            wm_col = self._eowc_wm_col
            if wm_col is None:
                raise PlanError(
                    "EMIT ON WINDOW CLOSE needs a windowed GROUP BY "
                    "whose first group key is projected and carries a "
                    "watermark (e.g. TUMBLE window_start)")
            gate_pk = [wm_col] + [p for p in pk if p != wm_col]
            gate_state = StateTable(self.catalog.next_id(), ex.schema,
                                    gate_pk, self.store)
            ex = EowcGateExecutor(ex, wm_col, gate_state,
                                  actor_id=actor_id)
        mv_table = StateTable(self.catalog.next_id(), ex.schema, pk,
                              self.store)
        mat = MaterializeExecutor(ex, mv_table)
        mv = MvCatalog(name, mv_table.table_id, ex.schema, pk,
                       self.definition, actor_id, deps,
                       n_visible=nvis if nvis < len(ex.schema) else None,
                       append_only=self._derive_append_only(ex))
        return StreamPlan(mat, mv, self.readers, self.pending_attaches)

    def _plan_query(self, sel: ast.Select, actor_id: int,
                    rate_limit: Optional[int],
                    min_chunks: Optional[int]):
        if sel.from_item is None:
            raise PlanError("a streaming job needs a FROM clause")
        ex, scope, deps = self._base_chain(sel.from_item,
                                           rate_limit, min_chunks)
        join_pk_cols: Optional[List[int]] = None
        conjuncts = _flatten_and(sel.where) if sel.where is not None \
            else []
        if sel.joins:
            # Optimizer v0 (multi-way planning, collapsed): a
            # left-deep chain of HashJoins in syntax order. WHERE
            # conjuncts bind AFTER the chain against the full scope
            # (ambiguous unqualified columns raise properly) and land
            # as filters ABOVE the joins; the filter_pushdown rewrite
            # rule (frontend/opt/rules.py) then sinks each one below
            # every side its join never null-pads.
            left, lscope = self._joinable(ex, scope)
            rights = []
            for jn in sel.joins:
                rex, rscope, rdeps = self._base_chain(
                    jn.item, rate_limit, min_chunks)
                deps += rdeps
                if getattr(jn, "temporal", False):
                    # temporal join: the right side IS a versioned
                    # table (MV chain with a pk) probed as-of process
                    # time — no row-id wrapping, no join state
                    if not rex.pk_indices:
                        raise PlanError(
                            "temporal join (FOR SYSTEM_TIME AS OF "
                            "PROCTIME()) needs a materialized view "
                            "on the right side")
                    if jn.kind not in ("inner", "left"):
                        raise PlanError(
                            "temporal join supports INNER and LEFT "
                            "only")
                    rights.append((jn, rex, rscope))
                    continue
                right, rscope = self._joinable(rex, rscope)
                rights.append((jn, right, rscope))
            for jn, right, rscope in rights:
                if getattr(jn, "temporal", False):
                    from risingwave_tpu_torch.stream.executors.temporal_join \
                        import TemporalJoinExecutor
                    lkeys, rkeys = _equi_keys(jn.on, lscope, rscope)
                    if sorted(rkeys) != sorted(right.pk_indices):
                        raise PlanError(
                            "temporal join ON keys must equal the "
                            "right table's primary key")
                    if not self._derive_append_only(left):
                        raise PlanError(
                            "temporal join left input must be "
                            "append-only")
                    left = TemporalJoinExecutor(
                        left, right, lkeys, rkeys,
                        outer=(jn.kind == "left"),
                        actor_id=actor_id)
                    lscope = lscope.concat(rscope)
                    continue
                lkeys, rkeys = _equi_keys(jn.on, lscope, rscope)
                jt = {"inner": JoinType.INNER,
                      "left": JoinType.LEFT_OUTER,
                      "right": JoinType.RIGHT_OUTER,
                      "full": JoinType.FULL_OUTER}[jn.kind]
                # cold-tier eligibility: INNER or OUTER (outer-side
                # degrees recompute on reload — semi/anti transition
                # history cannot be evicted) + single-chip AND both
                # inputs PROVABLY append-only — a retraction for an
                # evicted key cannot be applied against device state
                # (a silent skip would leave
                # already-emitted join outputs permanently stale), so
                # a retracting input runs uncapped instead
                tierable = (jt in (JoinType.INNER, JoinType.LEFT_OUTER,
                                   JoinType.RIGHT_OUTER,
                                   JoinType.FULL_OUTER)
                            and self.mesh is None
                            and self._derive_append_only(left)
                            and self._derive_append_only(right))
                cap = (self.state_tier_cap or self.join_state_cap) \
                    if tierable else None
                if cap is not None:
                    # cold tier: state-table pks lead with the join
                    # keys so evicted keys reload by prefix scan
                    lpk = lkeys + [p for p in left.pk_indices
                                   if p not in lkeys]
                    rpk = rkeys + [p for p in right.pk_indices
                                   if p not in rkeys]
                    lt = StateTable(self.catalog.next_id(),
                                    left.schema, lpk, self.store,
                                    dist_key_indices=lkeys)
                    rt = StateTable(self.catalog.next_id(),
                                    right.schema, rpk, self.store,
                                    dist_key_indices=rkeys)
                else:
                    lt = StateTable(self.catalog.next_id(), left.schema,
                                    list(left.pk_indices), self.store,
                                    dist_key_indices=None)
                    rt = StateTable(self.catalog.next_id(), right.schema,
                                    list(right.pk_indices), self.store)
                # parallel plan: the hash exchange feeding N parallel
                # join actors (dispatch.rs:582) is the sharded kernel's
                # routing — same wiring as the agg path
                left = HashJoinExecutor(self._coalesced(left),
                                        self._coalesced(right),
                                        lkeys, rkeys, lt,
                                        rt, actor_id=actor_id,
                                        join_type=jt, mesh=self.mesh,
                                        state_cap=cap,
                                        device=self.device)
                lscope = lscope.concat(rscope)
            ex = left
            scope = lscope
            join_pk_cols = list(ex.pk_indices)
            # join output watermark indices are combined/re-based; the
            # EOWC feed proof does not track through joins yet
            self._wm_scope_cols = set()
        for c in conjuncts:
            ex = FilterExecutor(ex, Binder(scope).bind(c))
        projections = _expand_star(sel.projections, scope)
        if any(isinstance(e, ast.Call)
               and e.name in ("generate_series", "unnest")
               for e, _a in projections):
            return self._plan_project_set(ex, scope, sel, projections,
                                          deps)
        from risingwave_tpu_torch.frontend.binder import contains_agg
        binder = Binder(scope, allow_aggs=True)
        names = [a or expr_name(e, f"col{i}")
                 for i, (e, a) in enumerate(projections)]
        has_agg = (bool(sel.group_by) or sel.having is not None
                   or any(contains_agg(e) for e, _a in projections))
        if has_agg:
            if any(isinstance(e, ast.Over) for e, _a in projections):
                raise PlanError("window functions cannot be mixed "
                                "with GROUP BY / aggregates (yet)")
            ex, out_exprs, having_pred = self._plan_agg(
                ex, scope, sel, binder, projections)
            # MV/stream key = the FULL group-key set. Unprojected group
            # keys ride along as hidden trailing columns (nexmark q4's
            # inner query groups by (id, category) but projects only
            # category — without the hidden id the change stream would
            # collide distinct groups). Global aggs carry ONE synthetic
            # constant key (set by _plan_agg).
            g = self._agg_group_arity
            proj_of_group: Dict[int, int] = {}
            for pos, e in enumerate(out_exprs):
                if isinstance(e, InputRef) and e.index < g \
                        and e.index not in proj_of_group:
                    proj_of_group[e.index] = pos
            for gi in range(g):
                if gi not in proj_of_group:
                    proj_of_group[gi] = len(out_exprs)
                    out_exprs.append(
                        InputRef(gi, ex.schema[gi].data_type))
                    names.append(f"_g{gi}")
            pk = [proj_of_group[gi] for gi in range(g)]
            # plain group-key outputs carry the agg's watermarks (the
            # EOWC gate and downstream window ops depend on them)
            derivs = {e.index: j for j, e in enumerate(out_exprs)
                      if isinstance(e, InputRef)}
            if having_pred is not None:
                # HAVING filters the agg's change stream BEFORE the
                # output projection (logical_agg.rs plans it as a
                # LogicalFilter over the agg)
                ex = FilterExecutor(ex, having_pred)
            ex = ProjectExecutor(ex, out_exprs, names,
                                 watermark_derivations=derivs)
            # EOWC window column: the first group key that PROVABLY
            # carries a watermark all the way from the source (a gate
            # with no watermark feed would hold results forever)
            self._eowc_wm_col = next(
                (derivs[pos] for pos in self._agg_wm_positions
                 if pos in derivs), None)
        else:
            bound = [binder.bind_projection(e) for e, _a in projections]
            if binder.window_calls:
                ex, bound = self._plan_over_window(ex, binder, bound)
            exprs = list(bound)
            base_pk = list(ex.pk_indices)
            if join_pk_cols is not None:
                pk = list(range(len(exprs),
                                len(exprs) + len(join_pk_cols)))
                exprs += [InputRef(c, scope.schema[c].data_type)
                          for c in join_pk_cols]
                names += [f"_row_id_{j}"
                          for j in range(len(join_pk_cols))]
                ex = ProjectExecutor(ex, exprs, names)
            elif base_pk:
                # pk-keyed upstream (MV chain): carry its pk through as
                # hidden columns — a generated row id would turn every
                # upstream update pair into a fresh row (duplicates)
                pk = list(range(len(exprs), len(exprs) + len(base_pk)))
                # ex.schema, not scope.schema: the chain may have grown
                # columns past the bind scope (row-id gen, window cols)
                exprs += [InputRef(c, ex.schema[c].data_type)
                          for c in base_pk]
                names += [f"_pk{j}" for j in range(len(base_pk))]
                ex = ProjectExecutor(ex, exprs, names)
            else:
                ex = RowIdGenExecutor(ProjectExecutor(ex, exprs, names))
                pk = [len(exprs)]
                names = names + ["_row_id"]
        if sel.limit is not None or (sel.offset or 0) > 0:
            # ORDER BY alone is a no-op for a pk-keyed MV (pg drops it
            # too) — only a real window needs the TopN executor.
            # append-only-ness is DERIVED over the chain (agg outputs
            # and outer joins retract; inner chains of append-only
            # sources do not) — TopN prunes beyond-window state only
            # when provably append-only (top_n_appendonly analog)
            ex = self._plan_topn(ex, sel, pk,
                                 append_only=self._derive_append_only(ex))
        return ex, pk, deps, len(projections)

    @staticmethod
    def _joinable(ex: Executor, scope: Scope) -> Tuple[Executor, Scope]:
        """Make one join input key-stable with a scope covering its
        whole schema. A pk-less (append-only) chain gets a generated
        row id; a pk-keyed input KEEPS its pk — retractions replay by
        pk, so join state updates consistently. Hidden columns beyond
        the bind scope are projected down to visible + pk so scope and
        executor schema stay index-aligned (the join's output offsets
        are schema offsets)."""
        from risingwave_tpu_torch.stream.executor import ExecutorInfo

        if not ex.pk_indices:
            ex2: Executor = RowIdGenExecutor(ex)
            return ex2, Scope(ex2.schema, scope.qualifiers + [None])
        n_vis = len(scope.schema)
        if n_vis == len(ex.schema):
            return ex, scope
        keep_hidden = [i for i in ex.pk_indices if i >= n_vis]
        exprs = [InputRef(i, ex.schema[i].data_type)
                 for i in range(n_vis)]
        names = [f.name for f in scope.schema]
        for k, i in enumerate(keep_hidden):
            exprs.append(InputRef(i, ex.schema[i].data_type))
            names.append(f"_jpk{k}")
        proj = ProjectExecutor(ex, exprs, names)
        new_pk = [i if i < n_vis else n_vis + keep_hidden.index(i)
                  for i in ex.pk_indices]
        proj._info = ExecutorInfo(proj.schema, new_pk, proj.identity)
        return proj, Scope(proj.schema,
                           scope.qualifiers + [None] * len(keep_hidden))

    def _plan_topn(self, ex: Executor, sel: ast.Select,
                   pk: List[int], append_only: bool = False) -> Executor:
        """ORDER BY [+ LIMIT/OFFSET] MV → streaming TopN (top_n_plain
        analog): maintains the window incrementally, emitting deltas."""
        from risingwave_tpu_torch.stream.executors.top_n import (
            GroupTopNExecutor,
        )
        post = Scope.of(ex.schema, None)
        order = []
        for e_ast, desc in sel.order_by:
            b = Binder(post).bind(e_ast)
            if not isinstance(b, InputRef):
                raise PlanError(
                    "MV ORDER BY must reference output columns")
            order.append((b.index, desc))
        if not order:
            # LIMIT without ORDER BY: deterministic order by pk
            order = [(i, False) for i in pk]
        state = StateTable(self.catalog.next_id(), ex.schema, pk,
                           self.store)
        return GroupTopNExecutor(
            ex, order, offset=sel.offset or 0, limit=sel.limit,
            state=state, pk_indices=pk, append_only=append_only)

    @staticmethod
    def _derive_append_only(ex: Executor) -> bool:
        """Conservative append-only derivation over the executor chain
        (the reference's input_append_only on StreamHashAgg,
        logical_agg.rs). Append-only ⇢ the cheap device agg path; any
        possibility of retraction ⇢ the minput path. Unknown executors
        default to False — silent wrongness is the only unacceptable
        outcome."""
        # chained-MV edges carry the upstream MV's own proof (stamped
        # in _chain_upstream_mv from MvCatalog.append_only) — the
        # chain boundary would otherwise hit the Backfill default and
        # lose provably-append-only upstreams
        hint = getattr(ex, "append_only_hint", None)
        if hint is not None:
            return bool(hint)
        from risingwave_tpu_torch.stream.executors.source import SourceExecutor
        from risingwave_tpu_torch.stream.executors.simple import (
            FilterExecutor, ProjectExecutor,
        )
        from risingwave_tpu_torch.stream.executors.row_id_gen import (
            RowIdGenExecutor,
        )
        if isinstance(ex, SourceExecutor):
            return True
        if isinstance(ex, HashJoinExecutor):
            # inner joins of append-only inputs emit only inserts;
            # any outer/semi/anti kind emits padded-row flips
            return (ex.join_type == JoinType.INNER
                    and StreamPlanner._derive_append_only(ex.left_in)
                    and StreamPlanner._derive_append_only(ex.right_in))
        from risingwave_tpu_torch.stream.executors.temporal_join import (
            TemporalJoinExecutor,
        )
        if isinstance(ex, TemporalJoinExecutor):
            # temporal output is append-only by construction
            return StreamPlanner._derive_append_only(ex.left_in)
        from risingwave_tpu_torch.stream.executors.hop_window import (
            HopWindowExecutor,
        )
        if isinstance(ex, (ProjectExecutor, FilterExecutor,
                           RowIdGenExecutor, HopWindowExecutor)):
            return StreamPlanner._derive_append_only(ex.input)
        from risingwave_tpu_torch.stream.executors.watermark_filter import (
            WatermarkFilterExecutor,
        )
        if isinstance(ex, WatermarkFilterExecutor):
            return StreamPlanner._derive_append_only(ex.input)
        from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
        if isinstance(ex, CoalesceExecutor):
            # pure re-batching: op multiset is untouched
            return StreamPlanner._derive_append_only(ex.input)
        from risingwave_tpu_torch.stream.executors.project_set import (
            ProjectSetExecutor,
        )
        if isinstance(ex, ProjectSetExecutor):
            # deterministic expansion of inserts is inserts
            return StreamPlanner._derive_append_only(ex.input)
        from risingwave_tpu_torch.stream.executors.fused import (
            FusedFragmentExecutor,
        )
        if isinstance(ex, FusedFragmentExecutor):
            # a fused block composes filter/project/row_id_gen/
            # watermark_filter stages — each append-only-transparent,
            # so the block is too
            return StreamPlanner._derive_append_only(ex.input)
        # HashAgg/TopN/Backfill/DynamicFilter/unknown: assume retracting
        return False

    def _plan_project_set(self, ex: Executor, scope: Scope,
                          sel: ast.Select, projections, deps):
        """SELECT list with set-returning functions → ProjectSet
        (src/stream/src/executor/project_set.rs parity): each row
        expands to the rows its table functions return, and the
        hidden _projected_row_id joins the stream key so equal
        per-element rows retract exactly."""
        from risingwave_tpu_torch.expr.expr import Literal
        from risingwave_tpu_torch.stream.executors.project_set import (
            ProjectSetExecutor,
        )
        if sel.group_by or sel.having is not None:
            raise PlanError("set-returning functions cannot be mixed "
                            "with GROUP BY / HAVING")
        binder = Binder(scope)      # aggregates raise naturally
        items, names = [], []
        ints = (DataType.INT16, DataType.INT32, DataType.INT64)
        for i, (e, a) in enumerate(projections):
            if isinstance(e, ast.Call) and e.name == "unnest":
                raise PlanError(
                    "unnest is not supported yet — LIST columns do "
                    "not carry an element type")
            if isinstance(e, ast.Call) and e.name == "generate_series":
                if len(e.args) not in (2, 3):
                    raise PlanError(
                        "generate_series(start, stop [, step])")
                args = [binder.bind(x) for x in e.args]
                for b in args:
                    if b.return_type not in ints:
                        raise PlanError("generate_series arguments "
                                        "must be integers")
                if len(args) == 2:
                    args.append(Literal(1, DataType.INT64))
                step = args[2]
                if isinstance(step, Literal) and int(step.value) == 0:
                    raise PlanError(
                        "generate_series step must be nonzero")
                items.append(("series", tuple(args)))
                names.append(a or "generate_series")
            else:
                items.append(("scalar", binder.bind(e)))
                names.append(a or expr_name(e, f"col{i}"))
        seen: dict = {}
        for idx, n in enumerate(names):
            k = seen.get(n, 0)
            seen[n] = k + 1
            if k:
                # two unaliased series items share a name; uniquify so
                # the MV's columns stay addressable (SELECT * binds by
                # name downstream)
                names[idx] = f"{n}_{k}"
        base_pk = list(ex.pk_indices)
        if not base_pk:
            ex = RowIdGenExecutor(ex)
            base_pk = [len(ex.schema) - 1]
        ex = ProjectSetExecutor(ex, items, names, pass_pk=base_pk)
        pk = list(ex.pk_indices)
        # expansion re-keys rows; the EOWC feed proof stops here
        self._wm_scope_cols = set()
        if sel.limit is not None or (sel.offset or 0) > 0:
            ex = self._plan_topn(
                ex, sel, pk,
                append_only=self._derive_append_only(ex))
        return ex, pk, deps, len(names)

    def _plan_over_window(self, ex: Executor, binder: Binder, bound):
        """Insert an OverWindowExecutor (optimizer/plan_node/
        stream_over_window.rs analog): output = input + one column per
        window call; ('win', j) projection items map to those columns.
        State pk = partition | order | input pk (general.rs:59)."""
        from risingwave_tpu_torch.stream.executors.over_window import (
            OverWindowExecutor,
        )
        if not ex.pk_indices:
            ex = RowIdGenExecutor(ex)
        n_in = len(ex.schema)
        pk = [i for i in ex.pk_indices]
        order = list(binder.window_order)
        partition = list(binder.window_partition)
        # state pk = partition | order | input-pk tie-break suffix
        # (pk columns that double as partition/order keys drop out of
        # the suffix — rows are then unique by their order key alone);
        # the executor's OUTPUT identity stays the FULL input pk
        suffix = [i for i in pk if i not in partition
                  and i not in [o for o, _ in order]]
        state = StateTable(self.catalog.next_id(), ex.schema,
                           partition + [i for i, _d in order] + suffix,
                           self.store, dist_key_indices=partition)
        win = OverWindowExecutor(ex, partition, order,
                                 binder.window_calls, state,
                                 input_pk=pk,
                                 actor_id=self._actor_id)
        out = [InputRef(n_in + b[1],
                        win.schema[n_in + b[1]].data_type)
               if isinstance(b, tuple) and b[0] == "win" else b
               for b in bound]
        return win, out

    def _plan_agg(self, ex: Executor, scope: Scope, sel: ast.Select,
                  binder: Binder, projections) -> Tuple[Executor, List, object]:
        """Insert pre-agg projection + HashAggExecutor; returns
        (agg executor, output exprs over the agg row, HAVING predicate
        over the agg row or None). SELECT items and HAVING bind through
        PostAggBinder, so expressions OVER aggregates (sum(x)+1,
        avg(q.final), HAVING count(*) > 5) work — the reference resolves
        these in LogicalAgg planning (logical_agg.rs)."""
        from risingwave_tpu_torch.frontend.binder import PostAggBinder
        group_bound = [Binder(scope).bind(g) for g in sel.group_by]
        if not group_bound:
            # global aggregation: a synthetic constant group key routes
            # it through the SAME hash-agg machinery — one real group,
            # full retraction support (minput MIN/MAX, host aggs); the
            # hidden-group-key logic keys the single-row MV by it.
            # (simple_agg.rs covers the append-only fast path; the
            # planner prefers the general one.)
            from risingwave_tpu_torch.expr.expr import Literal
            group_bound = [Literal(0, DataType.INT32)]
        self._agg_group_arity = len(group_bound)
        group_reprs = [repr(g) for g in group_bound]
        pab = PostAggBinder(binder, group_reprs)
        bound = [pab.bind(e) for e, _a in projections]
        having_pred = None
        if sel.having is not None:
            having_pred = pab.bind(sel.having)
            if having_pred.return_type != DataType.BOOLEAN:
                raise PlanError("HAVING must be a boolean expression")
        # pre-agg projection: group exprs, then each agg input column
        pre_exprs: List[Expression] = list(group_bound)
        pre_names = [f"_g{i}" for i in range(len(group_bound))]
        remapped: List[AggCall] = []
        in_expr_idx: Dict[str, int] = {}
        for call, in_expr in zip(binder.agg_calls, binder.agg_inputs):
            if in_expr is None:            # count(*)
                remapped.append(call)
                continue
            # identical input expressions share one projected column —
            # count(DISTINCT x) + sum(DISTINCT x) then share their
            # dedup table and per-chunk gating in the executor
            k = repr(in_expr)
            if k not in in_expr_idx:
                pre_exprs.append(in_expr)
                pre_names.append(f"_a{len(pre_exprs) - 1}")
                in_expr_idx[k] = len(pre_exprs) - 1
            remapped.append(AggCall(call.kind, in_expr_idx[k],
                                    distinct=call.distinct,
                                    delimiter=call.delimiter))
        # plain-column group keys pass their watermarks through the
        # pre-agg projection (EOWC and agg state cleaning need them)
        pre_derivs = {e.index: j for j, e in enumerate(group_bound)
                      if isinstance(e, InputRef)}
        pre = ProjectExecutor(ex, pre_exprs, pre_names,
                              watermark_derivations=pre_derivs)
        # group positions fed by a source watermark (EOWC validation)
        wm_cols = getattr(self, "_wm_scope_cols", set())
        self._agg_wm_positions = [
            pos for pos, gb in enumerate(group_bound)
            if isinstance(gb, InputRef) and gb.index in wm_cols]
        g = len(group_bound)
        calls = remapped
        # append-only-ness decides the agg mode: a retracting upstream
        # (GROUP BY over an outer join, over another agg) needs the
        # retractable one
        append_only = self._derive_append_only(ex)
        sch, agg_pk = agg_state_schema(pre.schema, list(range(g)), calls)
        table = StateTable(self.catalog.next_id(), sch, agg_pk,
                           self.store,
                           dist_key_indices=list(range(len(agg_pk))))
        from risingwave_tpu_torch.stream.executors.hash_agg import (
            agg_aux_tables,
        )
        distinct_tables, minput_tables = agg_aux_tables(
            pre.schema, list(range(g)), calls, append_only, self.store,
            dedup_table_id=lambda _col: self.catalog.next_id(),
            minput_table_id=lambda _j: self.catalog.next_id())
        kernel = None
        if self.mesh is not None:
            # parallel plan: the hash exchange the reference's
            # fragmenter inserts before a parallel agg
            # (stream_fragmenter/mod.rs:199) is the sharded kernel's
            # routing. Retracting upstreams shard too (signed scatters
            # and the sharded patch of MIN/MAX recomputes); host aggs
            # keep their executor-side path under any kernel. This
            # block allocates no catalog id (the id-base contract).
            from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
            from risingwave_tpu_torch.stream.executors.keys import (
                LANES_PER_KEY,
            )
            kernel = ShardedAggKernel(
                self.mesh, key_width=LANES_PER_KEY * g,
                specs=[c.spec(pre.schema) for c in calls])
        agg = HashAggExecutor(self._coalesced(pre), list(range(g)),
                              calls, table,
                              append_only=append_only, kernel=kernel,
                              minput_tables=minput_tables,
                              distinct_tables=distinct_tables,
                              # the cold tier: the one-device lazy
                              # kernel only (the sharded one has no
                              # targeted evict)
                              tier_cap=self.state_tier_cap
                              if kernel is None else None,
                              device=self.device)
        # bound items are already typed refs over the agg output row
        return agg, bound, having_pred

def _expand_star(projections, scope: Scope):
    out = []
    for e, a in projections:
        if isinstance(e, ast.ColRef) and e.name == "*":
            for i, f in enumerate(scope.schema):
                out.append((ast.ColRef(f.name, scope.qualifiers[i]), None))
        else:
            out.append((e, a))
    return out


def _parse_interval_opt(s: str) -> Interval:
    """'4 seconds' / '500 milliseconds' / raw µs number → Interval.
    Shares the SQL parser's unit table (one source of truth)."""
    from risingwave_tpu_torch.frontend.parser import _INTERVAL_UNITS
    s = str(s).strip()
    parts = s.split()
    if len(parts) == 2 and parts[1].lower() in _INTERVAL_UNITS:
        return Interval(
            usecs=int(parts[0]) * _INTERVAL_UNITS[parts[1].lower()])
    if s.isdigit():
        return Interval(usecs=int(s))
    raise PlanError(f"bad interval option {s!r}")


def _flatten_and(e: ast.Expr) -> List[ast.Expr]:
    """WHERE → list of AND conjuncts (pushdown granularity)."""
    if isinstance(e, ast.Bin) and e.op == "and":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]




def explain_tree(ex, indent: int = 0) -> List[str]:
    """Executor chain → indented plan text (planner_test snapshot
    style; the EXPLAIN statement surfaces it). Walks the same
    `executor_children` set install_monitoring wraps."""
    from risingwave_tpu_torch.stream.executor import executor_children
    label = getattr(ex, "identity", None) or type(ex).__name__
    out = [("  " * indent) + label]
    for _attr, _i, child in executor_children(ex):
        out += explain_tree(child, indent + 1)
    return out


def _equi_keys(on: ast.Expr, lscope: Scope, rscope: Scope
               ) -> Tuple[List[int], List[int]]:
    """ON conjunction of col=col → (left key idxs, right key idxs)."""
    conj: List[ast.Expr] = []

    def flatten(e):
        if isinstance(e, ast.Bin) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
        else:
            conj.append(e)

    flatten(on)
    lkeys, rkeys = [], []
    for c in conj:
        if not (isinstance(c, ast.Bin) and c.op == "="
                and isinstance(c.left, ast.ColRef)
                and isinstance(c.right, ast.ColRef)):
            raise PlanError("JOIN ON must be a conjunction of "
                            "column = column")
        sides = []
        for col in (c.left, c.right):
            try:
                sides.append(("l", lscope.find(col.name, col.table)[0]))
            except BindError:
                sides.append(("r", rscope.find(col.name, col.table)[0]))
        tags = {s[0] for s in sides}
        if tags != {"l", "r"}:
            raise PlanError("JOIN ON must compare the two sides")
        for tag, idx in sides:
            (lkeys if tag == "l" else rkeys).append(idx)
    return lkeys, rkeys


# system tables of subsystems a later item ports, by that item
_UNPORTED_SYSTEM_TABLES = {
    "rw_actor_metrics": "12", "rw_fragment_backpressure": "12",
    "rw_state_tier": "12", "rw_epoch_trace": "12",
    "rw_metrics_history": "12", "rw_mv_freshness": "12",
    "rw_bottlenecks": "12", "rw_actor_utilization": "12",
    "rw_kernel_costs": "12", "rw_recovery": "12", "rw_autoscaler": "12",
    "rw_mv_costs": "12", "rw_hot_keys": "12", "rw_state_topology": "12",
    "rw_compaction": "11", "rw_sinks": "13",
}


def _system_catalog_rows(name: str, catalog: Catalog, profiler=None):
    """rw_catalog-style system tables over the live catalog, served as
    batch values: (schema, rows) or None. ``profiler`` is the session
    barrier loop's EpochProfiler (rw_barrier_latency's source)."""
    n = name.lower()
    if n == "rw_barrier_latency":
        sch = Schema([Field("epoch", DataType.INT64),
                      Field("kind", DataType.VARCHAR),
                      Field("inject_to_collect_s", DataType.FLOAT64),
                      Field("collect_to_commit_s", DataType.FLOAT64),
                      Field("total_s", DataType.FLOAT64),
                      Field("in_flight", DataType.INT64),
                      Field("slowest_actor", DataType.INT64),
                      Field("slowest_actor_lag_s", DataType.FLOAT64),
                      Field("upload_s", DataType.FLOAT64),
                      Field("queue_depth", DataType.INT64),
                      Field("domain", DataType.VARCHAR)])
        rows = list(profiler.rows()) if profiler is not None else []
        return sch, rows
    if n in ("rw_materialized_views", "rw_tables"):
        want_tables = n == "rw_tables"
        sch = Schema([Field("name", DataType.VARCHAR),
                      Field("table_id", DataType.INT64),
                      Field("actor_id", DataType.INT64),
                      Field("definition", DataType.VARCHAR)])
        rows = [(m.name, m.table_id, m.actor_id, m.definition or "")
                for m in catalog.mvs.values()
                if m.is_table == want_tables]
        return sch, sorted(rows)
    if n == "rw_sources":
        sch = Schema([Field("name", DataType.VARCHAR),
                      Field("connector", DataType.VARCHAR),
                      Field("columns", DataType.INT64)])
        rows = [(s.name, s.options.get("connector", ""),
                 len(s.schema))
                for s in catalog.sources.values()]
        return sch, sorted(rows)
    if n == "rw_plan_rewrites":
        # plan-rewrite firing log (frontend/opt engine): one row per
        # (job, rule) application, FALLBACK rows record checker trips
        from risingwave_tpu_torch.frontend.opt import rewrite_history_rows
        sch = Schema([Field("seq", DataType.INT64),
                      Field("job", DataType.VARCHAR),
                      Field("rule", DataType.VARCHAR),
                      Field("fired", DataType.INT64),
                      Field("detail", DataType.VARCHAR)])
        return sch, sorted(rewrite_history_rows())
    if n in _UNPORTED_SYSTEM_TABLES:
        raise not_ported(f"system table {n}", _UNPORTED_SYSTEM_TABLES[n])
    return None


# -- batch planning -------------------------------------------------------


def plan_batch(sel: ast.Select, catalog: Catalog, store, epoch: int,
               profiler=None):
    """SELECT over committed snapshots → batch executor tree.

    `profiler` (the session's EpochProfiler, optional) backs the
    rw_barrier_latency system table."""
    from risingwave_tpu_torch.batch import (
        BatchFilter, BatchHashAgg, BatchHashJoin, BatchLimit,
        BatchOrderBy, BatchProject, BatchValues, RowSeqScan, StorageTable,
    )

    def scan(item) -> Tuple[object, Scope]:
        if isinstance(item, ast.TableFn):
            # table functions (src/expr/src/table_function/ parity:
            # generate_series); evaluated to rows at plan time — args
            # are constant expressions
            if item.name != "generate_series":
                raise PlanError(
                    f"unknown table function {item.name!r}")
            if len(item.args) not in (2, 3):
                raise PlanError(
                    "generate_series(start, stop [, step])")
            binder = Binder(Scope.of(Schema([]), None))
            vals = []
            for a in item.args:
                b = binder.bind(a)
                from risingwave_tpu_torch.expr.expr import Literal, UnaryOp
                if isinstance(b, Literal):
                    vals.append(int(b.value))
                elif isinstance(b, UnaryOp) and b.op == "neg" and \
                        isinstance(b.child, Literal):
                    vals.append(-int(b.child.value))
                else:
                    raise PlanError(
                        "generate_series arguments must be integer "
                        "literals")
            start, stop = vals[0], vals[1]
            step = vals[2] if len(vals) == 3 else 1
            if step == 0:
                raise PlanError("generate_series step must be nonzero")
            rows = [(v,) for v in range(start, stop + (1 if step > 0
                                                       else -1), step)]
            # pg: the alias names BOTH the table and the single column
            col = item.alias or "generate_series"
            sch = Schema([Field(col, DataType.INT64)])
            return (BatchValues(sch, rows), Scope.of(sch, col))
        if isinstance(item, ast.Subquery):
            sub = plan_batch(item.select, catalog, store, epoch,
                             profiler)
            return sub, Scope.of(sub.schema, item.alias)
        if not isinstance(item, ast.TableRef):
            raise PlanError("batch FROM supports tables/MVs")
        try:
            obj = catalog.resolve(item.name)
        except Exception:
            # USER objects win over system catalogs (pg search-path
            # spirit); only an unresolved name falls through to rw_*
            sysrows = _system_catalog_rows(item.name, catalog,
                                           profiler)
            if sysrows is None:
                raise
            sch, rows = sysrows
            return (BatchValues(sch, rows),
                    Scope.of(sch, item.alias or item.name))
        if isinstance(obj, SourceCatalog):
            raise PlanError("cannot batch-scan a pure source; "
                            "create a materialized view over it")
        st = StorageTable(obj.table_id, obj.schema, obj.pk_indices, store)
        ex = RowSeqScan(st, epoch)
        vis = obj.visible_schema
        if len(vis) < len(obj.schema):
            # hidden trailing columns (_row_id, unprojected group keys)
            # must leave the EXECUTOR schema too, not just the binding
            # scope — a downstream join concatenates executor schemas,
            # and a width mismatch would shift every right-side index
            ex = BatchProject(ex, [InputRef(i, f.data_type)
                                   for i, f in enumerate(vis)])
        return ex, Scope.of(vis, item.alias or item.name)

    if sel.from_item is None:
        # SELECT <exprs>: evaluate over one synthetic row
        from risingwave_tpu_torch.common.types import Schema as Sch
        binder = Binder(Scope.of(Sch([]), None))
        exprs = [binder.bind(e) for e, _ in sel.projections]
        from risingwave_tpu_torch.common.chunk import DataChunk
        import numpy as np
        one = DataChunk.empty(Sch([]), capacity=8)
        one.visibility[0] = True
        cols = [e.eval(one) for e in exprs]
        row = tuple(
            None if (c.validity is not None and not c.validity[0])
            else (c.values[0].item() if hasattr(c.values[0], "item")
                  else c.values[0])
            for c in cols)
        names = [a or expr_name(e, f"col{i}")
                 for i, (e, a) in enumerate(sel.projections)]
        sch = Sch([Field(n, c.data_type) for n, c in zip(names, cols)])
        return BatchValues(sch, [row])

    ex, scope = scan(sel.from_item)
    for jn in sel.joins:
        rex, rscope = scan(jn.item)
        lkeys, rkeys = _equi_keys(jn.on, scope, rscope)
        ex = BatchHashJoin(ex, rex, lkeys, rkeys)
        scope = scope.concat(rscope)
    if sel.where is not None:
        ex = BatchFilter(ex, Binder(scope).bind(sel.where))
    projections = _expand_star(sel.projections, scope)
    from risingwave_tpu_torch.frontend.binder import PostAggBinder, contains_agg
    binder = Binder(scope, allow_aggs=True)
    names = [a or expr_name(e, f"col{i}")
             for i, (e, a) in enumerate(projections)]
    has_agg = (bool(sel.group_by) or sel.having is not None
               or any(contains_agg(e) for e, _a in projections))
    if has_agg:
        group_bound = [Binder(scope).bind(g) for g in sel.group_by]
        group_reprs = [repr(g) for g in group_bound]
        pab = PostAggBinder(binder, group_reprs)
        bound = [pab.bind(e) for e, _a in projections]
        having_pred = None
        if sel.having is not None:
            having_pred = pab.bind(sel.having)
            if having_pred.return_type != DataType.BOOLEAN:
                raise PlanError("HAVING must be a boolean expression")
        pre_exprs = list(group_bound)
        remapped = []
        for call, in_expr in zip(binder.agg_calls, binder.agg_inputs):
            if in_expr is None:            # count(*)
                remapped.append(call)
                continue
            pre_exprs.append(in_expr)      # agg over any expression
            remapped.append(AggCall(call.kind, len(pre_exprs) - 1,
                                    distinct=call.distinct,
                                    delimiter=call.delimiter))
        pre = BatchProject(ex, pre_exprs)
        g = len(group_bound)
        ex = BatchHashAgg(pre, list(range(g)), remapped)
        if having_pred is not None:
            ex = BatchFilter(ex, having_pred)
        ex = BatchProject(ex, bound, names)
        post_scope = Scope.of(ex.schema, None)
    else:
        bound = [binder.bind_projection(e) for e, _a in projections]
        ex = BatchProject(ex, bound, names)
        post_scope = Scope.of(ex.schema, None)
    if sel.order_by:
        cols = []
        for e, desc in sel.order_by:
            b = Binder(post_scope).bind(e)
            if not isinstance(b, InputRef):
                raise PlanError("ORDER BY must reference output columns")
            cols.append((b.index, desc))
        ex = BatchOrderBy(ex, cols)
    if sel.limit is not None or sel.offset is not None:
        ex = BatchLimit(ex, sel.limit if sel.limit is not None else 1 << 62,
                        sel.offset or 0)
    return ex
