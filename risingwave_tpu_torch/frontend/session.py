"""Frontend session: the run-one-query loop + streaming-job deployment.

Port of ``risingwave_tpu/frontend/session.py``'s ``Frontend`` for one
device and one barrier domain (reference parity: pgwire's
``Session::run_one_query``, the per-statement handlers and the meta
DdlController collapsed into one in-process object). It takes SQL text
and runs it: ``CREATE SOURCE`` over the ``nexmark``, ``tpch``,
``datagen`` and ``filelog`` connectors, ``CREATE MATERIALIZED VIEW``
deployed as the port's executors on the card's kernels (over a source,
a table or another MV, which it backfills from the upstream's committed
snapshot before following its changelog; ``JOIN <mv> FOR SYSTEM_TIME AS
OF PROCTIME()``), ``CREATE TABLE`` / ``DROP TABLE`` and ``INSERT`` /
``UPDATE`` / ``DELETE`` through each table's DML channel, ``FLUSH``,
``SELECT`` through the batch engine, ``EXPLAIN``, ``SET`` / ``SHOW``,
``ALTER MATERIALIZED VIEW ... SET PARALLELISM``, ``DROP MATERIALIZED
VIEW`` / ``DROP SOURCE``, and ``step`` / ``close``. The entry point is
the reference's: ``Frontend(...)`` then ``await fe.execute(sql)``
(``frontend/pgwire.py`` serves it to PostgreSQL clients). Every MV's
actor ends in a broadcast dispatcher, empty until a downstream MV
attaches its chain edge.

``parallelism`` n > 1 plans every GROUP BY and stream join over a
``ShardMesh(n)``: n logical shards on the session's device, where the
reference needs n devices (so 2 to 256, the vnode count). ``ALTER ...
SET PARALLELISM`` stops the job at a barrier with its state kept,
replans it from the same table-id base over the new mesh, and the
redeployed executors recover from the kept state tables.

Every MV's keyed executors run on the session's ``device``: the card
unless the caller passes ``device="cpu"`` (``utils/device.py``
``resolve_device``); with no card and no ``device``, construction
raises.

What this session leaves to later items, each refused with
``NotImplementedError`` naming its ``ROADMAP.md`` item: any
store but ``MemoryStateStore``, ``recover`` and the DDL log (11); barrier
domains (``epoch_pipeline``), the span tracer, the epoch ledger, the
tricolor monitor and the cost ledger (12); sinks (13). Their session
knobs keep the reference's names and defaults in ``SHOW ALL``; setting
one to anything but its default raises.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Union

from risingwave_tpu_torch.frontend import ast
from risingwave_tpu_torch.frontend.catalog import Catalog
from risingwave_tpu_torch.frontend.planner import (
    PlanError, StreamPlanner, not_ported, plan_batch, source_schema,
)
from risingwave_tpu_torch.meta.barrier import BarrierLoop
from risingwave_tpu_torch.state.store import MemoryStateStore, StateStore
from risingwave_tpu_torch.stream.actor import (
    Actor, LocalBarrierManager, close_receivers,
)
from risingwave_tpu_torch.stream.message import StopMutation
from risingwave_tpu_torch.utils.device import resolve_device

Rows = List[tuple]

# session knobs of subsystems a later item ports: name -> (the values
# that mean the reference's default, the item)
_UNPORTED_KNOBS = {
    "stream_trace": (("on", "true", "1"), "12"),
    "stream_ledger": (("on", "true", "1"), "12"),
    "stream_tricolor": (("on", "true", "1"), "12"),
    "stream_costs": (("on", "true", "1"), "12"),
    "storage_compaction": (("inline",), "11"),
}

# statements a later item ports, by AST class name
_UNPORTED_STATEMENTS = {
    "CreateSink": ("CREATE SINK", "13"),
    "DropSink": ("DROP SINK", "13"),
}


def _knob_validator(name: str):
    accepted, item = _UNPORTED_KNOBS[name]

    def check(spec: str) -> str:
        if str(spec).strip().lower() not in accepted:
            raise not_ported(f"SET {name} = {spec!r}", item)
        return spec
    return check


def _validate_epoch_pipeline(spec: str) -> bool:
    s = str(spec).strip().lower()
    if s in ("off", "false", "0"):
        return False
    if s in ("on", "true", "1"):
        raise not_ported("barrier domains (stream_epoch_pipeline = on)",
                         "12")
    raise PlanError(
        f"stream_epoch_pipeline must be 'on' or 'off', got {spec!r}")


class Frontend:
    """One session over one in-process cluster on one device."""

    def __init__(self, store: Optional[StateStore] = None,
                 rate_limit: Optional[int] = 8,
                 min_chunks: Optional[int] = None,
                 parallelism: int = 1,
                 join_state_cap: Optional[int] = None,
                 epoch_pipeline: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.store = store if store is not None else MemoryStateStore()
        if not isinstance(self.store, MemoryStateStore):
            raise not_ported("a state store other than MemoryStateStore",
                             "11")
        # parallelism > 1: GROUP BY and join plans run on the
        # vnode-sharded kernels over logical shards of the device
        self.mesh = self._mesh_for(parallelism)
        if epoch_pipeline:
            raise not_ported("barrier domains (epoch_pipeline=True)", "12")
        self.catalog = Catalog()
        self.local = LocalBarrierManager()
        # one global barrier loop: the reference's
        # stream_epoch_pipeline = off arm, which it states is
        # bit-identical to its domains
        self._loop = BarrierLoop(self.local, self.store)
        self.actors: Dict[int, Actor] = {}
        self.tasks: Dict[int, asyncio.Task] = {}
        self.readers: Dict[str, Dict[int, object]] = {}   # mv → readers
        self.rate_limit = rate_limit
        self.min_chunks = min_chunks
        # resident join-state cap (cold-tier eviction; None = unbounded)
        self.join_state_cap = join_state_cap
        # unified state-tiering cap (state/tier.py); None/0 = unbounded.
        # Recorded per MV at CREATE (it shapes join state-table pks) and
        # replayed at reschedule, like _mv_rules
        self.state_tier_cap: Optional[int] = None
        self._mv_tier_caps: Dict[str, Optional[int]] = {}
        from risingwave_tpu_torch.stream.coalesce import (
            DEFAULT_MAX_CHUNKS, DEFAULT_TARGET_ROWS,
        )
        self.chunk_target_rows = DEFAULT_TARGET_ROWS
        self.coalesce_linger_chunks = DEFAULT_MAX_CHUNKS
        from risingwave_tpu_torch.frontend.opt import (
            parse_fusion, parse_rules,
        )
        from risingwave_tpu_torch.frontend.session_vars import SessionVars
        self.session_vars = SessionVars(
            self, {"streaming_rate_limit": "rate_limit",
                   "streaming_min_chunks": "min_chunks",
                   "join_state_cap": "join_state_cap",
                   "state_tier_cap": "state_tier_cap",
                   "state_tier_soft_limit_mb":
                       "state_tier_soft_limit_mb",
                   "stream_chunk_target_rows": "chunk_target_rows",
                   "stream_checkpoint_frequency":
                       "checkpoint_frequency",
                   "stream_coalesce_linger_chunks":
                       "coalesce_linger_chunks"},
            {"application_name": "", "timezone": "UTC",
             "stream_rewrite_rules": "all",
             "stream_fusion": "on",
             "stream_trace": "on",
             "stream_ledger": "on",
             "stream_epoch_pipeline": "off",
             "stream_tricolor": "on",
             "stream_costs": "on",
             "storage_compaction": "inline"},
            validators={"stream_rewrite_rules": parse_rules,
                        "stream_fusion": parse_fusion,
                        "stream_epoch_pipeline":
                            _validate_epoch_pipeline,
                        **{n: _knob_validator(n)
                           for n in _UNPORTED_KNOBS}})
        # rules spec and fusion setting each MV was created under: they
        # shape its state tables, so a reschedule and a DDL replay
        # (item 11) must re-plan under the same ones
        self._mv_rules: Dict[str, str] = {}
        self._mv_fusion: Dict[str, bool] = {}
        # name → (CREATE MV select AST, EOWC flag): reschedule replans
        # from this
        self._mv_selects: Dict[str, tuple] = {}
        # what each CREATE cost and did: planning + rewrite seconds and
        # the rewrite report (rules fired, fusion groups, fallbacks)
        self.mv_plan_seconds: Dict[str, float] = {}
        self.mv_reports: Dict[str, object] = {}
        self._next_actor = 1000
        self.chain_edges: Dict[str, list] = {}   # job → [(uid, Output)]
        # table name → (DmlReader, schema, pk, RowIdSeq|None, tid):
        # the DML write path into each CREATE TABLE job
        self._tables: Dict[str, tuple] = {}
        # serializes barrier rounds between DDL handlers and step()
        self._barrier_lock = asyncio.Lock()

    # -- barrier engine ---------------------------------------------------
    @property
    def loop(self) -> BarrierLoop:
        return self._loop

    @property
    def checkpoint_frequency(self) -> int:
        return self._loop.checkpoint_frequency

    @checkpoint_frequency.setter
    def checkpoint_frequency(self, v) -> None:
        self._loop.checkpoint_frequency = max(1, int(v))

    @property
    def state_tier_soft_limit_mb(self) -> int:
        """The memory context's soft limit (utils/memory.py) in MB;
        0 = unlimited. Process-global."""
        from risingwave_tpu_torch.utils import memory as _mem
        sl = _mem.GLOBAL.soft_limit
        return 0 if sl is None else int(sl) >> 20

    @state_tier_soft_limit_mb.setter
    def state_tier_soft_limit_mb(self, v) -> None:
        from risingwave_tpu_torch.utils import memory as _mem
        _mem.GLOBAL.soft_limit = None if not v else int(v) << 20

    async def recover(self) -> int:
        raise not_ported("recovery from the DDL log", "11")

    # -- public API -------------------------------------------------------
    async def execute(self, sql: str) -> Union[Rows, str]:
        """Run one or more ';'-separated statements; returns the last
        statement's result (rows for SELECT/SHOW, status otherwise)."""
        from risingwave_tpu_torch.frontend.parser import parse_many

        result: Union[Rows, str] = "OK"
        for _text, stmt in parse_many(sql):
            result = await self._run(stmt)
        return result

    async def _barrier(self, **kw):
        """One serialized barrier round."""
        async with self._barrier_lock:
            return await self._loop.inject_and_collect(**kw)

    async def step(self, n: int = 1) -> None:
        """Drive n checkpoint barriers (deterministic test/bench mode)."""
        for _ in range(n):
            await self._barrier(force_checkpoint=True)

    async def close(self) -> None:
        if self.actors:
            async with self._barrier_lock:
                stop_ids = set(self.actors)
                for readers in self.readers.values():
                    stop_ids |= set(readers)
                await self._loop.inject_and_collect(
                    mutation=StopMutation(frozenset(stop_ids)))
                for t in self.tasks.values():
                    await t
        for a in self.actors.values():
            if a.failure is not None:
                raise a.failure

    # -- dispatch ---------------------------------------------------------
    async def _run(self, stmt) -> Union[Rows, str]:
        self.last_select_schema = None
        refused = _UNPORTED_STATEMENTS.get(type(stmt).__name__)
        if refused is not None:
            raise not_ported(*refused)
        if isinstance(stmt, ast.CreateSource):
            schema = source_schema(stmt.options, stmt.columns)
            self.catalog.add_source(stmt.name, schema, stmt.options)
            return "CREATE_SOURCE"
        if isinstance(stmt, ast.CreateMaterializedView):
            return await self._create_mv(stmt)
        if isinstance(stmt, ast.AlterParallelism):
            return await self._alter_parallelism(stmt)
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt.select)
        if isinstance(stmt, ast.DropMaterializedView):
            return await self._drop_mv(stmt)
        if isinstance(stmt, ast.DropSource):
            if stmt.name not in self.catalog.sources:
                if stmt.if_exists:
                    return "DROP_SOURCE"
                raise PlanError(f"unknown source {stmt.name!r}")
            for job in self.catalog.mvs.values():
                if stmt.name in job.dependent_sources:
                    raise PlanError(
                        f"source {stmt.name!r} is used by {job.name!r}")
            del self.catalog.sources[stmt.name]
            return "DROP_SOURCE"
        if isinstance(stmt, ast.CreateTable):
            return await self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            return await self._drop_table(stmt)
        if isinstance(stmt, ast.Insert):
            return await self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return await self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return await self._update(stmt)
        if isinstance(stmt, ast.SetVar):
            self.session_vars.set(stmt.name, stmt.value)
            return "SET"
        if isinstance(stmt, ast.Show):
            if stmt.what == "var:all":
                return self.session_vars.show_all()
            if stmt.what.startswith("var:"):
                name = stmt.what[4:].lower()
                if not self.session_vars.known(name):
                    raise PlanError(
                        f"unrecognized configuration parameter "
                        f"{name!r}")
                return [(self.session_vars.get(name),)]
            if stmt.what == "sources":
                return [(n,) for n in sorted(self.catalog.sources)]
            if stmt.what == "sinks":
                return []
            if stmt.what == "tables":
                return [(n,) for n in sorted(self._tables)]
            return [(n,) for n in sorted(self.catalog.mvs)
                    if n not in self._tables]
        if isinstance(stmt, ast.Flush):
            await self._barrier(force_checkpoint=True)
            return "FLUSH"
        if isinstance(stmt, ast.Select):
            return await self._select(stmt)
        raise PlanError(f"unhandled statement {stmt!r}")

    # -- handlers ---------------------------------------------------------
    def _planner(self, local, mesh, state_tier_cap) -> StreamPlanner:
        return StreamPlanner(self.catalog, self.store, local,
                             definition="", mesh=mesh, actors=self.actors,
                             join_state_cap=self.join_state_cap,
                             state_tier_cap=state_tier_cap,
                             chunk_target_rows=self.chunk_target_rows,
                             coalesce_linger_chunks=self
                             .coalesce_linger_chunks,
                             device=self.device)

    def _mesh_for(self, parallelism: int):
        """n logical shards on the session's device for a parallel plan
        (None: one device). Past the 256 vnodes ShardMesh raises
        ValueError."""
        if parallelism <= 1:
            return None
        from risingwave_tpu_torch.parallel.mesh import ShardMesh
        return ShardMesh(parallelism, device=self.device)

    async def _deploy_job(self, name: str, actor_id: int, consumer,
                          readers, register, attaches=()) -> Actor:
        """Deployment tail, run under the barrier lock the caller holds:
        register, spawn the actor, attach its chain edges, then the
        activation barrier."""
        from risingwave_tpu_torch.stream.dispatch import BroadcastDispatcher
        register()                    # catalog entry (duplicate check)
        # every MV actor carries an (initially empty) broadcast
        # dispatcher so later MV-on-MV chains can attach outputs at a
        # barrier boundary (Mutation::Add analog)
        actor = Actor(actor_id, consumer,
                      dispatchers=[BroadcastDispatcher([])],
                      barrier_manager=self.local, fragment=name)
        self.actors[actor_id] = actor
        self.readers[name] = readers
        self.local.set_expected_actors(list(self.actors))
        self.tasks[actor_id] = actor.spawn()
        # attach MV-on-MV chain edges now that the plan validated and
        # the downstream actor exists — the activation barrier below
        # must flow through these channels
        self.chain_edges[name] = list(attaches)
        for uid, out in attaches:
            d = self.actors[uid].dispatchers[0]
            d.update_outputs(d.outputs() + [out])
        await self._loop.inject_and_collect(force_checkpoint=True)
        return actor

    def _explain(self, sel: ast.Select) -> Rows:
        """EXPLAIN <select>: the planner's tree and the rewritten tree
        with per-rule annotations and lane stats. Plans against a
        throwaway barrier manager so nothing leaks."""
        from risingwave_tpu_torch.frontend.opt import (
            explain_with_rewrite, parse_fusion,
        )
        plan = self._planner(LocalBarrierManager(), self.mesh,
                             self.state_tier_cap or None).plan(
            "__explain__", sel, actor_id=0, rate_limit=self.rate_limit,
            min_chunks=self.min_chunks)
        return explain_with_rewrite(
            plan.consumer, self.session_vars.get("stream_rewrite_rules"),
            fusion=parse_fusion(self.session_vars.get("stream_fusion")),
            device=self.device)

    async def _create_mv(self, stmt: ast.CreateMaterializedView) -> str:
        from risingwave_tpu_torch.frontend.opt import (
            apply_rewrites, parse_fusion,
        )
        self.catalog._check_free(stmt.name)    # validate BEFORE planning
        async with self._barrier_lock:
            t0 = time.perf_counter()
            planner = self._planner(self.local, self.mesh,
                                    self.state_tier_cap or None)
            actor_id = self._next_actor
            self._next_actor += 1
            id_base = self.catalog._next_id
            rules = self.session_vars.get("stream_rewrite_rules")
            fusion = parse_fusion(self.session_vars.get("stream_fusion"))
            try:
                plan = planner.plan(
                    stmt.name, stmt.select, actor_id,
                    rate_limit=self.rate_limit,
                    min_chunks=self.min_chunks,
                    emit_on_window_close=getattr(
                        stmt, "emit_on_window_close", False))
                report = apply_rewrites(plan, rules, label=stmt.name,
                                        fusion=fusion, device=self.device)
            except BaseException:
                # a failed plan must leak nothing: source senders
                # registered during planning would wedge the next round
                for sid in planner.registered_senders:
                    self.local.drop_actor(sid)
                raise
            plan.mv.id_base = id_base
            self.mv_plan_seconds[stmt.name] = time.perf_counter() - t0
            self.mv_reports[stmt.name] = report
            actor = await self._deploy_job(
                stmt.name, actor_id, plan.consumer, plan.readers,
                lambda: self.catalog.add_mv(plan.mv),
                attaches=plan.attaches)
        self._mv_selects[stmt.name] = (
            stmt.select, getattr(stmt, "emit_on_window_close", False))
        self._mv_rules[stmt.name] = rules
        self._mv_fusion[stmt.name] = fusion
        # CREATE-time tier cap: reschedule replans under it (the cap
        # shapes join state-table pk layouts — id-base contract)
        self._mv_tier_caps[stmt.name] = self.state_tier_cap or None
        if actor.failure is not None:
            raise actor.failure
        return "CREATE_MATERIALIZED_VIEW"

    async def _create_table(self, stmt: ast.CreateTable) -> str:
        """CREATE TABLE: a DML-fed streaming job (DmlReader source →
        materialize) so table writes ride the barrier pipeline and MV
        chains over tables work like MV-on-MV (handler/create_table.rs
        + dml_manager.rs analog). No PRIMARY KEY → hidden _row_id."""
        from risingwave_tpu_torch.common.types import DataType, Field, Schema
        from risingwave_tpu_torch.connectors.dml import DmlReader, RowIdSeq
        from risingwave_tpu_torch.frontend.catalog import MvCatalog
        from risingwave_tpu_torch.state.state_table import StateTable
        from risingwave_tpu_torch.stream.exchange import channel_for_test
        from risingwave_tpu_torch.stream.executors.materialize import (
            MaterializeExecutor,
        )
        from risingwave_tpu_torch.stream.executors.source import SourceExecutor

        self.catalog._check_free(stmt.name)
        fields = []
        for cname, tname in stmt.columns:
            if any(f.name == cname for f in fields):
                raise PlanError(f"duplicate column {cname!r}")
            try:
                fields.append(Field(cname, DataType.from_sql(tname)))
            except KeyError:
                raise PlanError(f"unknown type {tname!r}")
        names = [f.name for f in fields]
        for c in stmt.pk_cols:
            if c not in names:
                raise PlanError(f"PRIMARY KEY column {c!r} not found")
        if stmt.pk_cols:
            schema = Schema(fields)
            pk = [names.index(c) for c in stmt.pk_cols]
            rowid = None
        else:
            schema = Schema(fields + [Field("_row_id",
                                            DataType.SERIAL)])
            pk = [len(fields)]
            rowid = RowIdSeq()
        async with self._barrier_lock:
            actor_id = self._next_actor
            self._next_actor += 1
            id_base = self.catalog._next_id
            sid = self.catalog.next_id()
            table_id = self.catalog.next_id()
            reader = DmlReader(schema)
            tx, rx = channel_for_test()
            self.local.register_sender(sid, tx)
            try:
                src = SourceExecutor(reader, rx, None, actor_id=sid)
                table = StateTable(table_id, schema, pk, self.store)
                mat = MaterializeExecutor(src, table)
                mv = MvCatalog(stmt.name, table_id, schema, pk,
                               definition="", actor_id=actor_id,
                               id_base=id_base,
                               n_visible=len(fields) if rowid is not None
                               else None, is_table=True)
                actor = await self._deploy_job(
                    stmt.name, actor_id, mat, {sid: reader},
                    lambda: self.catalog.add_mv(mv))
            except BaseException:
                self.local.drop_actor(sid)
                raise
        self._tables[stmt.name] = (reader, schema, pk, rowid,
                                   table_id)
        if actor.failure is not None:
            raise actor.failure
        return "CREATE_TABLE"

    async def _drop_table(self, stmt: ast.DropTable) -> str:
        if stmt.name not in self._tables:
            if stmt.if_exists and stmt.name not in self.catalog.mvs:
                return "DROP_TABLE"
            if stmt.name not in self.catalog.mvs:
                raise PlanError(f"unknown table {stmt.name!r}")
            raise PlanError(f"{stmt.name!r} is not a table")
        dependents = self._dependents(stmt.name)
        if dependents:
            raise PlanError(f"cannot drop table {stmt.name!r}: "
                            f"depended on by {dependents}")
        status = await self._drop_job(stmt.name, stmt.if_exists,
                                      "DROP_TABLE")
        self._tables.pop(stmt.name, None)
        return status

    def _table_job(self, name: str):
        job = self._tables.get(name)
        if job is None:
            raise PlanError(f"{name!r} is not a table")
        return job

    async def _insert(self, stmt: ast.Insert) -> str:
        """INSERT ... VALUES: evaluate rows, push one chunk through
        the table's DML channel, and return only after the checkpoint
        that makes it durable+visible commits (batch insert.rs)."""
        from risingwave_tpu_torch.common.chunk import DataChunk, StreamChunk
        from risingwave_tpu_torch.common.types import Schema
        from risingwave_tpu_torch.expr.expr import Cast
        from risingwave_tpu_torch.frontend.binder import Binder, Scope

        reader, schema, _pk, rowid, _tid = self._table_job(stmt.table)
        data_fields = list(schema)[:-1] if rowid is not None \
            else list(schema)
        if stmt.select is not None:
            # INSERT INTO t SELECT …: batch-evaluate over the latest
            # committed snapshot, then coerce column-wise
            from risingwave_tpu_torch.batch import collect
            ex = plan_batch(stmt.select, self.catalog, self.store,
                            self.store.committed_epoch(),
                            profiler=self._loop.profiler)
            if len(ex.schema) != len(data_fields):
                raise PlanError(
                    f"INSERT SELECT has {len(ex.schema)} columns, "
                    f"table has {len(data_fields)}")
            rows = self._coerce_rows(collect(ex), ex.schema,
                                     data_fields)
        else:
            from risingwave_tpu_torch.common.types import Field
            binder = Binder(Scope.of(Schema([]), None))
            one = DataChunk.empty(Schema([]), capacity=8)
            one.visibility[0] = True
            tmp_sch = Schema([Field(f"_c{i}", f.data_type)
                              for i, f in enumerate(data_fields)])
            rows = []
            for r in stmt.rows:
                if len(r) != len(data_fields):
                    raise PlanError(
                        f"INSERT row has {len(r)} values, table has "
                        f"{len(data_fields)} columns")
                cols = []
                for e_ast, f in zip(r, data_fields):
                    b = binder.bind(e_ast)
                    if b.return_type != f.data_type:
                        b = Cast(b, f.data_type)
                    cols.append(b.eval(one))
                # to_pylist converts physical->LOGICAL (DECIMAL
                # unscales, bools); from_pydict at the push site
                # expects logical values
                rows.append(DataChunk(tmp_sch, cols,
                                      one.visibility).to_pylist()[0])
        if not rows:
            return "INSERT 0 0"
        if rowid is not None:
            ids = rowid.take(self.store.committed_epoch(), len(rows))
            rows = [r + (i,) for r, i in zip(rows, ids)]
        data = {f.name: [r[i] for r in rows]
                for i, f in enumerate(schema)}
        reader.push(StreamChunk.from_pydict(schema, data))
        await self._dml_flush()
        return f"INSERT 0 {len(rows)}"

    async def _dml_flush(self) -> None:
        """Make a just-pushed DML chunk durable AND visible before the
        statement returns. Two barrier rounds: the table's source is
        parked on its barrier channel, so the first barrier always
        precedes the chunk (it re-arms generation for the next epoch)
        and the second seals + checkpoints the epoch that carried
        it."""
        await self._barrier(force_checkpoint=True)
        await self._barrier(force_checkpoint=True)

    @staticmethod
    def _coerce_rows(rows, src_schema, dst_fields) -> List[tuple]:
        """Column-wise cast of batch-select output (LOGICAL rows)
        onto table types; returns logical rows for the DML channel.
        Positional temp names, NOT the real ones: a SELECT output may
        carry duplicate column names (aliases, join sides) and a
        name-keyed build would silently collapse them. The chunk
        round trip keeps the value domain honest — from_pydict takes
        logical values physical, to_pylist brings the cast results
        back logical (DECIMAL scale, bools)."""
        from risingwave_tpu_torch.common.chunk import DataChunk
        from risingwave_tpu_torch.common.types import Field, Schema
        from risingwave_tpu_torch.expr.expr import Cast, InputRef

        if not rows:
            return []
        if all(s.data_type == d.data_type
               for s, d in zip(src_schema, dst_fields)):
            return [tuple(r) for r in rows]
        tmp_src = Schema([Field(f"_c{i}", f.data_type)
                          for i, f in enumerate(src_schema)])
        chunk = DataChunk.from_pydict(
            tmp_src, {f"_c{i}": [r[i] for r in rows]
                      for i in range(len(src_schema))})
        cols = [Cast(InputRef(i, s.data_type),
                     d.data_type).eval(chunk)
                for i, (s, d) in enumerate(zip(src_schema,
                                               dst_fields))]
        tmp_dst = Schema([Field(f"_c{i}", d.data_type)
                          for i, d in enumerate(dst_fields)])
        return DataChunk(tmp_dst, cols, chunk.visibility).to_pylist()

    def _snapshot_rows(self, table_id: int, schema, pk) -> List[tuple]:
        from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
        from risingwave_tpu_torch.state.state_table import StateTable

        from risingwave_tpu_torch.batch.storage_table import rows_to_chunk

        t = StateTable(table_id, schema, pk, self.store,
                       sanity_check=False)
        ce = self.store.committed_epoch()
        t.init_epoch(EpochPair(Epoch(ce + 1), Epoch(ce)))
        phys = [tuple(row) for _pk, row in t.iter_rows()]
        if not phys:
            return []
        # state rows are PHYSICAL (DECIMAL = scaled int64); everything
        # the DML channel re-ingests via from_pydict must be LOGICAL,
        # so convert through a chunk round trip
        return rows_to_chunk(schema, phys).to_pylist()

    def _match_rows(self, stmt_where, schema, rows):
        """The subset of rows a DML WHERE clause selects."""
        import numpy as np

        from risingwave_tpu_torch.common.chunk import DataChunk
        from risingwave_tpu_torch.frontend.binder import Binder, Scope

        if not rows:
            return []
        if stmt_where is None:
            return rows
        chunk = DataChunk.from_pydict(
            schema, {f.name: [r[i] for r in rows]
                     for i, f in enumerate(schema)})
        pred = Binder(Scope.of(schema, None)).bind(stmt_where)
        col = pred.eval(chunk)
        keep = np.asarray(col.values)[:len(rows)].astype(bool)
        if col.validity is not None:
            keep &= np.asarray(col.validity)[:len(rows)]
        return [r for r, k in zip(rows, keep) if k]

    async def _delete(self, stmt: ast.Delete) -> str:
        """DELETE: snapshot-scan the committed rows, push their
        retractions through the DML channel (batch delete.rs)."""
        from risingwave_tpu_torch.common.chunk import Op, StreamChunk

        reader, schema, pk, _rowid, tid = self._table_job(stmt.table)
        rows = self._match_rows(
            stmt.where, schema, self._snapshot_rows(tid, schema, pk))
        if rows:
            data = {f.name: [r[i] for r in rows]
                    for i, f in enumerate(schema)}
            reader.push(StreamChunk.from_pydict(
                schema, data, ops=[Op.DELETE] * len(rows)))
            await self._dml_flush()
        return f"DELETE {len(rows)}"

    async def _update(self, stmt: ast.Update) -> str:
        """UPDATE: snapshot-scan, re-evaluate SET expressions over the
        matching rows, push UpdateDelete/UpdateInsert pairs."""
        from risingwave_tpu_torch.common.chunk import (
            DataChunk, Op, StreamChunk,
        )
        from risingwave_tpu_torch.expr.expr import Cast
        from risingwave_tpu_torch.frontend.binder import Binder, Scope

        reader, schema, pk, rowid, tid = self._table_job(stmt.table)
        names = [f.name for f in schema]
        settable = names[:-1] if rowid is not None else names
        sets = []
        binder = Binder(Scope.of(schema, None))
        for col, e_ast in stmt.sets:
            if col not in settable:
                raise PlanError(f"column {col!r} not found")
            b = binder.bind(e_ast)
            dt = schema[names.index(col)].data_type
            if b.return_type != dt:
                b = Cast(b, dt)
            sets.append((names.index(col), b))
        rows = self._match_rows(
            stmt.where, schema, self._snapshot_rows(tid, schema, pk))
        if rows:
            chunk = DataChunk.from_pydict(
                schema, {f.name: [r[i] for r in rows]
                         for i, f in enumerate(schema)})
            from risingwave_tpu_torch.common.types import Field, Schema
            new_cols = {}
            for idx, b in sets:
                col = b.eval(chunk)
                one_sch = Schema([Field("_v",
                                        schema[idx].data_type)])
                new_cols[idx] = [r[0] for r in DataChunk(
                    one_sch, [col], chunk.visibility).to_pylist()]
            out_rows, ops = [], []
            new_pks = set()
            pk_touched = any(idx in pk for idx, _b in sets)
            for i, old in enumerate(rows):
                new = list(old)
                for idx, _b in sets:
                    new[idx] = new_cols[idx][i]
                if pk_touched:
                    kp = tuple(new[j] for j in pk)
                    if kp in new_pks:
                        # two updated rows landing on one key would
                        # collide inside a single chunk and kill the
                        # table's actor — fail the STATEMENT instead
                        raise PlanError(
                            "UPDATE would assign the primary key "
                            f"{kp!r} to more than one row")
                    new_pks.add(kp)
                out_rows += [old, tuple(new)]
                ops += [Op.UPDATE_DELETE, Op.UPDATE_INSERT]
            data = {f.name: [r[i] for r in out_rows]
                    for i, f in enumerate(schema)}
            reader.push(StreamChunk.from_pydict(schema, data,
                                                ops=ops))
            await self._dml_flush()
        return f"UPDATE {len(rows)}"

    async def _stop_job(self, name: str, actor_id: int):
        """Stop one job's actors at a barrier and remove its topology
        (caller holds the barrier lock). Returns the stopped Actor."""
        stop_ids = frozenset(self.readers.get(name, {}).keys()
                             | {actor_id})
        await self._loop.inject_and_collect(
            mutation=StopMutation(stop_ids))
        task = self.tasks.pop(actor_id, None)
        if task is not None:
            await task
        actor = self.actors.pop(actor_id, None)
        for sid in self.readers.pop(name, {}):
            self.local.drop_actor(sid)
        self.local.drop_actor(actor_id)
        # detach this job's chain edges from upstream dispatchers: an
        # orphan output would block the upstream on exhausted channel
        # permits a few barriers later
        for uid, out in self.chain_edges.pop(name, []):
            up = self.actors.get(uid)
            if up is not None and up.dispatchers:
                d = up.dispatchers[0]
                d.update_outputs(
                    [o for o in d.outputs() if o is not out])
        # with the edges detached, release the stopped chain's input
        # receivers
        if actor is not None:
            close_receivers(actor.consumer)
        self.local.set_expected_actors(list(self.actors))
        return actor

    def _dependents(self, name: str) -> List[str]:
        return [m.name for m in self.catalog.mvs.values()
                if name in m.dependent_sources]

    async def _drop_job(self, name: str, if_exists: bool,
                        status: str) -> str:
        """Shared drop path for MVs and tables: stop barrier + topology
        removal as ONE locked unit."""
        entry = self.catalog.mvs.get(name)
        if entry is None:
            if if_exists:
                return status
            raise PlanError(f"unknown object {name!r}")
        async with self._barrier_lock:
            actor = await self._stop_job(name, entry.actor_id)
        del self.catalog.mvs[name]
        self._forget_mv(name)
        if actor is not None and actor.failure is not None:
            raise actor.failure
        return status

    def _forget_mv(self, name: str) -> None:
        """Drop what CREATE recorded for the replay of one MV."""
        for m in (self._mv_selects, self._mv_rules, self._mv_fusion,
                  self._mv_tier_caps):
            m.pop(name, None)

    async def _alter_parallelism(self, stmt: ast.AlterParallelism) -> str:
        """Runtime reschedule (meta/stream/scale.rs:717
        reschedule_actors analog): stop the job at a barrier with its
        state kept, replan the SAME definition over the new mesh FROM
        THE SAME TABLE-ID BASE (state tables keep their ids, so the
        redeployed executors recover every group and row from them),
        then redeploy. The sharded kernels' vnode routing lands the
        reloaded state on its new owner shard."""
        from risingwave_tpu_torch.frontend.opt import apply_rewrites

        name, n = stmt.name, stmt.parallelism
        mv = self.catalog.mvs.get(name)
        if mv is None:
            raise PlanError(f"unknown materialized view {name!r}")
        if self._dependents(name) or any(
                d in self.catalog.mvs for d in mv.dependent_sources):
            raise PlanError(
                "ALTER ... SET PARALLELISM on chained MVs is not "
                "supported yet")
        if mv.id_base < 0:
            raise PlanError(f"{name!r} predates reschedule support")
        stored = self._mv_selects.get(name)
        if stored is None:
            raise PlanError(f"no CREATE statement on record for "
                            f"{name!r}")
        sel, eowc = stored
        mesh = self._mesh_for(n)
        async with self._barrier_lock:
            # 1) stop this job's actors at a barrier (state and catalog
            # kept: a pause, not a drop)
            old_actor = await self._stop_job(name, mv.actor_id)
            try:
                if old_actor is not None and \
                        old_actor.failure is not None:
                    raise old_actor.failure
                # 2) replan from the recorded id base → the same state
                # tables (the mesh branches allocate no ids)
                saved = self.catalog._next_id
                self.catalog._next_id = mv.id_base
                planner = self._planner(self.local, mesh,
                                        self._mv_tier_caps.get(name))
                actor_id = self._next_actor
                self._next_actor += 1
                try:
                    # the CREATE's flags: an EOWC gate allocates an id
                    plan = planner.plan(name, sel, actor_id,
                                        rate_limit=self.rate_limit,
                                        min_chunks=self.min_chunks,
                                        emit_on_window_close=eowc)
                    # the CREATE-time rules: the kept state tables carry
                    # the schemas that rewrite produced (pruned sides)
                    report = apply_rewrites(
                        plan, self._mv_rules.get(name, "all"),
                        label=name,
                        fusion=self._mv_fusion.get(name, False)
                        and mesh is None, device=self.device)
                except BaseException:
                    for sid in planner.registered_senders:
                        self.local.drop_actor(sid)
                    self.catalog._next_id = saved
                    raise
                self.catalog._next_id = max(saved,
                                            self.catalog._next_id)
                plan.mv.id_base = mv.id_base
                self.mv_reports[name] = report
                del self.catalog.mvs[name]
                # 3) redeploy; the executors recover from the kept tables
                actor = await self._deploy_job(
                    name, actor_id, plan.consumer, plan.readers,
                    lambda: self.catalog.add_mv(plan.mv),
                    attaches=plan.attaches)
            except BaseException as e:
                # the old pipeline is gone and cannot be restored:
                # degrade to DROPPED (state tables kept) rather than
                # leave a catalog entry that serves frozen results
                self.catalog.mvs.pop(name, None)
                self._forget_mv(name)
                raise PlanError(
                    f"reschedule of {name!r} failed after teardown — "
                    f"the MV was dropped (state retained): {e}") from e
        if actor.failure is not None:
            raise actor.failure
        return "ALTER_MATERIALIZED_VIEW"

    async def _drop_mv(self, stmt: ast.DropMaterializedView) -> str:
        if stmt.name in self._tables:
            # tables share catalog.mvs; dropping one here would orphan
            # its DML channel (writes then vanish into a dead reader)
            raise PlanError(
                f"{stmt.name!r} is a table — use DROP TABLE")
        dependents = self._dependents(stmt.name)
        if dependents:
            raise PlanError(
                f"cannot drop MV {stmt.name!r}: depended on by "
                f"{dependents}")
        return await self._drop_job(stmt.name, stmt.if_exists,
                                    "DROP_MATERIALIZED_VIEW")

    async def _select(self, sel: ast.Select) -> Rows:
        from risingwave_tpu_torch.batch import collect
        epoch = self.store.committed_epoch()
        ex = plan_batch(sel, self.catalog, self.store, epoch,
                        profiler=self._loop.profiler)
        self.last_select_schema = ex.schema
        return collect(ex)
