"""Frontend session: the run-one-query loop + streaming-job deployment.

Port of ``risingwave_tpu/frontend/session.py``'s ``Frontend`` for one
device and one barrier domain (reference parity: pgwire's
``Session::run_one_query``, the per-statement handlers and the meta
DdlController collapsed into one in-process object). It takes SQL text
and runs it: ``CREATE SOURCE`` over the ``nexmark`` and ``tpch``
connectors, ``CREATE MATERIALIZED VIEW`` deployed as the port's
executors on the card's kernels, ``FLUSH``, ``SELECT`` through the batch
engine, ``EXPLAIN``, ``SET`` / ``SHOW``, ``DROP MATERIALIZED VIEW`` /
``DROP SOURCE``, and ``step`` / ``close``. The entry point is the
reference's: ``Frontend(...)`` then ``await fe.execute(sql)``.

Every MV's keyed executors run on the session's ``device``: the card
unless the caller passes ``device="cpu"`` (``utils/device.py``
``resolve_device``); with no card and no ``device``, construction
raises.

What this session leaves to later items, each refused with
``NotImplementedError`` naming its ``ROADMAP.md`` item: tables and DML,
MV on MV, the temporal join in SQL, ``parallelism > 1``, ``ALTER ... SET
PARALLELISM`` and the ``datagen`` / ``filelog`` connectors (10b); any
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
    "CreateTable": ("CREATE TABLE", "10b"),
    "DropTable": ("DROP TABLE", "10b"),
    "Insert": ("INSERT", "10b"),
    "Delete": ("DELETE", "10b"),
    "Update": ("UPDATE", "10b"),
    "AlterParallelism": ("ALTER ... SET PARALLELISM", "10b"),
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
        if parallelism > 1:
            raise not_ported("parallelism > 1", "10b")
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
        # unified state-tiering cap (state/tier.py); None/0 = unbounded
        self.state_tier_cap: Optional[int] = None
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
        # shape its state tables, so a reschedule (item 10b) and a DDL
        # replay (item 11) must re-plan under the same ones
        self._mv_rules: Dict[str, str] = {}
        self._mv_fusion: Dict[str, bool] = {}
        # what each CREATE cost and did: planning + rewrite seconds and
        # the rewrite report (rules fired, fusion groups, fallbacks)
        self.mv_plan_seconds: Dict[str, float] = {}
        self.mv_reports: Dict[str, object] = {}
        self._next_actor = 1000
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
            if getattr(stmt, "from_mv", None):
                raise not_ported("MV on MV", "10b")
            return await self._create_mv(stmt)
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
            if stmt.what in ("sinks", "tables"):
                return []
            return [(n,) for n in sorted(self.catalog.mvs)]
        if isinstance(stmt, ast.Flush):
            await self._barrier(force_checkpoint=True)
            return "FLUSH"
        if isinstance(stmt, ast.Select):
            return await self._select(stmt)
        raise PlanError(f"unhandled statement {stmt!r}")

    # -- handlers ---------------------------------------------------------
    def _planner(self, local) -> StreamPlanner:
        return StreamPlanner(self.catalog, self.store, local,
                             definition="",
                             join_state_cap=self.join_state_cap,
                             state_tier_cap=self.state_tier_cap or None,
                             chunk_target_rows=self.chunk_target_rows,
                             coalesce_linger_chunks=self
                             .coalesce_linger_chunks,
                             device=self.device)

    async def _deploy_job(self, name: str, actor_id: int, consumer,
                          readers, register) -> Actor:
        """Deployment tail, run under the barrier lock the caller holds:
        register, spawn the actor, then the activation barrier."""
        register()                    # catalog entry (duplicate check)
        actor = Actor(actor_id, consumer, barrier_manager=self.local,
                      fragment=name)
        self.actors[actor_id] = actor
        self.readers[name] = readers
        self.local.set_expected_actors(list(self.actors))
        self.tasks[actor_id] = actor.spawn()
        await self._loop.inject_and_collect(force_checkpoint=True)
        return actor

    def _explain(self, sel: ast.Select) -> Rows:
        """EXPLAIN <select>: the planner's tree and the rewritten tree
        with per-rule annotations and lane stats. Plans against a
        throwaway barrier manager so nothing leaks."""
        from risingwave_tpu_torch.frontend.opt import (
            explain_with_rewrite, parse_fusion,
        )
        plan = self._planner(LocalBarrierManager()).plan(
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
            planner = self._planner(self.local)
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
                lambda: self.catalog.add_mv(plan.mv))
        self._mv_rules[stmt.name] = rules
        self._mv_fusion[stmt.name] = fusion
        if actor.failure is not None:
            raise actor.failure
        return "CREATE_MATERIALIZED_VIEW"

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
        if actor is not None:
            close_receivers(actor.consumer)
        self.local.set_expected_actors(list(self.actors))
        return actor

    async def _drop_mv(self, stmt: ast.DropMaterializedView) -> str:
        entry = self.catalog.mvs.get(stmt.name)
        if entry is None:
            if stmt.if_exists:
                return "DROP_MATERIALIZED_VIEW"
            raise PlanError(f"unknown object {stmt.name!r}")
        async with self._barrier_lock:
            actor = await self._stop_job(stmt.name, entry.actor_id)
        del self.catalog.mvs[stmt.name]
        self._mv_rules.pop(stmt.name, None)
        self._mv_fusion.pop(stmt.name, None)
        if actor is not None and actor.failure is not None:
            raise actor.failure
        return "DROP_MATERIALIZED_VIEW"

    async def _select(self, sel: ast.Select) -> Rows:
        from risingwave_tpu_torch.batch import collect
        epoch = self.store.committed_epoch()
        ex = plan_batch(sel, self.catalog, self.store, epoch,
                        profiler=self._loop.profiler)
        self.last_select_schema = ex.schema
        return collect(ex)
