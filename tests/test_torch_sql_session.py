"""The port's SQL session against the reference's: knobs, system tables,
state tables by id, the barrier loop's session half, and the refusals.

- ``tests/test_session_config.py``'s cases that need no table or DML
  run as twins (its two CREATE TABLE cases are twinned in
  ``tests/test_torch_table_dml.py``), and ``SHOW ALL`` lists the
  reference's names and defaults — but one, the declared deviation:
  ``stream_epoch_pipeline`` is ``off`` (the port runs one barrier loop).
- Nexmark q4 and TPC-H q3 written in SQL: every state table, by table id,
  equal to the reference's (the sources' splits, both join sides, the
  aggs, the TopN, the MV), with both packages' epoch clocks held still
  so the generated row ids agree, and the reference on its one-loop arm
  (``epoch_pipeline=False``; domains mint other epochs). The MV rows are
  also held to the reference under its default (domains on). q4's inner
  MAX plans K2's append-only path, its outer AVG the retractable one.
- ``checkpoint_frequency``, ``schedule_mutation`` and the profiler's
  ``drop_first`` behave as the reference's one-loop arm.
- Each statement, knob and planner keyword of a later item raises
  ``NotImplementedError`` naming it, and with no card the session raises
  instead of running on the CPU.
"""

import asyncio

import pytest
import torch

import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu_torch.common.epoch as p_epoch
from risingwave_tpu.frontend.planner import PlanError as RefPlanError
from risingwave_tpu_torch.frontend.opt import apply_rewrites
from risingwave_tpu_torch.frontend.opt.fusion import fuse_fragments
from risingwave_tpu_torch.frontend.parser import parse
from risingwave_tpu_torch.frontend.planner import PlanError, StreamPlanner
from risingwave_tpu_torch.stream.actor import LocalBarrierManager
from risingwave_tpu_torch.frontend.session import Frontend
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    Q4, Raises, _port_strict_checker, frontend, nexmark_source, run_both,
    run_script,
)

BID = nexmark_source("bid", 2000)


# -- tests/test_session_config.py twins -----------------------------------


def test_set_show_session_vars_twin():
    out = run_both([
        "SET streaming_rate_limit = 4", "SHOW streaming_rate_limit",
        "SET application_name = 'psql-test'", "SHOW application_name",
        "SET streaming_rate_limit TO default",
        "SHOW streaming_rate_limit",
        Raises("SET no_such_var = 1"), Raises("SHOW no_such_var")],
        min_chunks=4)
    assert out[1] == [("4",)] and out[3] == [("psql-test",)]
    assert out[6][1] == out[7][1] == "PlanError"


def test_show_all_lists_the_reference_knobs():
    """Same names and defaults; the one declared deviation is
    stream_epoch_pipeline (the port's one loop: off)."""
    ref = dict(run_script("ref", ["SHOW ALL"], min_chunks=4)[0][0])
    port = dict(run_script("port", ["SHOW ALL"], min_chunks=4)[0][0])
    assert sorted(port) == sorted(ref)
    assert ref.pop("stream_epoch_pipeline") == "on"
    assert port.pop("stream_epoch_pipeline") == "off"
    assert port == ref


def test_set_vars_bind_to_new_jobs_twin():
    """SET join_state_cap lands on the next join's sides."""
    def caps(fe):
        join = None
        for a in fe.actors.values():
            ex = a.consumer
            while ex is not None and not hasattr(ex, "sides"):
                ex = getattr(ex, "inner", None) or getattr(ex, "input",
                                                           None)
            if ex is not None:
                join = ex
        return [s.state_cap for s in join.sides]
    script = [nexmark_source("person", 2000),
              nexmark_source("auction", 2000), "SET join_state_cap = 32",
              "CREATE MATERIALIZED VIEW j AS SELECT p.id FROM person "
              "AS p JOIN auction AS a ON p.id = a.seller", 3,
              "SELECT * FROM j"]
    run_both(script, min_chunks=4)
    for pkg in ("ref", "port"):
        _out, _t, got = run_script(pkg, script, hook=caps, min_chunks=4,
                                   rate_limit=4)
        assert got == [32, 32], pkg


def test_system_catalog_tables_twin():
    out = run_both([
        BID, "CREATE MATERIALIZED VIEW m AS SELECT auction, count(*) "
        "AS c FROM bid GROUP BY auction", 2,
        "SELECT name FROM rw_materialized_views",
        "SELECT name, connector FROM rw_sources",
        "SELECT count(*) AS n FROM rw_sources",
        "SELECT name, table_id, actor_id FROM rw_materialized_views",
        "SELECT count(*) AS n FROM rw_barrier_latency",
        "SELECT kind FROM rw_barrier_latency"], min_chunks=4)
    assert out[2] == [("m",)] and out[4] == [(1,)]
    assert out[6][0][0] > 0


def test_set_string_unescaping_twin():
    out = run_both(["SET application_name = 'it''s'",
                    "SHOW application_name"], min_chunks=4)
    assert out[1] == [("it's",)]


def test_scalar_args_must_be_constant_twin():
    out = run_both([
        nexmark_source("bid", 500),
        Raises("CREATE MATERIALIZED VIEW b AS SELECT "
               "substr(url, auction) AS s FROM bid"),
        Raises("CREATE MATERIALIZED VIEW b AS SELECT "
               "split_part(url, channel, 1) AS s FROM bid")],
        min_chunks=4)
    assert "constant" in out[1][2] and "constant" in out[2][2]


def test_filter_on_non_aggregate_rejected_twin():
    out = run_both([
        nexmark_source("bid", 500),
        Raises("CREATE MATERIALIZED VIEW b AS SELECT channel, "
               "upper(channel) FILTER (WHERE price > 0) AS u "
               "FROM bid GROUP BY channel")], min_chunks=4)
    assert "not an aggregate" in out[1][2]


def test_string_and_date_functions_match_reference():
    """The host-typed half of expr/expr.py: the ten functions and the
    VARCHAR casts, through SQL, equal to the reference's."""
    out = run_both([
        nexmark_source("bid", 1000),
        "CREATE MATERIALIZED VIEW f AS SELECT auction, lower(channel) "
        "AS lo, upper(channel) AS up, char_length(url) AS n, "
        "length(channel) AS n2, substr(url, 3, 5) AS sb, "
        "split_part(url, '/', 3) AS sp, replace(channel, 'a', 'A') "
        "AS rp, concat(channel, '-', url) AS cc, "
        "to_char(date_time, 'YYYY-MM-DD HH24:MI:SS') AS tc, "
        "date_part('minute', date_time) AS dp, date_part('day', "
        "date_time) AS dd, date_trunc('hour', date_time) AS dt, "
        "CAST(price AS VARCHAR) AS pv, CAST(CAST(price AS VARCHAR) "
        "AS BIGINT) AS pb, CAST(date_time AS VARCHAR) AS tv FROM bid",
        4, "SELECT * FROM f",
        "SELECT CAST('12.5' AS DECIMAL) + 1 AS d, "
        "CAST('2024-01-02 03:04:05' AS TIMESTAMP) AS t, "
        "CAST('true' AS BOOLEAN) AS b"], min_chunks=4)
    assert out[2] and out[3]


# -- q4 and q3 in SQL: state tables by id ----------------------------------


@pytest.fixture
def still_clock(monkeypatch):
    """Both packages' epoch clocks held at one millisecond: epochs step
    by their sequence, so the row ids (epoch-derived) agree."""
    for mod in (r_epoch, p_epoch):
        monkeypatch.setattr(mod, "physical_now_ms", lambda: 1_000_000)


def _agg_modes(fe):
    """append_only of every hash agg of every MV's plan, top down."""
    modes = []

    def walk(ex):
        ex = getattr(ex, "inner", None) or ex
        if type(ex).__name__ == "HashAggExecutor":
            modes.append(bool(ex.append_only))
        for attr in ("input", "left_in", "right_in"):
            c = getattr(ex, attr, None)
            if c is not None and hasattr(c, "execute"):
                walk(c)
    for a in fe.actors.values():
        walk(a.consumer)
    return modes


def _tables_twin(script, **kw):
    """(port results, port tables, port agg modes) with every state
    table equal to the reference's one-loop arm, by id."""
    ref = run_script("ref", script, tables=True, hook=_agg_modes,
                     epoch_pipeline=False, **kw)
    port = run_script("port", script, tables=True, hook=_agg_modes, **kw)
    assert port[0] == ref[0]
    assert sorted(port[1]) == sorted(ref[1])
    for tid in ref[1]:
        assert port[1][tid] == ref[1][tid], f"state table {tid}"
    assert port[2] == ref[2]
    return port


def test_q4_state_tables_equal_reference_by_id(still_clock):
    script = [nexmark_source("auction", 8000, chunk=256),
              nexmark_source("bid", 8000, chunk=256), Q4, 14,
              "SELECT * FROM q4"]
    out, tables, modes = _tables_twin(script, rate_limit=4, min_chunks=4)
    assert out[-1]
    # sources' splits and offsets, two join sides, two aggs, the MV
    assert len(tables) >= 7
    # the outer AVG takes the inner agg's U-/U+: retractable; the inner
    # MAX over an inner join of append-only sources: append-only
    assert modes == [False, True]
    # the MV rows also equal the reference's under its default (domains)
    run_both(script, rate_limit=4, min_chunks=4)


Q3_SQL = (
    "CREATE MATERIALIZED VIEW q3 AS SELECT "
    "o.o_orderkey, o.o_orderdate, o.o_shippriority, "
    "sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
    "FROM customer AS c "
    "JOIN orders AS o ON c.c_custkey = o.o_custkey "
    "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
    "WHERE c.c_mktsegment = 'BUILDING' "
    "AND o.o_orderdate < 9204 AND l.l_shipdate > 9204 "
    "GROUP BY o.o_orderkey, o.o_orderdate, o.o_shippriority "
    "ORDER BY revenue DESC, o_orderdate ASC LIMIT 10")


def tpch_sources(customers, orders):
    return [f"CREATE SOURCE {t} WITH (connector='tpch', tpch.table='{t}', "
            f"tpch.customers={customers}, tpch.orders={orders})"
            for t in ("customer", "orders", "lineitem")]


def test_q3_sql_state_tables_equal_reference_by_id(still_clock):
    """tests/test_tpch.py:72's statement (300 customers, 3,000 orders),
    fused as the session defaults, and its EXPLAIN."""
    script = tpch_sources(300, 3000) + [
        Q3_SQL, 30,
        "SELECT o_orderkey, o_orderdate, o_shippriority, revenue "
        "FROM q3 ORDER BY revenue DESC, o_orderkey",
        "EXPLAIN SELECT o.o_orderkey FROM customer AS c "
        "JOIN orders AS o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
        "WHERE c.c_mktsegment = 'BUILDING'"]
    out, tables, modes = _tables_twin(script, rate_limit=8, min_chunks=8)
    assert len(out[4]) == 10
    assert modes == [True]
    assert len(tables) >= 9


# -- the barrier loop's session half --------------------------------------


def _pipelined_kinds(pkg):
    """Barrier kinds of 7 plain (unforced) rounds at frequency 3, and
    what a SELECT sees between checkpoints."""
    async def run():
        fe = frontend(pkg, min_chunks=2, rate_limit=2,
                      **({} if pkg == "port" else
                         {"epoch_pipeline": False}))
        await fe.execute(nexmark_source("bid", 4000, chunk=64))
        await fe.execute("SET stream_checkpoint_frequency = 3")
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT auction "
                         "FROM bid")
        seen = []
        for _ in range(7):
            await fe.loop.inject()
            await fe.loop.collect_next()
            rows = await fe.execute("SELECT count(*) FROM m")
            seen.append(rows[0][0] if rows else 0)
        kinds = [r[0] for r in
                 await fe.execute("SELECT kind FROM rw_barrier_latency")]
        n = len(fe.loop.profiler.profiles)
        fe.loop.profiler.drop_first(2)
        dropped = len(fe.loop.profiler.profiles)
        await fe.close()
        return kinds, seen, (n, dropped)
    return asyncio.run(run())


def test_checkpoint_frequency_and_drop_first_match_reference():
    port = _pipelined_kinds("port")
    ref = _pipelined_kinds("ref")
    assert port == ref
    kinds, seen, (n, dropped) = port
    assert kinds.count("barrier") > 0 and dropped == n - 2
    # the MV is read at the committed epoch: it moves only at checkpoints
    assert len(set(seen)) < len(seen)


def _paused_counts(pkg):
    async def run():
        if pkg == "port":
            from risingwave_tpu_torch.stream.message import (
                PauseMutation, ResumeMutation,
            )
            fe = frontend(pkg, min_chunks=2, rate_limit=2)
        else:
            from risingwave_tpu.stream.message import (
                PauseMutation, ResumeMutation,
            )
            fe = frontend(pkg, min_chunks=2, rate_limit=2,
                          epoch_pipeline=False)
        await fe.execute(nexmark_source("bid", 4000, chunk=64))
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT auction "
                         "FROM bid")
        counts = []
        for mutation in (None, PauseMutation(), None, ResumeMutation(),
                         None):
            if mutation is not None:
                fe.loop.schedule_mutation(mutation)
            await fe.step(2)
            counts.append((await fe.execute(
                "SELECT count(*) FROM m"))[0][0])
        await fe.close()
        return counts
    return asyncio.run(run())


def test_schedule_mutation_pauses_and_resumes_like_reference():
    port = _paused_counts("port")
    assert port == _paused_counts("ref")
    assert port[1] == port[2] < port[4]


# -- refusals ---------------------------------------------------------------


SEGMENTED = ("CREATE SOURCE f (a BIGINT) WITH (connector='filelog', "
             "path='/nonexistent', topic='t', segmented='true'); "
             "CREATE MATERIALIZED VIEW mf AS SELECT a FROM f")


@pytest.mark.parametrize("sql,item", [
    ("CREATE SINK s FROM m WITH (connector='blackhole')", "13"),
    ("DROP SINK s", "13"),
    (SEGMENTED, "13"),
    ("SET stream_epoch_pipeline = on", "12"),
    ("SET stream_epoch_pipeline = true", "12"),
    ("SET stream_trace = off", "12"),
    ("SET stream_ledger = off", "12"),
    ("SET stream_tricolor = off", "12"),
    ("SET stream_costs = off", "12"),
    ("SET storage_compaction = 'dedicated'", "11"),
    ("SELECT * FROM rw_actor_metrics", "12"),
    ("SELECT * FROM rw_state_tier", "12"),
    ("SELECT * FROM rw_mv_freshness", "12"),
    ("SELECT * FROM rw_hot_keys", "12"),
    ("SELECT * FROM rw_kernel_costs", "12"),
    ("SELECT * FROM rw_recovery", "12"),
    ("SELECT * FROM rw_compaction", "11"),
    ("SELECT * FROM rw_sinks", "13"),
])
def test_left_out_statements_raise_naming_their_item(sql, item):
    async def run():
        fe = Frontend(device="cpu")
        await fe.execute(BID)
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT auction "
                         "FROM bid")
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP\.md queue A item {item}\)"):
            await fe.execute(sql)
        # the session goes on after a refusal
        await fe.step(1)
        await fe.close()
    asyncio.run(run())


def test_left_out_plans_raise_naming_their_item():
    """A plan that reaches a left-out reader after it planned a source
    and a chain over an MV raises naming the item, and leaks neither:
    no sender wedges the next barriers, no edge sits on m's
    dispatcher."""
    async def run():
        fe = Frontend(device="cpu")
        await fe.execute(BID)
        await fe.execute(nexmark_source("auction", 2000))
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT auction, "
                         "price FROM bid")
        await fe.execute("CREATE SOURCE f (a BIGINT) WITH ("
                         "connector='filelog', path='/nonexistent', "
                         "topic='t', segmented='true')")
        for sql in ("CREATE MATERIALIZED VIEW m2 AS SELECT f.a FROM f",
                    "CREATE MATERIALIZED VIEW t AS SELECT a.id FROM "
                    "auction AS a JOIN m ON a.id = m.auction "
                    "JOIN f ON f.a = a.id"):
            with pytest.raises(NotImplementedError,
                               match=r"ROADMAP\.md queue A item 13\)"):
                await fe.execute(sql)
        up = fe.actors[fe.catalog.mvs["m"].actor_id]
        assert up.dispatchers[0].outputs() == []
        # a refused plan leaked no sender: barriers still flow
        await asyncio.wait_for(fe.step(3), timeout=30)
        assert (await fe.execute("SELECT count(*) FROM m"))[0][0] > 0
        # the reference's distributed-plan keywords: any value but the
        # default names its item (the defaults plan as before)
        for kw, item in (({"dist_parallelism": 2}, "10d"),
                         ({"inline_mvs": {"m": None}}, "13")):
            with pytest.raises(NotImplementedError,
                               match=rf"ROADMAP\.md queue A item {item}\)"):
                StreamPlanner(fe.catalog, fe.store, fe.local,
                              definition="", device="cpu", **kw)
        plan = StreamPlanner(fe.catalog, fe.store, LocalBarrierManager(),
                             definition="", device="cpu",
                             dist_parallelism=1, inline_mvs={}).plan(
            "x", parse("SELECT auction, count(*) AS c FROM bid GROUP BY "
                       "auction"), actor_id=0)
        # so do the rewrite's and the fusion rule's
        for call in (lambda: apply_rewrites(plan, "all", fusion=True,
                                            dist_parallelism=2,
                                            device="cpu"),
                     lambda: fuse_fragments(plan.consumer,
                                            dist_parallelism=4,
                                            device="cpu")):
            with pytest.raises(NotImplementedError,
                               match=r"ROADMAP\.md queue A item 10d\)"):
                call()
        await fe.close()
    asyncio.run(run())


@pytest.mark.parametrize("kw,item", [
    ({"parallelism": 4, "epoch_pipeline": True}, "12"),
    ({"epoch_pipeline": True}, "12"),
])
def test_left_out_session_options_raise(kw, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md queue A item {item}\)"):
        Frontend(device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=r"item 11\)"):
        Frontend(store=object(), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 11\)"):
        asyncio.run(Frontend(device="cpu").recover())


def test_frontend_runs_on_the_card_unless_asked_for_the_cpu():
    """No device means the card; with none, the session raises rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        assert Frontend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Frontend()
    assert Frontend(device="cpu").device.type == "cpu"


def test_plan_error_is_the_reference_kind():
    """PlanError stays a ValueError, as the reference's."""
    assert issubclass(PlanError, ValueError)
    assert issubclass(RefPlanError, ValueError)
