"""The port's executor rewrite rules against the reference's.

Twins of ``tests/test_plan_rewrite.py``'s rule cases: the rule units
over hand-built chains (the same fire counts and shapes), the checker's
fallback and strict mode, ``parse_rules``, the rewrites-on-vs-off
oracle over Nexmark q1/q4/q7/q8 and TPC-H q3/q5 (the port's rows equal
with rules on and off, and equal to the reference's), the carried-lane
counts, the join-kind gate of filter pushdown, ``EXPLAIN``'s text, the
narrowed join state tables and ``rw_plan_rewrites``. Each planned tree
is rewritten by both packages and held equal: the same ``EXPLAIN`` lines
and the same report (fire counts, details, fallbacks). Left to later
items: the DDL-log replay of the rule spec (``ROADMAP.md`` item 11),
the rule counters (item 12) and the fragment rules with the distributed
plan (item 10d).
"""

import asyncio

import pytest

import risingwave_tpu.frontend.opt as r_opt
import risingwave_tpu_torch.frontend.opt as p_opt
from risingwave_tpu_torch.common.types import DataType, Schema
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    _port_strict_checker, explain_body, frontend, nexmark_source, run_both,
)

SCHEMA = Schema.of(k=DataType.INT64, v=DataType.INT64)


# -- rule units over hand-built chains (the port's executors) ---------------


def _mat(consumer_input):
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.materialize import (
        MaterializeExecutor,
    )
    table = StateTable(1, consumer_input.schema, [0], MemoryStateStore())
    return MaterializeExecutor(consumer_input, table)


def _ref(k):
    from risingwave_tpu_torch.expr.expr import InputRef
    return InputRef(k, DataType.INT64)


def test_noop_project_elision_unit():
    from risingwave_tpu_torch.stream.executors import MockSource
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
    src = MockSource(SCHEMA, [])
    root = _mat(ProjectExecutor(src, [_ref(0), _ref(1)], ["k", "v"]))
    new_root, report = p_opt.rewrite_stream_plan(
        root, "noop_project_elision", record=False)
    assert report.fired == {"noop_project_elision": 1}
    assert new_root.input is src


def test_noop_project_with_renamed_column_stays():
    from risingwave_tpu_torch.stream.executors import MockSource
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
    src = MockSource(SCHEMA, [])
    root = _mat(ProjectExecutor(src, [_ref(0), _ref(1)], ["k", "v2"]))
    _new, report = p_opt.rewrite_stream_plan(
        root, "noop_project_elision", record=False)
    assert not report.fired


def test_project_fusion_unit():
    from risingwave_tpu_torch.expr.expr import BinaryOp
    from risingwave_tpu_torch.stream.executors import MockSource
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor
    src = MockSource(SCHEMA, [])
    p1 = ProjectExecutor(src, [_ref(0), BinaryOp("+", _ref(1), _ref(0))],
                         ["k", "s"])
    p2 = ProjectExecutor(p1, [_ref(1)], ["s"])
    new_root, report = p_opt.rewrite_stream_plan(
        _mat(p2), "project_fusion", record=False)
    assert report.fired.get("project_fusion") == 1
    fused = new_root.input
    assert isinstance(fused, ProjectExecutor) and fused.input is src
    assert [f.name for f in fused.schema] == ["s"]


def test_checker_fallback_and_strict_mode():
    import copy

    from risingwave_tpu_torch.stream.executors import MockSource
    from risingwave_tpu_torch.stream.executors.simple import ProjectExecutor

    def broken_rule(root):
        new = copy.copy(root)
        new.input = ProjectExecutor(root.input, [_ref(0)], ["k"])
        return new, 1, "oops"

    root = _mat(MockSource(SCHEMA, []))
    p_opt.set_strict_checker(False)
    try:
        new_root, report = p_opt.rewrite_stream_plan(
            root, "none", record=False,
            extra_rules={"broken": broken_rule})
        assert new_root is root
        assert report.fallbacks and report.fallbacks[0][0] == "broken"
    finally:
        p_opt.set_strict_checker(True)
    with pytest.raises(AssertionError, match="broken"):
        p_opt.rewrite_stream_plan(root, "none", record=False,
                                  extra_rules={"broken": broken_rule})


def test_parse_rules_validation_matches_reference():
    for spec in ("all", None, "none", "column_pruning, filter_pushdown",
                 "exchange_elision", ""):
        assert p_opt.parse_rules(spec) == r_opt.parse_rules(spec)
    assert p_opt.RULE_NAMES == r_opt.RULE_NAMES
    for pkg in (p_opt, r_opt):
        with pytest.raises(ValueError, match="unknown rewrite rule"):
            pkg.parse_rules("no_such_rule")
        for bad in ("maybe",):
            with pytest.raises(ValueError, match="stream_fusion"):
                pkg.parse_fusion(bad)
        assert pkg.parse_fusion("OFF") is False


# -- SQL-level rule behavior ------------------------------------------------


NEXMARK_SOURCES = [
    nexmark_source(t, 2000, chunk=128,
                   extra=", nexmark.generate.strings='false'")
    for t in ("bid", "auction", "person")
]

TPCH_SOURCES = [
    ("CREATE SOURCE {t} WITH (connector='tpch', tpch.table='{t}', "
     "tpch.customers=150, tpch.orders=1500)").format(t=t)
    for t in ("customer", "orders", "lineitem", "supplier", "nation",
              "region")
]

TPCH_Q5 = (
    "CREATE MATERIALIZED VIEW q AS SELECT n.n_name, "
    "sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
    "FROM customer AS c "
    "JOIN orders AS o ON c.c_custkey = o.o_custkey "
    "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
    "JOIN supplier AS s ON l.l_suppkey = s.s_suppkey "
    "AND c.c_nationkey = s.s_nationkey "
    "JOIN nation AS n ON s.s_nationkey = n.n_nationkey "
    "JOIN region AS r ON n.n_regionkey = r.r_regionkey "
    "WHERE r.r_name = 'ASIA' AND o.o_orderdate < 9500 "
    "GROUP BY n.n_name")

TPCH_Q3 = (
    "CREATE MATERIALIZED VIEW q AS SELECT "
    "o.o_orderkey, o.o_orderdate, o.o_shippriority, "
    "sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
    "FROM customer AS c "
    "JOIN orders AS o ON c.c_custkey = o.o_custkey "
    "JOIN lineitem AS l ON o.o_orderkey = l.l_orderkey "
    "WHERE c.c_mktsegment = 'BUILDING' "
    "AND o.o_orderdate < 9204 AND l.l_shipdate > 9204 "
    "GROUP BY o.o_orderkey, o.o_orderdate, o.o_shippriority "
    "ORDER BY revenue DESC, o_orderdate ASC LIMIT 10")

NEXMARK_Q1 = ("CREATE MATERIALIZED VIEW q AS SELECT auction, bidder, "
              "price * 89 AS price_dol, date_time FROM bid")

NEXMARK_Q4 = (
    "CREATE MATERIALIZED VIEW q AS "
    "SELECT category, AVG(final) AS avg_final FROM ("
    "  SELECT a.category AS category, MAX(b.price) AS final"
    "  FROM auction AS a JOIN bid AS b ON a.id = b.auction"
    "  WHERE b.date_time BETWEEN a.date_time AND a.expires"
    "  GROUP BY a.id, a.category) AS q4i "
    "GROUP BY category")

NEXMARK_Q7 = (
    "CREATE MATERIALIZED VIEW q AS "
    "SELECT window_start, MAX(price) AS max_price, COUNT(*) AS cnt "
    "FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND) "
    "GROUP BY window_start")

NEXMARK_Q8 = (
    "CREATE MATERIALIZED VIEW q AS "
    "SELECT p.id, p.name, p.window_start "
    "FROM TUMBLE(person, date_time, INTERVAL '10' SECOND) AS p "
    "JOIN TUMBLE(auction, date_time, INTERVAL '10' SECOND) AS a "
    "ON p.id = a.seller AND p.window_start = a.window_start")

CASES = [
    ("nexmark_q1", NEXMARK_SOURCES, NEXMARK_Q1),
    ("nexmark_q4", NEXMARK_SOURCES, NEXMARK_Q4),
    ("nexmark_q7", NEXMARK_SOURCES, NEXMARK_Q7),
    ("nexmark_q8", NEXMARK_SOURCES, NEXMARK_Q8),
    ("tpch_q3", TPCH_SOURCES, TPCH_Q3),
    ("tpch_q5", TPCH_SOURCES, TPCH_Q5),
]


@pytest.mark.parametrize("name,sources,mv", CASES,
                         ids=[c[0] for c in CASES])
def test_oracle_equivalence_rewrites_on_vs_off(name, sources, mv):
    """Rewrites change how rows are computed, never which: the port's
    MV with rules on equals its MV with rules off, and each equals the
    reference's under the same spec."""
    rows = {}
    for rules in ("none", "all"):
        out = run_both([f"SET stream_rewrite_rules = '{rules}'",
                        *sources, mv, 16, "SELECT * FROM q"],
                       rate_limit=16, min_chunks=16)
        rows[rules] = sorted(out[-1])
    assert rows["all"] == rows["none"], name
    assert rows["all"], f"{name} produced no output at this scale"


def _planned(pkg, sources, mv_sql, rules, fusion=False):
    """(lane stats, EXPLAIN lines, report summary) of one package's
    rewrite of the planned tree, without deploying it."""
    mod = p_opt if pkg == "port" else r_opt
    if pkg == "port":
        from risingwave_tpu_torch.frontend import ast as _ast
        from risingwave_tpu_torch.frontend.parser import parse_many
        from risingwave_tpu_torch.frontend.planner import (
            StreamPlanner, explain_tree,
        )
        from risingwave_tpu_torch.stream.actor import LocalBarrierManager
    else:
        from risingwave_tpu.frontend import ast as _ast
        from risingwave_tpu.frontend.parser import parse_many
        from risingwave_tpu.frontend.planner import (
            StreamPlanner, explain_tree,
        )
        from risingwave_tpu.stream.actor import LocalBarrierManager

    async def main():
        fe = frontend(pkg, rate_limit=16, min_chunks=16)
        for s in sources:
            await fe.execute(s)
        [(_text, stmt)] = parse_many(mv_sql)
        assert isinstance(stmt, _ast.CreateMaterializedView)
        kw = {"device": "cpu"} if pkg == "port" else {}
        planner = StreamPlanner(fe.catalog, fe.store, LocalBarrierManager(),
                                definition="",
                                chunk_target_rows=fe.chunk_target_rows,
                                **kw)
        plan = planner.plan("__stats__", stmt.select, actor_id=0)
        consumer, rep = mod.rewrite_stream_plan(
            plan.consumer, rules, record=False, fusion=fusion, **kw)
        await fe.close()
        return (mod.plan_lane_stats(consumer), explain_tree(consumer),
                (rep.fired, rep.details, rep.fallbacks))
    return asyncio.run(main())


@pytest.mark.parametrize("name,sources,mv", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("fusion", [False, True], ids=["rules", "fused"])
def test_rewritten_tree_and_report_match_reference(name, sources, mv,
                                                   fusion):
    """The same rules fire the same number of times, with the same
    details, into the same tree, as in the reference."""
    port = _planned("port", sources, mv, "all", fusion)
    ref = _planned("ref", sources, mv, "all", fusion)
    assert port == ref, name
    # q1's plan is already narrow: no executor rule fires there, in
    # either package
    assert port[2][0] or (name == "nexmark_q1" and not fusion), name


@pytest.mark.parametrize("sources,mv", [
    (TPCH_SOURCES, TPCH_Q5), (NEXMARK_SOURCES, NEXMARK_Q7),
], ids=["tpch_q5", "nexmark_q7"])
def test_q5_q7_carry_strictly_fewer_lanes(sources, mv):
    off = _planned("port", sources, mv, "none")[0]
    on = _planned("port", sources, mv, "all")[0]
    assert on["total_lanes"] < off["total_lanes"], (on, off)
    assert on["max_lane_width"] <= off["max_lane_width"]


def test_filter_pushdown_gated_by_join_kind_twin():
    out = run_both([
        "SET stream_fusion = 'off'", *NEXMARK_SOURCES,
        "EXPLAIN SELECT p.id, a.seller FROM person AS p "
        "JOIN auction AS a ON p.id = a.seller WHERE a.seller > 0",
        "EXPLAIN SELECT p.id, a.seller FROM person AS p "
        "LEFT OUTER JOIN auction AS a ON p.id = a.seller "
        "WHERE a.seller > 0"])
    inner = "\n".join(r[0] for r in out[-2]).split("-- rewritten plan")[1]
    left = "\n".join(r[0] for r in out[-1]).split("-- rewritten plan")[1]
    assert inner.index("FilterExecutor") > inner.index("HashJoinExecutor")
    assert left.index("FilterExecutor") < left.index("HashJoinExecutor")


def test_explain_shows_both_trees_and_annotations_twin():
    body = TPCH_Q5.split(" AS ", 1)[1]
    out = run_both([*TPCH_SOURCES, "EXPLAIN " + body,
                    "SET stream_rewrite_rules = 'none'",
                    "SET stream_fusion = 'off'", "EXPLAIN " + body])
    txt = "\n".join(r[0] for r in out[6])
    assert "rule column_pruning" in txt and "rule filter_pushdown" in txt
    assert txt.count("MaterializeExecutor") == 2
    assert "no rewrites fired" in "\n".join(r[0] for r in out[9])


def test_column_pruning_narrows_join_state_tables_twin():
    """q5's join sides keep keys + referenced columns: the same widths
    as the reference's, narrower than with rules off."""
    def widths(pkg, rules):
        async def main():
            fe = frontend(pkg, rate_limit=16, min_chunks=16)
            await fe.execute(f"SET stream_rewrite_rules = '{rules}'")
            for s in TPCH_SOURCES:
                await fe.execute(s)
            await fe.execute(TPCH_Q5)
            out = []

            def walk(ex):
                ex = getattr(ex, "inner", None) or ex
                if type(ex).__name__ == "HashJoinExecutor":
                    out.append(len(ex.sides[0].table.schema)
                               + len(ex.sides[1].table.schema))
                for attr in ("input", "left_in", "right_in"):
                    c = getattr(ex, attr, None)
                    if c is not None and hasattr(c, "execute"):
                        walk(c)
            walk(fe.actors[max(fe.actors)].consumer)
            await fe.close()
            return out
        return asyncio.run(main())

    on, off = widths("port", "all"), widths("port", "none")
    assert on == widths("ref", "all") and off == widths("ref", "none")
    assert len(on) == len(off) == 5
    assert sum(on) < sum(off)


def test_rw_plan_rewrites_twin():
    out = run_both([*TPCH_SOURCES, TPCH_Q5,
                    "SELECT job, rule, fired FROM rw_plan_rewrites "
                    "WHERE job = 'q'"], rate_limit=16, min_chunks=16)
    rows = out[-1]
    assert any(r[1] == "column_pruning" and r[2] > 0 for r in rows)
    assert p_opt.rewrite_history_rows()
    assert explain_body([("a",), ("-- compiled kernel costs",)]) == [("a",)]
