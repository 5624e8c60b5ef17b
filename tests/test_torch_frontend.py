"""The SQL front door of the PyTorch port against the JAX reference.

Each case runs one SQL script through the reference's ``Frontend`` and
the port's ``Frontend(device="cpu")`` on the same seeded sources, and
holds every result equal: MV rows and batch ``SELECT`` rows exactly
(as multisets, or as lists where the query orders them), ``SHOW`` and
``EXPLAIN`` text (up to the reference's compiled-kernel cost footer),
and a failing statement's error class and message.
The reference runs under its defaults (barrier domains on); the port
runs its one barrier loop, which the reference states is bit-identical
(``ROADMAP.md`` queue C). Every session pins ``min_chunks`` to
``rate_limit`` (``pinned``), so what a barrier carries does not depend
on the event loop's timing.

Twins here: the 18 cases of ``tests/test_frontend.py`` that need no
module of ``ROADMAP.md`` items 10b, 11 or 13 (:16, :51, :72, :100, :153,
:174, :215, :302, :345, :380, :406, :440, :539, :580, :629, :720, :766,
:781; the two project-set cases :720 and :781 read their counts through
a derived table here, and their MV-on-MV forms are twinned in
``tests/test_torch_table_dml.py``) and every case of
``tests/test_subquery_having.py``. ``run_both`` is the shared harness of
``tests/test_torch_{corpus_nexmark,corpus_tpch,sql_session,
plan_rewrite}.py``.
"""

import asyncio
import dataclasses
import decimal
from collections import Counter

import numpy as np
import pytest
import torch

from risingwave_tpu.frontend.parser import parse as r_parse
from risingwave_tpu.frontend.session import Frontend as RefFrontend
from risingwave_tpu_torch.frontend.opt import set_strict_checker
from risingwave_tpu_torch.frontend.parser import parse as p_parse
from risingwave_tpu_torch.frontend.session import Frontend as PortFrontend

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_strict_checker():
    """A rewrite rule that breaks a plan invariant fails loudly in the
    port too (tests/conftest.py arms the reference's checker)."""
    set_strict_checker(True)
    yield
    set_strict_checker(False)


# -- the harness ----------------------------------------------------------


def frontend(pkg, **kw):
    if pkg == "port":
        return PortFrontend(device="cpu", **kw)
    return RefFrontend(**kw)


def norm(v):
    """A result value as plain Python (numpy scalars unwrapped)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, tuple)):
        return type(v)(norm(x) for x in v)
    return v


def norm_rows(rows):
    return [tuple(norm(x) for x in r) for r in rows]


def store_tables(store) -> dict:
    """table id → [(key, row)] of every table the store holds, read at
    the committed epoch (both packages' MemoryStateStore)."""
    ep = store.committed_epoch()
    out = {}
    for tid in sorted(store._tables):
        rows = [(k, tuple(norm(x) for x in v))
                for k, v in store.iter(tid, ep)]
        if rows:
            out[tid] = rows
    return out


def explain_body(rows):
    """EXPLAIN's rows up to the reference's compiled-kernel cost footer
    (the XLA programs this process compiled; the port has no such
    footer, ROADMAP.md item 12)."""
    for i, (line,) in enumerate(rows):
        if line.startswith("-- compiled kernel costs"):
            return rows[:i]
    return rows


class Raises:
    """A script statement that must fail (same error in both)."""

    def __init__(self, sql):
        self.sql = sql


class Each:
    """A SELECT read after each of ``n`` single steps."""

    def __init__(self, n, sql):
        self.n, self.sql = n, sql


def run_script(pkg, script, tables=False, hook=None, **kw):
    """Run ``script`` through one package's Frontend: a str executes, an
    int steps that many checkpoint barriers, ``Raises`` records the
    error, ``Each`` reads after every step. Returns the results in order
    (and the store's tables; ``hook(fe)`` runs before close)."""
    async def run():
        fe = frontend(pkg, **kw)
        out = []
        for item in script:
            if isinstance(item, int):
                await fe.step(item)
            elif isinstance(item, Raises):
                try:
                    await fe.execute(item.sql)
                except Exception as e:  # noqa: BLE001 — compared below
                    out.append(("raised", type(e).__name__, str(e)))
                else:
                    out.append(("did not raise", item.sql))
            elif isinstance(item, Each):
                for _ in range(item.n):
                    await fe.step(1)
                    out.append(norm_rows(await fe.execute(item.sql)))
            else:
                r = await fe.execute(item)
                if item.upper().startswith("EXPLAIN"):
                    r = explain_body(r)
                out.append(norm_rows(r) if isinstance(r, list) else r)
        extra = hook(fe) if hook is not None else None
        got = store_tables(fe.store) if tables else None
        await fe.close()
        return out, got, extra
    return asyncio.run(run())


def _comparable(sql, res):
    if isinstance(res, list) and isinstance(sql, str) and \
            "ORDER BY" not in sql.upper().split(" FROM ")[-1]:
        return Counter(res)
    return res


def pinned(kw):
    """The session knobs with ``min_chunks`` = ``rate_limit``: each
    barrier then carries exactly that many chunks of every source that
    is not exhausted, whatever the event loop's timing (with fewer
    minimum chunks a barrier may win the select earlier or later)."""
    kw = dict(kw)
    pin = kw.get("min_chunks") or kw.get("rate_limit", 8)
    kw["rate_limit"] = kw["min_chunks"] = pin
    return kw


def run_both(script, tables=False, **kw):
    """Run ``script`` through both packages and hold every result equal.
    Returns the port's results (and both packages' tables)."""
    kw = pinned(kw)
    ref, ref_tables, _ = run_script("ref", script, tables=tables, **kw)
    port, port_tables, _ = run_script("port", script, tables=tables, **kw)
    sqls = []
    for item in script:
        if isinstance(item, int):
            continue
        if isinstance(item, Each):
            sqls += [item.sql] * item.n
        else:
            sqls.append(getattr(item, "sql", item))
    assert len(ref) == len(port) == len(sqls)
    for sql, r, p in zip(sqls, ref, port):
        assert _comparable(sql, p) == _comparable(sql, r), sql
    if tables:
        return port, port_tables, ref_tables
    return port


def nexmark_source(t, n, gap=None, chunk=None, extra=""):
    s = (f"CREATE SOURCE {t} WITH (connector='nexmark', "
         f"nexmark.table.type='{t}', nexmark.event.num={n}")
    if chunk is not None:
        s += f", nexmark.max.chunk.size={chunk}"
    if gap is not None:
        s += f", nexmark.min.event.gap.in.ns={gap}"
    return s + extra + ")"


# -- tests/test_frontend.py twins ----------------------------------------


def test_parser_select_shapes_twin():
    """:16 — the same statements parse to the same AST; bad input
    raises the same ParseError."""
    for sql in ("SELECT a, b AS bb, 0.908 * price FROM bid WHERE "
                "price > 100 GROUP BY a ORDER BY a DESC LIMIT 5",
                "SELECT window_start, MAX(price) FROM TUMBLE(bid, "
                "date_time, INTERVAL '10' SECOND) GROUP BY window_start",
                "CREATE SOURCE b WITH (connector='nexmark', "
                "nexmark.table.type='bid', nexmark.event.num=1000)"):
        r, p = r_parse(sql), p_parse(sql)
        assert type(r).__name__ == type(p).__name__
        assert dataclasses.asdict(r) == dataclasses.asdict(p)
    for bad in ("SELECT FROM x", "CREATE MATERIALIZED VIEW v SELECT 1"):
        errs = []
        for parse in (r_parse, p_parse):
            with pytest.raises(Exception) as ei:
                parse(bad)
            errs.append((type(ei.value).__name__, str(ei.value)))
        assert errs[0] == errs[1] and errs[0][0] == "ParseError"


BID = nexmark_source("bid", 20000, gap=100_000_000, chunk=1024)
PERSON = nexmark_source("person", 20000, gap=100_000_000)
AUCTION = nexmark_source("auction", 20000, gap=100_000_000)


def test_q1_shaped_mv_sql_twin():
    """:51 — DECIMAL projection, SELECT * and COUNT(*)."""
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW q1 AS SELECT auction, bidder, "
        "0.908 * price AS price, date_time FROM bid", 6,
        "SELECT * FROM q1", "SELECT COUNT(*) AS n FROM q1"])
    assert len(out[2]) > 1000 and out[3][0][0] == len(out[2])


def test_q7_shaped_mv_sql_matches_batch_recompute_twin():
    """:72 — a TUMBLE agg MV and its batch recompute over a raw MV."""
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW raw AS SELECT price, date_time "
        "FROM bid",
        "CREATE MATERIALIZED VIEW q7 AS SELECT window_start, "
        "MAX(price) AS max_price, COUNT(*) AS cnt FROM TUMBLE(bid, "
        "date_time, INTERVAL '10' SECOND) GROUP BY window_start", 8,
        "SELECT window_start, max_price, cnt FROM q7 "
        "ORDER BY window_start",
        "SELECT tumble_start(date_time, INTERVAL '10' SECOND) AS w, "
        "MAX(price) AS m, COUNT(*) AS c FROM raw GROUP BY "
        "tumble_start(date_time, INTERVAL '10' SECOND) ORDER BY w"],
        min_chunks=8)
    assert len(out[3]) >= 2 and out[3] == out[4]


def test_q8_shaped_join_sql_twin():
    """:100 — an inner join of two sources."""
    out = run_both([
        PERSON, AUCTION,
        "CREATE MATERIALIZED VIEW q8 AS SELECT p.id, p.name, "
        "a.seller FROM person AS p JOIN auction AS a "
        "ON p.id = a.seller", 8, "SELECT * FROM q8"], min_chunks=8)
    assert out[3] and all(r[0] == r[2] for r in out[3])


def test_drop_mv_stops_pipeline_twin():
    """:153 — DROP stops the job; the loop goes on with a new one."""
    out = run_both([
        BID, "CREATE MATERIALIZED VIEW m AS SELECT auction FROM bid", 2,
        "DROP MATERIALIZED VIEW m", "SHOW MATERIALIZED VIEWS",
        "CREATE MATERIALIZED VIEW m2 AS SELECT bidder FROM bid", 2,
        "SELECT COUNT(*) AS n FROM m2"])
    assert out[3] == [] and out[5][0][0] > 0


def test_q0_q2_q3_shaped_queries_twin():
    """:174 — passthrough, a modulo filter, a filtered join."""
    out = run_both([
        BID, PERSON, AUCTION,
        "CREATE MATERIALIZED VIEW q0 AS SELECT * FROM bid",
        "CREATE MATERIALIZED VIEW q2 AS SELECT auction, price "
        "FROM bid WHERE auction % 123 = 0",
        "CREATE MATERIALIZED VIEW q3 AS SELECT p.name, p.city, "
        "p.state, a.id FROM auction AS a JOIN person AS p "
        "ON a.seller = p.id "
        "WHERE a.category = 10 AND (p.state = 'OR' OR p.state = 'ID' "
        "OR p.state = 'CA')", 8,
        "SELECT COUNT(*) AS n FROM q0", "SELECT auction, price FROM q2",
        "SELECT * FROM q3"], min_chunks=8)
    assert out[6][0][0] == 20000 * 46 // 50
    assert out[7] and out[8]


def test_avg_and_topn_mv_twin():
    """:215 — AVG's FLOAT64 result and a streaming TopN."""
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW per_auction AS SELECT auction, "
        "COUNT(*) AS bids, AVG(price) AS avg_price FROM bid "
        "GROUP BY auction",
        "CREATE MATERIALIZED VIEW top3 AS SELECT auction, "
        "COUNT(*) AS bids FROM bid GROUP BY auction "
        "ORDER BY bids DESC, auction LIMIT 3", 10,
        "SELECT auction, bids, avg_price FROM per_auction",
        "SELECT auction, bids FROM top3 ORDER BY bids DESC, auction",
        "SELECT auction, bids FROM per_auction "
        "ORDER BY bids DESC, auction LIMIT 3"], min_chunks=8)
    assert all(isinstance(r[2], float) for r in out[3])
    assert out[4] == out[5] and len(out[4]) == 3


PERSON_SMALL = nexmark_source("person", 2000, chunk=128)
AUCTION_SMALL = nexmark_source("auction", 2000, chunk=128)


def test_left_outer_join_sql_twin():
    """:302 — LEFT OUTER JOIN's NULL padding and its retraction."""
    out = run_both([
        PERSON_SMALL, AUCTION_SMALL,
        "CREATE MATERIALIZED VIEW lo AS SELECT p.id, a.seller "
        "FROM person AS p LEFT OUTER JOIN auction AS a "
        "ON p.id = a.seller",
        "CREATE MATERIALIZED VIEW inner_v AS SELECT p.id, a.seller "
        "FROM person AS p JOIN auction AS a ON p.id = a.seller", 40,
        "SELECT * FROM lo", "SELECT * FROM inner_v"], rate_limit=2)
    assert any(r[1] is None for r in out[4])


def test_count_distinct_sql_twin():
    """:345 — count(DISTINCT) streaming against its batch recompute."""
    out = run_both([
        nexmark_source("bid", 3000, chunk=128),
        "CREATE MATERIALIZED VIEW raw AS SELECT auction, bidder "
        "FROM bid",
        "CREATE MATERIALIZED VIEW d AS SELECT auction, "
        "count(DISTINCT bidder) AS db, count(bidder) AS b "
        "FROM bid GROUP BY auction", 30,
        "SELECT * FROM d",
        "SELECT auction, count(DISTINCT bidder) AS db, "
        "count(bidder) AS b FROM raw GROUP BY auction"], rate_limit=4)
    assert sorted(out[3]) == sorted(out[4])
    assert any(r[1] < r[2] for r in out[3])


def test_failed_create_mv_leaks_nothing_twin():
    """:380 — a CREATE that fails to bind leaves the loop healthy."""
    out = run_both([
        BID, Raises("CREATE MATERIALIZED VIEW bad AS SELECT nonexistent "
                    "FROM bid"),
        "CREATE MATERIALIZED VIEW ok AS SELECT auction FROM bid", 12,
        "SELECT count(*) FROM ok"], rate_limit=2)
    assert out[1][0] == "raised" and out[3][0][0] > 0


def test_outer_join_where_is_not_pushed_below_padded_side_twin():
    """:406 — WHERE on the padded side filters after the join."""
    out = run_both([
        PERSON_SMALL, AUCTION_SMALL,
        "CREATE MATERIALIZED VIEW v AS SELECT p.id, a.seller "
        "FROM person AS p LEFT OUTER JOIN auction AS a "
        "ON p.id = a.seller WHERE a.seller > 0", 25,
        "SELECT * FROM v"], rate_limit=2)
    assert out[3] and all(r[1] is not None for r in out[3])


def test_group_by_over_retracting_join_oracle_twin():
    """:440 — GROUP BY over a LEFT JOIN: retractable MIN/MAX."""
    out = run_both([
        PERSON, AUCTION,
        "CREATE MATERIALIZED VIEW g AS SELECT p.id, count(*) AS c, "
        "max(a.category) AS mc FROM person AS p LEFT JOIN auction "
        "AS a ON p.id = a.seller GROUP BY p.id", 16,
        "SELECT * FROM g"], min_chunks=8)
    assert any(r[2] is None for r in out[3])
    assert any(r[2] is not None for r in out[3])


def test_hop_window_sql_oracle_twin():
    """:539 — HOP windows from SQL."""
    out = run_both([
        nexmark_source("bid", 3000, chunk=256),
        "CREATE MATERIALIZED VIEW h AS SELECT auction, "
        "window_start, count(*) AS c FROM HOP(bid, date_time, "
        "INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
        "GROUP BY auction, window_start", 10,
        "SELECT * FROM h"], min_chunks=4)
    assert len(out[2]) > 100


def test_emit_on_window_close_sql_twin():
    """:580 — EOWC: each window released once, read after every step."""
    out = run_both([
        nexmark_source("bid", 4000, chunk=256,
                       extra=", watermark.column='date_time', "
                             "watermark.delay='0 seconds'"),
        "CREATE MATERIALIZED VIEW w AS SELECT window_start, "
        "max(price) AS m, count(*) AS c FROM TUMBLE(bid, "
        "date_time, INTERVAL '100' MILLISECONDS) GROUP BY "
        "window_start EMIT ON WINDOW CLOSE",
        Each(12, "SELECT * FROM w")], min_chunks=4)
    assert out[-1]


def test_eowc_without_watermark_rejected_twin():
    """:629 — EOWC needs a watermarked window key."""
    out = run_both([
        nexmark_source("bid", 1000),
        Raises("CREATE MATERIALIZED VIEW w AS SELECT auction FROM "
               "bid EMIT ON WINDOW CLOSE")], min_chunks=4)
    assert "WINDOW CLOSE" in out[1][2]


# the counts the project-set cases expand: the reference's MV g as a
# derived table (the MV-on-MV forms are tests/test_torch_table_dml.py's)
G = ("(SELECT auction AS a, count(*) AS c FROM bid GROUP BY auction) "
     "AS g")


def test_project_set_generate_series_sql_twin():
    """:720 — generate_series over a retracting count."""
    out = run_both([
        nexmark_source("bid", 4000),
        f"CREATE MATERIALIZED VIEW ps AS SELECT a, "
        f"generate_series(1, c) AS s FROM {G}", 20,
        "SELECT a, s FROM ps",
        "SELECT s FROM ps WHERE s > 100000"], min_chunks=8)
    assert len(out[2]) > 100 and out[3] == []


def test_project_set_unnest_rejected_twin():
    """:766 — unnest is refused in both."""
    out = run_both([
        nexmark_source("bid", 100),
        Raises("CREATE MATERIALIZED VIEW u AS SELECT "
               "unnest(auction) FROM bid")])
    assert "unnest" in out[1][2]


def test_project_set_duplicate_names_and_zero_step_twin():
    """:781 — two unaliased series keep distinct data; a zero step is
    refused at plan time."""
    out = run_both([
        nexmark_source("bid", 500),
        Raises(f"CREATE MATERIALIZED VIEW z AS SELECT a, "
               f"generate_series(1, 10, 0) AS s FROM {G}"),
        f"CREATE MATERIALIZED VIEW two AS SELECT a, "
        f"generate_series(1, 2), generate_series(10, 13) FROM {G}", 8,
        "SELECT * FROM two"], min_chunks=4)
    assert "nonzero" in out[1][2] and out[3]


# -- tests/test_subquery_having.py twins ---------------------------------


def test_parser_subquery_having_between_twin():
    for sql in ("SELECT x, count(*) FROM (SELECT a AS x FROM t) q "
                "GROUP BY x HAVING count(*) > 5",
                "SELECT * FROM t WHERE a BETWEEN 1 AND 5 AND b = 2"):
        assert dataclasses.asdict(r_parse(sql)) == \
            dataclasses.asdict(p_parse(sql))
    for parse in (r_parse, p_parse):
        with pytest.raises(Exception, match="alias|expected"):
            parse("SELECT * FROM (SELECT a FROM t)")


def test_having_filters_groups_twin():
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW hot AS SELECT bidder, COUNT(*) "
        "AS cnt FROM bid GROUP BY bidder HAVING COUNT(*) > 10",
        "CREATE MATERIALIZED VIEW all_b AS SELECT bidder, COUNT(*) "
        "AS cnt FROM bid GROUP BY bidder", 8,
        "SELECT bidder, cnt FROM hot", "SELECT bidder, cnt FROM all_b"],
        min_chunks=8)
    assert 0 < len(out[3]) < len(out[4])


def test_expression_over_aggregates_twin():
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW m AS SELECT auction, "
        "SUM(price) + COUNT(*) AS mix, MAX(price) - MIN(price) "
        "AS spread FROM bid GROUP BY auction",
        "CREATE MATERIALIZED VIEW raw AS SELECT auction, price "
        "FROM bid", 8,
        "SELECT auction, mix, spread FROM m ORDER BY auction",
        "SELECT auction, price FROM raw"], min_chunks=8)
    assert len(out[3]) > 10


Q4 = ("CREATE MATERIALIZED VIEW q4 AS "
      "SELECT category, AVG(final) AS avg_final FROM ("
      "  SELECT a.category AS category, MAX(b.price) AS final"
      "  FROM auction AS a JOIN bid AS b ON a.id = b.auction"
      "  WHERE b.date_time BETWEEN a.date_time AND a.expires"
      "  GROUP BY a.id, a.category) AS q "
      "GROUP BY category")


def test_nexmark_q4_subquery_avg_twin():
    """Nexmark q4 at the reference test's size, rows exact."""
    out = run_both([
        nexmark_source("auction", 20000, gap=100_000_000),
        nexmark_source("bid", 20000, gap=100_000_000), Q4, 10,
        "SELECT category, avg_final FROM q4 ORDER BY category"],
        min_chunks=8)
    assert len(out[3]) >= 2 and all(isinstance(v, float)
                                    for _c, v in out[3])


def test_subquery_plain_projection_twin():
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW m AS SELECT p2, bidder FROM "
        "(SELECT price * 2 AS p2, bidder, auction FROM bid) q "
        "WHERE p2 > 2000",
        "CREATE MATERIALIZED VIEW o AS SELECT price, bidder "
        "FROM bid WHERE price * 2 > 2000", 6,
        "SELECT p2, bidder FROM m", "SELECT price, bidder FROM o"],
        min_chunks=8)
    assert sorted(out[3]) == sorted((p * 2, b) for p, b in out[4])


def test_batch_having_and_subquery_twin():
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW raw AS SELECT auction, bidder, "
        "price FROM bid", 6,
        "SELECT auction, COUNT(*) AS c FROM raw GROUP BY auction "
        "HAVING COUNT(*) > 3 ORDER BY auction",
        "SELECT auction, COUNT(*) AS c FROM raw GROUP BY auction "
        "ORDER BY auction",
        "SELECT q.c + 1 AS c1 FROM (SELECT auction, COUNT(*) AS c "
        "FROM raw GROUP BY auction) q ORDER BY c1 LIMIT 3"],
        min_chunks=8)
    assert out[2] == [r for r in out[3] if r[1] > 3]


def test_having_without_group_key_projected_twin():
    out = run_both([
        BID,
        "CREATE MATERIALIZED VIEW m AS SELECT MAX(price) AS mp "
        "FROM bid GROUP BY auction", 6,
        "SELECT mp FROM m", "SELECT * FROM m"], min_chunks=8)
    assert len(out[2]) > 10 and all(len(r) == 1 for r in out[3])


def test_eowc_over_subquery_rejected_twin():
    out = run_both([
        BID,
        Raises("CREATE MATERIALIZED VIEW e AS SELECT c FROM ("
               "SELECT window_start, COUNT(*) AS c FROM TUMBLE(bid, "
               "date_time, INTERVAL '10' SECOND) GROUP BY "
               "window_start) q EMIT ON WINDOW CLOSE")], min_chunks=8)
    assert out[1][1] == "PlanError"


def test_decimal_results_keep_their_exact_value():
    """DECIMAL through SQL: 0.908 * price and a DECIMAL SUM come out as
    the same exact Decimals in both packages (no rounding)."""
    out = run_both([
        nexmark_source("bid", 2000),
        "CREATE MATERIALIZED VIEW d AS SELECT auction, "
        "sum(0.908 * price) AS s, max(0.5 * price) AS m FROM bid "
        "GROUP BY auction", 6, "SELECT * FROM d"], min_chunks=4)
    assert out[2] and all(isinstance(r[1], decimal.Decimal)
                          for r in out[2])
