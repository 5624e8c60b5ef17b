"""Tables and DML, the datagen source, and the MV-on-MV forms of the
project-set cases, in the port against the reference.

Each case runs one SQL script through the reference's ``Frontend`` and
the port's ``Frontend(device="cpu")`` (``tests/test_torch_frontend.py``'s
harness: ``min_chunks`` pinned to ``rate_limit``) and holds every result
equal: statement tags (``INSERT 0 3``, ``DELETE 1``), rows, and a
failing statement's error class and message.

- Twins of ``tests/test_frontend.py`` :126 (a datagen source), :720 and
  :781 in their MV-on-MV forms (generate_series over a count MV), :815
  (CREATE TABLE, INSERT / DELETE / UPDATE, an MV over the table, DROP
  TABLE's refusal with a dependent), :899 (the DML guards), :927 and
  :955 (INSERT ... SELECT with coercion), :973 (DECIMAL through every
  DML path, exactly).
- Twins of ``tests/test_session_config.py`` :93 (a user table shadows
  a system catalog) and :106 (``rw_tables`` vs ``rw_materialized_views``).
- A twin of ``tests/test_fusion.py:1125`` (HOP absorbed by the agg's
  prelude equals the sequential hop, and EXPLAIN says so), and of the
  two SQL cases item 10b's acceptance names from earlier items:
  ``tests/test_over_window.py:362`` and ``tests/test_batch.py:102``.
- Every state table by id, hidden ``_row_id`` included, equal to the
  reference's one-loop arm after a table's DML with both epoch clocks
  held still (``RowIdSeq.take(committed_epoch, n)``).
"""

import pytest

from tests.test_torch_sql_session import still_clock  # noqa: F401
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    Raises, _port_strict_checker, explain_body, run_both, run_script,
)



def test_datagen_source_and_scalar_select_twin():
    """:126 — a sequence and a random field through a filtered MV."""
    out = run_both([
        "CREATE SOURCE g WITH (connector='datagen', "
        "fields.id.type='bigint', fields.id.kind='sequence', "
        "fields.id.start=0, fields.id.end=1000000, "
        "fields.v.type='double', fields.v.kind='random', "
        "fields.v.min=0, fields.v.max=10, "
        "datagen.rows.per.chunk=500, datagen.event.num=2000)",
        "CREATE MATERIALIZED VIEW dg AS SELECT id, v FROM g "
        "WHERE id % 2 = 0", 6,
        "SELECT COUNT(*) AS n, MIN(id) AS mn, MAX(id) AS mx FROM dg",
        "SELECT id, v FROM dg",
        "SELECT 1 + 2 AS three, 'x' AS s", "SHOW MATERIALIZED VIEWS"])
    assert out[2] == [(1000, 0, 1998)]
    assert out[4] == [(3, "x")] and out[5] == [("dg",)]


BID = ("CREATE SOURCE bid WITH (connector='nexmark', "
       "nexmark.table.type='bid', nexmark.event.num={n})")


def test_project_set_over_a_count_mv_twin():
    """:720 in its MV-on-MV form — generate_series(1, c) over a count
    MV that retracts as counts bump."""
    out = run_both([
        BID.format(n=4000),
        "CREATE MATERIALIZED VIEW g AS SELECT auction AS a, "
        "count(*) AS c FROM bid GROUP BY auction",
        "CREATE MATERIALIZED VIEW ps AS SELECT a, "
        "generate_series(1, c) AS s FROM g", 20,
        "SELECT a, s FROM ps", "SELECT a, c FROM g"], min_chunks=8)
    want = {(a, s) for a, c in out[-1] for s in range(1, c + 1)}
    assert set(out[-2]) == want and len(out[-2]) == len(want)
    assert max(c for _a, c in out[-1]) > 1


def test_project_set_duplicate_names_and_zero_step_twin():
    """:781 in its MV-on-MV form."""
    out = run_both([
        BID.format(n=500),
        "CREATE MATERIALIZED VIEW g AS SELECT auction AS a, "
        "count(*) AS c FROM bid GROUP BY auction",
        Raises("CREATE MATERIALIZED VIEW z AS SELECT a, "
               "generate_series(1, 10, 0) AS s FROM g"),
        "CREATE MATERIALIZED VIEW two AS SELECT a, "
        "generate_series(1, 2), generate_series(10, 13) FROM g", 8,
        "SELECT a FROM g", "SELECT * FROM two"], min_chunks=4)
    assert out[2][0] == "raised" and "nonzero" in out[2][2]
    rows, n_groups = [r[:3] for r in out[-1]], len(out[-2])
    want = set()
    for (a,) in out[-2]:
        want |= {(a, 1, 10), (a, 2, 11), (a, None, 12), (a, None, 13)}
    assert set(rows) == want and len(rows) == 4 * n_groups


def test_create_table_dml_and_mv_chain_twin():
    """:815"""
    out = run_both([
        "CREATE TABLE t (a bigint, b varchar, ts timestamp)",
        "INSERT INTO t VALUES (1, 'x', '2024-01-01 00:00:00'), "
        "(2, 'y', null), (3, 'z', '2024-01-02 12:30:00')",
        "SELECT a, b FROM t", "SELECT ts FROM t WHERE a = 2",
        "DELETE FROM t WHERE a = 2",
        "UPDATE t SET b = 'w', a = a + 10 WHERE a > 1",
        "SELECT a, b FROM t",
        "CREATE MATERIALIZED VIEW m AS SELECT b, count(*) AS c "
        "FROM t GROUP BY b",
        "INSERT INTO t VALUES (5, 'w', null)", "SELECT b, c FROM m",
        "DELETE FROM t", "SELECT b, c FROM m", "SHOW TABLES",
        "SHOW MATERIALIZED VIEWS", Raises("DROP TABLE t"),
        "DROP MATERIALIZED VIEW m", "DROP TABLE t",
        Raises("INSERT INTO t VALUES (1, 'x', null)")], rate_limit=8)
    assert out[1] == "INSERT 0 3"
    assert sorted(out[2]) == [(1, "x"), (2, "y"), (3, "z")]
    assert out[3] == [(None,)]
    assert out[4:6] == ["DELETE 1", "UPDATE 1"]
    assert sorted(out[6]) == [(1, "x"), (13, "w")]
    assert sorted(out[9]) == [("w", 2), ("x", 1)]
    assert out[10:12] == ["DELETE 3", []]
    assert out[12] == [("t",)] and out[13] == [("m",)]
    assert "depended on" in out[14][2]
    assert out[-1][0] == "raised"


def test_table_dml_guards_twin():
    """:899"""
    out = run_both([
        "CREATE TABLE t (a bigint)", "INSERT INTO t VALUES (1), (2)",
        Raises("DROP MATERIALIZED VIEW t"),
        Raises("UPDATE t SET _row_id = 0"),
        "CREATE TABLE kv (k bigint PRIMARY KEY, v bigint)",
        "INSERT INTO kv VALUES (1, 10), (2, 20)",
        Raises("UPDATE kv SET k = 9"),
        "INSERT INTO kv VALUES (3, 30)", "SELECT k FROM kv",
        "SELECT a FROM t", "INSERT INTO kv VALUES (1, 11)",
        "SELECT k, v FROM kv"], rate_limit=8)
    assert "use DROP TABLE" in out[2][2]
    assert "not found" in out[3][2]
    assert "more than one row" in out[6][2]
    assert len(out[8]) == 3 and sorted(out[9]) == [(1,), (2,)]
    # a PRIMARY KEY table upserts on its key
    assert sorted(out[-1]) == [(1, 11), (2, 20), (3, 30)]


def test_insert_select_twin():
    """:927"""
    out = run_both([
        "CREATE TABLE src (a bigint, b varchar)",
        "INSERT INTO src VALUES (1, 'x'), (2, 'y'), (3, 'z')",
        "CREATE TABLE dst (a bigint, b varchar)",
        "INSERT INTO dst SELECT a + 10, b FROM src WHERE a > 1",
        "SELECT a, b FROM dst", "INSERT INTO src SELECT a, b FROM src",
        "SELECT a FROM src",
        "INSERT INTO dst SELECT a, b FROM src WHERE a > 999",
        Raises("INSERT INTO dst SELECT a FROM src")], rate_limit=8)
    assert out[3] == "INSERT 0 2"
    assert sorted(out[4]) == [(12, "y"), (13, "z")]
    assert out[5] == "INSERT 0 3" and len(out[6]) == 6
    assert out[7] == "INSERT 0 0" and "columns" in out[8][2]


def test_insert_select_duplicate_output_names_twin():
    """:955"""
    out = run_both([
        "CREATE TABLE src (a bigint, b bigint)",
        "INSERT INTO src VALUES (1, 100), (2, 200)",
        "CREATE TABLE dst (x varchar, y bigint)",
        "INSERT INTO dst SELECT a, b AS a FROM src",
        "SELECT x, y FROM dst"], rate_limit=8)
    assert out[3] == "INSERT 0 2"
    assert sorted(out[4]) == [("1", 100), ("2", 200)]


def test_table_decimal_roundtrip_twin():
    """:973 — DECIMAL unscaled through VALUES, INSERT SELECT with a
    coerced sibling, a cast into numeric, UPDATE, DELETE by value and
    an aggregate over the table, exactly."""
    from decimal import Decimal
    out = run_both([
        "CREATE TABLE t (d numeric, tag varchar)",
        "INSERT INTO t VALUES (1.5, 'a'), (2.25, 'b')",
        "SELECT d, tag FROM t",
        "CREATE TABLE t2 (d numeric, n varchar)",
        "INSERT INTO t2 SELECT d, 7 FROM t", "SELECT d, n FROM t2",
        "INSERT INTO t SELECT CAST(3 AS BIGINT), n FROM t2 WHERE d > 2",
        "SELECT d, tag FROM t",
        "UPDATE t SET d = d + 1 WHERE tag = 'a'", "SELECT d, tag FROM t",
        "DELETE FROM t WHERE d = 2.25", "SELECT sum(d) AS s FROM t"],
        rate_limit=8)
    assert sorted(out[2]) == [(Decimal("1.5"), "a"), (Decimal("2.25"), "b")]
    assert sorted(out[5]) == [(Decimal("1.5"), "7"), (Decimal("2.25"), "7")]
    assert (Decimal("3"), "7") in out[7]
    assert out[8] == "UPDATE 1" and (Decimal("2.5"), "a") in out[9]
    assert out[10] == "DELETE 1"
    assert out[11] == [(Decimal("5.5"),)]


def test_user_table_shadows_system_catalog_twin():
    """tests/test_session_config.py:93"""
    out = run_both(["CREATE TABLE rw_sources (x INT)",
                    "INSERT INTO rw_sources VALUES (7)",
                    "SELECT x FROM rw_sources"], min_chunks=4)
    assert out[-1] == [(7,)]


def test_rw_tables_vs_mvs_split_twin():
    """tests/test_session_config.py:106"""
    out = run_both(["CREATE TABLE t (x INT)", BID.format(n=1000),
                    "CREATE MATERIALIZED VIEW m AS SELECT auction FROM bid",
                    2, "SELECT name FROM rw_tables",
                    "SELECT name FROM rw_materialized_views"],
                   min_chunks=4)
    assert out[-2] == [("t",)] and out[-1] == [("m",)]


HOP_MV = ("CREATE MATERIALIZED VIEW q AS SELECT window_start, "
          "COUNT(*) AS c, MAX(price) AS m "
          "FROM HOP(bid, date_time, INTERVAL '2' SECOND, "
          "INTERVAL '10' SECOND) GROUP BY window_start")
NEXMARK_SOURCES = [
    ("CREATE SOURCE {t} WITH (connector='nexmark', "
     "nexmark.table.type='{t}', nexmark.event.num=2000, "
     "nexmark.max.chunk.size=128, "
     "nexmark.generate.strings='false')").format(t=t)
    for t in ("bid", "auction", "person")]


@pytest.mark.parametrize("fusion", ["on", "off"])
def test_hop_absorbed_vs_sequential_sql_oracle_twin(fusion):
    """tests/test_fusion.py:1125 — the fused and the sequential hop give
    the same rows (each held to the reference's), and the fused plan's
    EXPLAIN names the absorption."""
    explain = ("EXPLAIN SELECT window_start, COUNT(*) AS c "
               "FROM HOP(bid, date_time, INTERVAL '2' SECOND, "
               "INTERVAL '10' SECOND) GROUP BY window_start")
    out = run_both([f"SET stream_fusion = '{fusion}'"] + NEXMARK_SOURCES
                   + [HOP_MV, 16, "SELECT * FROM q", explain],
                   rate_limit=16, min_chunks=16)
    text = "\n".join(r[0] for r in explain_body(out[-1]))
    assert ("absorbed HopWindowExecutor" in text) == (fusion == "on")
    other = run_both([f"SET stream_fusion = "
                      f"'{'off' if fusion == 'on' else 'on'}'"]
                     + NEXMARK_SOURCES + [HOP_MV, 16, "SELECT * FROM q"],
                     rate_limit=16, min_chunks=16)
    assert sorted(out[-2]) == sorted(other[-1]) and len(out[-2]) > 1


def test_table_state_tables_equal_reference_by_id(still_clock):
    """A pk-less table (hidden ``_row_id`` from ``RowIdSeq``), a PRIMARY
    KEY table, and an agg MV over the first after INSERT, INSERT SELECT,
    UPDATE and DELETE: every state table equal by id."""
    script = ["CREATE TABLE t (k BIGINT, v BIGINT)",
              "INSERT INTO t VALUES (1, 10), (1, 11), (2, 20), (3, 30)",
              "CREATE TABLE kv (k BIGINT PRIMARY KEY, v VARCHAR)",
              "INSERT INTO kv VALUES (1, 'a'), (2, 'b')",
              "CREATE MATERIALIZED VIEW s AS SELECT k, sum(v) AS s, "
              "count(*) AS n FROM t GROUP BY k",
              "INSERT INTO t SELECT k + 1, 7 FROM kv",
              "DELETE FROM t WHERE k = 1",
              "UPDATE t SET v = v + 1 WHERE k > 1",
              "UPDATE kv SET v = 'c' WHERE k = 2",
              "SELECT * FROM s", "SELECT k, v FROM t"]
    ref, ref_tables, _ = run_script("ref", script, tables=True,
                                    epoch_pipeline=False, rate_limit=8,
                                    min_chunks=8)
    port, port_tables, _ = run_script("port", script, tables=True,
                                      rate_limit=8, min_chunks=8)
    assert [sorted(r) if isinstance(r, list) else r for r in port] == \
        [sorted(r) if isinstance(r, list) else r for r in ref]
    assert sorted(port_tables) == sorted(ref_tables)
    for tid in ref_tables:
        assert port_tables[tid] == ref_tables[tid], f"state table {tid}"
    assert sorted(port[-2]) == [(2, 29, 2), (3, 39, 2)]


def test_filter_clause_on_window_function_rejected_twin():
    """tests/test_over_window.py:362 — FILTER (WHERE ...) OVER errors
    the same way, and the session goes on."""
    out = run_both([BID.format(n=500), Raises(
        "CREATE MATERIALIZED VIEW w AS SELECT count(*) "
        "FILTER (WHERE price < 10000) OVER (PARTITION BY "
        "auction ORDER BY date_time) AS c FROM bid"), 2,
        "SHOW MATERIALIZED VIEWS"], min_chunks=4)
    assert out[1][0] == "raised" and "FILTER" in out[1][2]
    assert out[-1] == []


def test_generate_series_table_function_twin():
    """tests/test_batch.py:102 — FROM generate_series, its alias as the
    column, a negative step, and an aggregate over it."""
    out = run_both(["SELECT * FROM generate_series(1, 5)",
                    "SELECT g * 2 AS d FROM generate_series(10, 2, -3) AS g",
                    "SELECT count(*) FROM generate_series(1, 100)"])
    assert [r[0] for r in out[0]] == [1, 2, 3, 4, 5]
    assert [r[0] for r in out[1]] == [20, 14, 8]
    assert out[2] == [(100,)]
