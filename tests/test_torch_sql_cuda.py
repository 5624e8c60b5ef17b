"""SQL through the port's Frontend on the card, against the same SQL on
the port's CPU path.

Marked ``cuda``: without a card every test here skips. On a CUDA host
run ``python -m pytest --noconftest -m cuda tests/test_torch_sql_cuda.py``
(``--noconftest``: tests/conftest.py imports JAX, which this file does
not). A handful of the query corpus's shapes (``tests/test_corpus.py``,
``tests/test_frontend.py``) run on ``Frontend(device="cuda")`` and on
``Frontend(device="cpu")``: a join, a hop window, an over-window, a TopN
and a DECIMAL agg. Their MV rows must be equal as multisets (on the card
K1's slot order moves only the order in which groups flush, ``ROADMAP.md``
queue C), and the card's run must have launched the kernels of its plan.

The scripts of the tables-and-DML slice run the same way, each a list of
statements and steps: a table with INSERT, UPDATE and DELETE under an agg
MV, an MV over an MV (backfilled mid-stream), a temporal join against an
MV, a datagen source and a filelog source. Every SELECT's rows must be
equal between the card and the CPU.

At parallelism 4 (``PARALLEL_SCRIPTS``) a GROUP BY over a join runs on the
sharded kernels and is rescheduled by ``ALTER ... SET PARALLELISM`` to 1
and to 8, each SELECT equal between the card and the CPU.
"""

import asyncio
from collections import Counter

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _nexmark(t, n, chunk=256):
    return (f"CREATE SOURCE {t} WITH (connector='nexmark', "
            f"nexmark.table.type='{t}', nexmark.event.num={n}, "
            f"nexmark.max.chunk.size={chunk}, "
            f"nexmark.min.event.gap.in.ns=100000000)")


def _tpch(t):
    return (f"CREATE SOURCE {t} WITH (connector='tpch', tpch.table='{t}', "
            f"tpch.customers=300, tpch.orders=2000)")


# name -> (sources, CREATE MATERIALIZED VIEW, SELECT, kernels it launches)
CASES = {
    "q20_join": (
        [_nexmark("bid", 8000), _nexmark("auction", 8000)],
        "CREATE MATERIALIZED VIEW v AS SELECT b.auction, b.bidder, "
        "b.price, a.item_name, a.category FROM bid AS b "
        "JOIN auction AS a ON b.auction = a.id WHERE a.category = 12",
        "SELECT * FROM v", ("probe_insert", "join_apply", "join_probe")),
    "hop_window": (
        [_nexmark("bid", 8000)],
        "CREATE MATERIALIZED VIEW v AS SELECT auction, window_start, "
        "count(*) AS c FROM HOP(bid, date_time, INTERVAL '2' SECOND, "
        "INTERVAL '10' SECOND) GROUP BY auction, window_start",
        "SELECT * FROM v", ("probe_insert", "agg_apply", "agg_prelude")),
    "q18_over_window": (
        [_nexmark("bid", 8000)],
        "CREATE MATERIALIZED VIEW v AS SELECT auction, bidder, price, "
        "date_time FROM (SELECT auction, bidder, price, date_time, "
        "row_number() OVER (PARTITION BY bidder, auction ORDER BY "
        "date_time DESC) AS rn FROM bid) AS t WHERE rn = 1",
        "SELECT * FROM v", ()),
    "q105_topn": (
        [_nexmark("bid", 8000)],
        "CREATE MATERIALIZED VIEW v AS SELECT auction, count(*) AS num "
        "FROM bid GROUP BY auction ORDER BY num DESC, auction LIMIT 10",
        "SELECT * FROM v", ("probe_insert", "agg_apply", "flush_gather")),
    "tpch_q1_decimal": (
        [_tpch("lineitem")],
        "CREATE MATERIALIZED VIEW v AS SELECT l_returnflag, "
        "l_linestatus, sum(l_quantity) AS sum_qty, "
        "sum(l_extendedprice) AS sum_base, "
        "sum(l_extendedprice * (1 - l_discount)) AS sum_disc, "
        "count(*) AS cnt FROM lineitem GROUP BY l_returnflag, "
        "l_linestatus",
        "SELECT * FROM v", ("probe_insert", "agg_apply", "flush_gather")),
}


def _run(device, sources, mv, select):
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    from risingwave_tpu_torch.utils.device import LAUNCHES

    async def main():
        fe = Frontend(rate_limit=8, min_chunks=8, device=device)
        for s in sources:
            await fe.execute(s)
        await fe.execute(mv)
        LAUNCHES.reset()
        await fe.step(16)
        launches = LAUNCHES.snapshot()
        rows = await fe.execute(select)
        await fe.close()
        return rows, launches

    set_strict_checker(True)
    try:
        rows, launches = asyncio.run(main())
    finally:
        set_strict_checker(False)
    norm = [tuple(v.item() if isinstance(v, np.generic) else v for v in r)
            for r in rows]
    return Counter(norm), launches


@pytest.mark.parametrize("name", sorted(CASES))
def test_sql_on_the_card_matches_the_cpu(dev, name):
    sources, mv, select, kernels = CASES[name]
    got, launches = _run(dev, sources, mv, select)
    want, cpu_launches = _run(torch.device("cpu"), sources, mv, select)
    assert got == want and sum(want.values()) > 0, name
    assert not cpu_launches
    missing = [k for k in kernels if not launches.get(k)]
    assert not missing, f"{name} never launched {missing}"


def _filelog_topic(path, n=3000):
    import json
    import os
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trades-0.log"), "wb") as f:
        for i in range(n):
            f.write(json.dumps({"k": i, "name": f"sym{i % 7}",
                                "price": float(i % 113)}).encode() + b"\n")


# name -> (script: statements and step counts, kernels it launches)
SCRIPTS = {
    "table_dml": (
        ["CREATE TABLE t (k BIGINT, v BIGINT)",
         "INSERT INTO t VALUES (1, 10), (1, 11), (2, 20), (3, 30), (4, 5)",
         "CREATE MATERIALIZED VIEW s AS SELECT k, sum(v) AS s, "
         "min(v) AS lo, count(*) AS n FROM t GROUP BY k", 2,
         "SELECT * FROM s", "UPDATE t SET v = v + 1 WHERE k > 1",
         "DELETE FROM t WHERE k = 1", "SELECT * FROM s",
         "INSERT INTO t SELECT k + 10, v FROM t", "SELECT * FROM s",
         "SELECT k, v FROM t"],
        ("probe_insert", "agg_apply", "flush_gather", "advance")),
    "mv_on_mv": (
        [_nexmark("bid", 8000),
         "CREATE MATERIALIZED VIEW m1 AS SELECT auction, count(*) AS c "
         "FROM bid GROUP BY auction", 4,
         "CREATE MATERIALIZED VIEW m2 AS SELECT c, count(*) AS n, "
         "min(auction) AS ma FROM m1 GROUP BY c", 24,
         "SELECT * FROM m1", "SELECT * FROM m2"],
        ("probe_insert", "agg_apply", "flush_gather", "advance")),
    "temporal_join": (
        [_nexmark("bid", 8000),
         "CREATE MATERIALIZED VIEW dim AS SELECT auction, count(*) AS c "
         "FROM bid GROUP BY auction",
         "CREATE MATERIALIZED VIEW e AS SELECT b.price, d.c, b.auction "
         "FROM bid AS b LEFT JOIN dim AS d FOR SYSTEM_TIME AS OF "
         "PROCTIME() ON b.auction = d.auction", 16, "SELECT * FROM e"],
        ("probe_insert", "agg_apply", "flush_gather")),
    "datagen": (
        ["CREATE SOURCE g WITH (connector='datagen', "
         "fields.id.type='bigint', fields.id.kind='sequence', "
         "fields.id.start=0, fields.id.end=100000, "
         "fields.v.type='bigint', fields.v.kind='random', "
         "fields.v.min=0, fields.v.max=50, "
         "datagen.rows.per.chunk=1000, datagen.event.num=20000)",
         "CREATE MATERIALIZED VIEW dg AS SELECT v, count(*) AS c, "
         "max(id) AS top FROM g GROUP BY v", 8, "SELECT * FROM dg"],
        ("probe_insert", "agg_apply", "flush_gather")),
    "filelog": (
        ["CREATE SOURCE trades (k BIGINT, name VARCHAR, price DOUBLE "
         "PRECISION) WITH (connector='filelog', path='{path}', "
         "topic='trades', format='json', max.chunk.size=256)",
         "CREATE MATERIALIZED VIEW v AS SELECT name, count(*) AS c, "
         "sum(k) AS s, max(price) AS hi FROM trades GROUP BY name", 8,
         "SELECT * FROM v"],
        ("probe_insert", "agg_apply", "flush_gather")),
}


def _run_script(device, script, parallelism=1):
    from risingwave_tpu_torch.frontend import Frontend
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    from risingwave_tpu_torch.utils.device import LAUNCHES

    async def main():
        fe = Frontend(rate_limit=8, min_chunks=8, device=device,
                      parallelism=parallelism)
        LAUNCHES.reset()
        out = []
        for item in script:
            if isinstance(item, int):
                await fe.step(item)
                continue
            r = await fe.execute(item)
            if isinstance(r, list):
                out.append(Counter(
                    tuple(v.item() if isinstance(v, np.generic) else v
                          for v in row) for row in r))
            else:
                out.append(r)
        launches = LAUNCHES.snapshot()
        await fe.close()
        return out, launches

    set_strict_checker(True)
    try:
        return asyncio.run(main())
    finally:
        set_strict_checker(False)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_sql_scripts_on_the_card_match_the_cpu(dev, name, tmp_path):
    script, kernels = SCRIPTS[name]
    path = str(tmp_path / "topic")
    _filelog_topic(path)
    script = [s.format(path=path) if isinstance(s, str) else s
              for s in script]
    got, launches = _run_script(dev, script)
    want, cpu_launches = _run_script(torch.device("cpu"), script)
    assert got == want, name
    assert any(isinstance(r, Counter) and sum(r.values()) for r in want)
    assert not cpu_launches
    missing = [k for k in kernels if not launches.get(k)]
    assert not missing, f"{name} never launched {missing}"


# name -> (script, kernels it launches, the session's parallelism)
PARALLEL_SCRIPTS = {
    "join_agg_alter": (
        [_nexmark("person", 80000, chunk=64),
         _nexmark("auction", 80000, chunk=64),
         "CREATE MATERIALIZED VIEW j AS SELECT p.id, count(*) AS n, "
         "max(a.reserve) AS r FROM person AS p JOIN auction AS a "
         "ON p.id = a.seller GROUP BY p.id", 4, "SELECT * FROM j",
         "ALTER MATERIALIZED VIEW j SET PARALLELISM = 1", 4,
         "SELECT * FROM j", "ALTER MATERIALIZED VIEW j SET PARALLELISM = 8",
         16, "SELECT * FROM j"],
        ("route", "probe_insert", "agg_apply", "flush_gather", "advance",
         "join_apply", "join_probe", "scatter_rows"), 4),
}


@pytest.mark.parametrize("name", sorted(PARALLEL_SCRIPTS))
def test_sql_at_parallelism_on_the_card_matches_the_cpu(dev, name):
    script, kernels, parallelism = PARALLEL_SCRIPTS[name]
    got, launches = _run_script(dev, script, parallelism)
    want, cpu_launches = _run_script(torch.device("cpu"), script,
                                     parallelism)
    assert got == want, name
    assert all(sum(r.values()) for r in want if isinstance(r, Counter))
    assert not cpu_launches
    missing = [k for k in kernels if not launches.get(k)]
    assert not missing, f"{name} never launched {missing}"
