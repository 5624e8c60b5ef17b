"""The temporal join in SQL, and ad-ctr on the port at parallelism 1.

Each case runs one SQL script through the reference's ``Frontend`` and
the port's ``Frontend(device="cpu")`` (``tests/test_torch_frontend.py``'s
harness: ``min_chunks`` pinned to ``rate_limit``) and holds the results
equal.

- Twins of ``tests/test_temporal_join.py:87`` (bids LEFT JOIN a count MV
  ``FOR SYSTEM_TIME AS OF PROCTIME()``) and :121 (a source on the right
  is refused), plus the planner's other refusals: a join kind other than
  INNER or LEFT, ON keys that are not the right MV's pk, and a left
  input that is not append-only.
- ad-ctr (``bench.py``'s ``_adctr_ddl``: two filelog sources, HOP
  windows, a join, a temporal join against the ``ad_dim`` MV and a
  sliding-window agg) at ``tests/test_adctr.py``'s sizes (1,500
  impressions, 20 ads) and parallelism 1: every state table by id equal
  to the reference's one-loop arm, the MV equal to that file's
  ``_oracle``, and ``ad_dim`` counting every impression. Parallelism 4
  is ``ROADMAP.md`` item 10c.
"""

import pytest

from tests.test_adctr import N_IMPRESSIONS, _oracle, _produce
from tests.test_torch_sql_session import still_clock  # noqa: F401
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    Raises, _port_strict_checker, nexmark_source, run_both, run_script,
)



BID = ("CREATE SOURCE bid WITH (connector='nexmark', "
       "nexmark.table.type='bid', nexmark.event.num=3000, "
       "nexmark.max.chunk.size=256)")
DIM = ("CREATE MATERIALIZED VIEW dim AS SELECT auction, count(*) AS c "
       "FROM bid GROUP BY auction")


def test_temporal_join_sql_end_to_end_twin():
    """:87 — every bid emits exactly once, its count frozen as of the
    probe (the port's rows equal the reference's)."""
    script = [BID, DIM,
              "CREATE MATERIALIZED VIEW e AS SELECT b.price, d.c, "
              "b.auction FROM bid AS b LEFT JOIN dim AS d FOR "
              "SYSTEM_TIME AS OF PROCTIME() ON b.auction = d.auction",
              12, "SELECT * FROM e", "SELECT auction, c FROM dim"]
    out = run_both(script, rate_limit=4, min_chunks=4)
    enriched, final = out[-2], dict(out[-1])
    assert len(enriched) == 3000 * 46 // 50
    for _price, c, a in enriched:
        if c is not None:
            assert 1 <= c <= final[a]
    assert any(c is not None for _p, c, _a in enriched)


@pytest.mark.parametrize("sql", [
    # :121 — the right side is a source, not an MV
    "CREATE MATERIALIZED VIEW x AS SELECT b.price FROM bid AS b JOIN "
    "bid AS b2 FOR SYSTEM_TIME AS OF PROCTIME() ON b.auction = b2.auction",
    # a join kind other than INNER or LEFT
    "CREATE MATERIALIZED VIEW x AS SELECT b.price FROM bid AS b FULL "
    "JOIN dim AS d FOR SYSTEM_TIME AS OF PROCTIME() ON b.auction = "
    "d.auction",
    # ON keys that are not the right MV's pk
    "CREATE MATERIALIZED VIEW x AS SELECT b.price FROM bid AS b JOIN "
    "dim AS d FOR SYSTEM_TIME AS OF PROCTIME() ON b.auction = d.c",
    # a left input that retracts (an agg MV chained in)
    "CREATE MATERIALIZED VIEW x AS SELECT l.c FROM dim AS l JOIN dim "
    "AS d FOR SYSTEM_TIME AS OF PROCTIME() ON l.auction = d.auction",
], ids=["source_right", "full_join", "non_pk_keys", "retracting_left"])
def test_temporal_join_refusals_twin(sql):
    """The same error, and the session stays healthy after it: the
    refused CREATE left no chain edge on ``dim`` (a later step and
    read still work)."""
    out = run_both([BID, DIM, Raises(sql), 4,
                    "SELECT count(*) FROM dim"], rate_limit=4, min_chunks=4)
    assert out[2][0] == "raised"
    assert out[-1][0][0] > 0


def _adctr_script(path, steps=40):
    return [
        f"CREATE SOURCE impression (bid_id BIGINT, ad_id BIGINT, "
        f"its TIMESTAMP) WITH (connector='filelog', "
        f"path='{path}', topic='impressions')",
        f"CREATE SOURCE click (cbid BIGINT, cts TIMESTAMP) WITH "
        f"(connector='filelog', path='{path}', topic='clicks')",
        "CREATE MATERIALIZED VIEW ad_dim AS SELECT ad_id, "
        "count(*) AS seen FROM impression GROUP BY ad_id",
        "CREATE MATERIALIZED VIEW ad_ctr AS SELECT i.ad_id, "
        "i.window_start, count(*) AS clicked "
        "FROM HOP(impression, its, INTERVAL '2' SECOND, "
        "INTERVAL '10' SECOND) AS i "
        "JOIN click AS c ON i.bid_id = c.cbid "
        "JOIN ad_dim AS d FOR SYSTEM_TIME AS OF PROCTIME() "
        "ON i.ad_id = d.ad_id "
        "GROUP BY i.ad_id, i.window_start",
        steps, "SELECT * FROM ad_ctr", "SELECT ad_id, seen FROM ad_dim"]


def test_adctr_parallelism_1_state_tables_and_oracle(tmp_path, still_clock):
    path = str(tmp_path)
    ads = _produce(path)
    script = _adctr_script(path)
    kw = dict(rate_limit=4, min_chunks=4)
    ref, ref_tables, _ = run_script("ref", script, tables=True,
                                    epoch_pipeline=False, **kw)
    port, port_tables, _ = run_script("port", script, tables=True, **kw)
    assert sorted(port[-2]) == sorted(ref[-2])
    assert sorted(port[-1]) == sorted(ref[-1])
    assert sorted(port_tables) == sorted(ref_tables)
    for tid in ref_tables:
        assert port_tables[tid] == ref_tables[tid], f"state table {tid}"
    # sources' splits (x3), ad_dim's agg and MV, the chain's backfill
    # progress, both join sides, ad_ctr's agg and MV
    assert len(port_tables) >= 10
    got = {(a, w): c for a, w, c in port[-2]}
    assert got == _oracle(ads)
    assert sum(s for _a, s in port[-1]) == N_IMPRESSIONS
    # and under the reference's default (barrier domains on)
    run_both(script, **kw)
