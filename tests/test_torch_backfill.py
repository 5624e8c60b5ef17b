"""MV on MV in the port: backfill, chain edges, drops.

Each case runs one SQL script through the reference's ``Frontend`` and
the port's ``Frontend(device="cpu")`` (``tests/test_torch_frontend.py``'s
harness: ``min_chunks`` pinned to ``rate_limit``) and holds the results
equal.

- Twins of ``tests/test_backfill.py:21`` (an MV over an already
  populated MV catches up and stays live), :87 (an upstream with a
  dependent refuses DROP) and :103 (DROP of the downstream detaches
  exactly its edge and the upstream stays live), and of
  ``tests/test_frontend.py:504`` (a GROUP BY over a retracting count MV:
  the downstream agg plans K2's retractable mode, with MIN through the
  patched ``advance``).
- A chain created mid-stream over an agg MV: every state table of both
  MVs, the backfill's progress table included, equal by id to the
  reference's one-loop arm, with both epoch clocks held still.
"""

import asyncio
from collections import Counter

import pytest

from risingwave_tpu_torch.frontend.session import Frontend
from tests.test_torch_sql_session import still_clock  # noqa: F401
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    Raises, _port_strict_checker, run_both, run_script,
)

SRC = ("CREATE SOURCE bid WITH (connector='nexmark', "
       "nexmark.table.type='bid', nexmark.event.num={n}, "
       "nexmark.max.chunk.size=128)")



def _agg_modes(fe):
    """MV name → append_only of each of its plan's hash aggs, top down."""
    def walk(ex, out):
        if type(ex).__name__ == "HashAggExecutor":
            out.append(bool(ex.append_only))
        for attr in ("input", "left_in", "right_in", "upstream"):
            c = getattr(ex, attr, None)
            if c is not None and hasattr(c, "execute"):
                walk(c, out)
        return out
    return {name: walk(fe.actors[mv.actor_id].consumer, [])
            for name, mv in fe.catalog.mvs.items()}


def test_mv_on_mv_catches_up_and_stays_live_twin():
    """:21 — b backfills a's snapshot, then follows a's changelog."""
    script = [SRC.format(n=4000),
              "CREATE MATERIALIZED VIEW a AS SELECT auction, price "
              "FROM bid WHERE price > 100", 10,
              "SELECT count(*) FROM a",
              "CREATE MATERIALIZED VIEW b AS SELECT auction, count(*) "
              "AS c FROM a GROUP BY auction", 40,
              "SELECT auction, c FROM b",
              "SELECT auction, count(*) AS c FROM a GROUP BY auction"]
    out = run_both(script, rate_limit=2)
    assert out[2][0][0] > 500
    assert sorted(out[-2]) == sorted(out[-1]) and len(out[-1]) > 10


def test_drop_upstream_mv_with_dependent_is_refused_twin():
    """:87 — the same refusal, then the drops in order succeed."""
    out = run_both([SRC.format(n=500),
                    "CREATE MATERIALIZED VIEW a AS SELECT auction FROM bid",
                    "CREATE MATERIALIZED VIEW b AS SELECT auction FROM a",
                    Raises("DROP MATERIALIZED VIEW a"),
                    "DROP MATERIALIZED VIEW b",
                    "DROP MATERIALIZED VIEW a", "SHOW MATERIALIZED VIEWS"],
                   rate_limit=2)
    assert out[3][0] == "raised" and "depended on" in out[3][2]
    assert out[-1] == []


def test_drop_chained_mv_detaches_and_pipeline_stays_live_twin():
    """:103 — the dropped chain's output leaves a's dispatcher, and 40
    more barriers (past any channel's permits) still complete."""
    script = [SRC.format(n=100_000),
              "CREATE MATERIALIZED VIEW a AS SELECT auction FROM bid",
              "CREATE MATERIALIZED VIEW b AS SELECT auction FROM a", 5,
              "DROP MATERIALIZED VIEW b", 40, "SELECT count(*) FROM a"]
    out = run_both(script, rate_limit=2)
    assert out[-1][0][0] > 0

    async def main():
        f = Frontend(rate_limit=2, min_chunks=2, device="cpu")
        for sql in script[:3]:
            await f.execute(sql)
        up = f.actors[f.catalog.mvs["a"].actor_id]
        assert len(up.dispatchers[0].outputs()) == 1
        await f.step(5)
        await f.execute("DROP MATERIALIZED VIEW b")
        assert up.dispatchers[0].outputs() == []   # edge detached
        for _ in range(40):
            await asyncio.wait_for(f.step(), timeout=10)
        await f.close()
    asyncio.run(main())


def test_group_by_over_retracting_mv_histogram_twin():
    """tests/test_frontend.py:504 — m2 is m1's count histogram with the
    smallest auction per count; m1's agg is append-only, m2's over m1's
    changelog retractable (a hardcoded append-only agg overcounts)."""
    script = ["CREATE SOURCE bid WITH (connector='nexmark', "
              "nexmark.table.type='bid', nexmark.event.num=6000, "
              "nexmark.max.chunk.size=256)",
              "CREATE MATERIALIZED VIEW m1 AS SELECT auction, count(*) "
              "AS c FROM bid GROUP BY auction",
              "CREATE MATERIALIZED VIEW m2 AS SELECT c, count(*) AS n, "
              "min(auction) AS ma FROM m1 GROUP BY c", 30,
              "SELECT * FROM m1", "SELECT * FROM m2"]
    out = run_both(script, min_chunks=4)
    m1, m2 = out[-2], out[-1]
    want_n = Counter(c for _a, c in m1)
    want_ma = {}
    for a, c in m1:
        want_ma[c] = min(want_ma.get(c, a), a)
    assert {c: (n, ma) for c, n, ma in m2} == \
        {c: (n, want_ma[c]) for c, n in want_n.items()}
    assert len(m1) > 100
    _res, _tables, modes = run_script("port", script[:3], hook=_agg_modes,
                                      rate_limit=4, min_chunks=4)
    assert modes == {"m1": [True], "m2": [False]}


def test_chain_mid_stream_state_tables_equal_reference_by_id(still_clock):
    """m2 is created after m1 ran 6 barriers and backfills m1's snapshot
    while m1 keeps running; every state table of both MVs (m1's split
    and agg state and MV, the backfill's progress, m2's agg, MIN input
    and MV) equals the reference's by id."""
    script = [SRC.format(n=12_000),
              "CREATE MATERIALIZED VIEW m1 AS SELECT auction, count(*) "
              "AS c FROM bid GROUP BY auction", 6,
              "CREATE MATERIALIZED VIEW m2 AS SELECT c, count(*) AS n, "
              "min(auction) AS ma FROM m1 GROUP BY c", 30,
              "SELECT * FROM m2"]
    kw = dict(rate_limit=4, min_chunks=4)
    ref, ref_tables, _ = run_script("ref", script, tables=True,
                                    epoch_pipeline=False, **kw)
    port, port_tables, _ = run_script("port", script, tables=True, **kw)
    assert Counter(port[-1]) == Counter(ref[-1]) and port[-1]
    assert sorted(port_tables) == sorted(ref_tables)
    for tid in ref_tables:
        assert port_tables[tid] == ref_tables[tid], f"state table {tid}"
    # the backfill's progress row says done
    assert any(len(rows) == 1 and rows[0][1][1] is True
               for rows in port_tables.values())
