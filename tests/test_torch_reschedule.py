"""ALTER MATERIALIZED VIEW ... SET PARALLELISM: the port against the
reference.

The reschedule stops the job at a barrier with its state kept, replans
the same definition from the same table-id base over the new mesh (the
port's ``ShardMesh``: logical shards of one device; the reference's: an
n-device mesh of tests/conftest.py's virtual CPU devices), and the
redeployed executors recover from the kept state tables. Each case runs
one script through both packages' ``Frontend`` (the port's on
``device="cpu"``) with ``min_chunks`` pinned to ``rate_limit``.

- Twins of ``tests/test_reschedule.py:54`` (2 → 4 mid-stream, no
  divergence from an uninterrupted one-device run), :118 (4 → 1 lands
  on the one-device kernel) and :137 (unknown and chained MVs refused),
  plus the reference's other refusals: a table, an MV that predates
  ``id_base``, and the drop-on-failure that keeps the state tables.
- ``tests/test_fusion.py:683``: ALTER back to 1 re-fuses as the CREATE
  did, whatever the session's ``stream_fusion`` is now.
- Every state table by id and key-sorted, before and after each ALTER
  of 1 → 8 → 1 of the reschedule MV and after a 1 → 4 ALTER of a
  MIN/MAX MV over a retracting join, equal to the reference's one-loop
  arm at each point and, drained, to an uninterrupted reference run
  (both epoch clocks held still).
"""

import asyncio

import pytest

import risingwave_tpu.frontend.planner as r_planner
import risingwave_tpu_torch.frontend.planner as p_planner
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    Raises, _port_strict_checker, frontend, nexmark_source, norm_rows,
    store_tables,
)
from tests.test_torch_sql_parallel import kernels, sharded
from tests.test_torch_sql_session import still_clock  # noqa: F401

SRC = nexmark_source("bid", 6000, chunk=256)
MV = ("CREATE MATERIALIZED VIEW v AS SELECT auction, count(*) AS c, "
      "max(price) AS m FROM bid GROUP BY auction")
KW = dict(rate_limit=4, min_chunks=4)

TABLES, KERNELS = "<tables>", "<kernels>"


def alter(name, n):
    return f"ALTER MATERIALIZED VIEW {name} SET PARALLELISM = {n}"


def run(pkg, script, hook=None, **kw):
    """Run ``script`` through one package's Frontend: a str executes
    (rows key-sorted), an int steps, ``Raises`` records the error,
    TABLES records every state table (key-sorted), KERNELS the plans'
    kernels."""
    async def main():
        fe = frontend(pkg, **kw)
        out = []
        for item in script:
            if isinstance(item, int):
                await fe.step(item)
            elif item is TABLES:
                out.append({t: sorted(rows) for t, rows
                            in store_tables(fe.store).items()})
            elif item is KERNELS:
                out.append(kernels(fe))
            elif isinstance(item, Raises):
                try:
                    await fe.execute(item.sql)
                except Exception as e:  # noqa: BLE001 — compared
                    out.append(("raised", type(e).__name__, str(e)))
                else:
                    out.append(("did not raise", item.sql))
            else:
                r = await fe.execute(item)
                out.append(sorted(norm_rows(r)) if isinstance(r, list)
                           else r)
        if hook is not None:
            out.append(hook(fe))
        await fe.close()
        return out
    return asyncio.run(main())


def run_twin(script, **kw):
    """Both packages on one script; every result equal. The port's."""
    kw = dict(KW, **kw)
    ref = run("ref", script, **kw)
    port = run("port", script, **kw)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"result {i}"
    return port


def uninterrupted(script_tail=("SELECT * FROM v",), mv=MV):
    return run("ref", [SRC, mv, 40, *script_tail], **KW)


def test_alter_parallelism_live_no_divergence_twin(eight_devices):
    """:54 — 2 → 4 mid-stream: the kernels reshard and the final MV
    equals an uninterrupted one-device run."""
    out = run_twin([SRC, MV, KERNELS, 8, "SELECT * FROM v", alter("v", 4),
                    KERNELS, 40, "SELECT * FROM v"], parallelism=2)
    assert out[2] == sharded(2, aggs=1) and out[5] == sharded(4, aggs=1)
    assert out[3] and any(r[1] > 1 for r in out[3])
    assert out[4] == "ALTER_MATERIALIZED_VIEW"
    assert out[-1] == uninterrupted()[-1]


def test_alter_parallelism_down_to_single_chip_twin(eight_devices):
    """:118 — 4 → 1 lands back on the one-device kernel."""
    out = run_twin([SRC, MV, 8, alter("v", 1), KERNELS, 40,
                    "SELECT * FROM v"], parallelism=4)
    assert out[3] == [("agg", "GroupedAggKernel", 1)]
    assert out[-1] == uninterrupted()[-1]


def test_alter_refusals_twin():
    """:137 — an unknown MV, and chained MVs both ways (the upstream of
    a chain and the MV over it), are refused with the reference's
    errors; so are a table and an MV that predates id_base (the
    reference's own refusals); the session goes on after each."""
    async def main(pkg):
        fe = frontend(pkg, **KW)
        out = []
        for sql in (SRC, MV, "CREATE MATERIALIZED VIEW v2 AS SELECT c, "
                    "count(*) AS n FROM v GROUP BY c",
                    "CREATE TABLE t (k BIGINT, v BIGINT)",
                    "CREATE MATERIALIZED VIEW w AS SELECT bidder, "
                    "count(*) AS n FROM bid GROUP BY bidder"):
            await fe.execute(sql)
        fe.catalog.mvs["w"].id_base = -1
        for sql in (alter("nope", 2), alter("v", 2), alter("v2", 2),
                    alter("t", 2), alter("w", 2)):
            with pytest.raises(Exception) as ei:
                await fe.execute(sql)
            out.append((type(ei.value).__name__, str(ei.value)))
        await fe.step(2)
        out.append(sorted(norm_rows(await fe.execute("SELECT * FROM v2"))))
        await fe.close()
        return out

    port = asyncio.run(main("port"))
    assert port == asyncio.run(main("ref"))
    assert "unknown" in port[0][1]
    assert "chained" in port[1][1] and "chained" in port[2][1]
    assert "no CREATE statement" in port[3][1]
    assert "predates" in port[4][1]
    assert port[-1]


def test_alter_failure_drops_the_mv_and_keeps_its_state(monkeypatch):
    """A replan that fails after the teardown degrades the MV to dropped
    with its state tables kept, as the reference does, and the session
    goes on."""
    for mod in (r_planner, p_planner):
        plan = mod.StreamPlanner.plan

        def failing(self, name, *a, _plan=plan, **k):
            if name == "v" and getattr(self, "_fail_alter", False):
                raise RuntimeError("replan failed")
            return _plan(self, name, *a, **k)
        monkeypatch.setattr(mod.StreamPlanner, "plan", failing)

    async def main(pkg):
        mod = p_planner if pkg == "port" else r_planner
        fe = frontend(pkg, **KW)
        await fe.execute(SRC)
        await fe.execute(MV)
        await fe.step(4)
        before = store_tables(fe.store)
        monkeypatch.setattr(mod.StreamPlanner, "_fail_alter", True,
                            raising=False)
        try:
            with pytest.raises(Exception) as ei:
                await fe.execute(alter("v", 2))
        finally:
            monkeypatch.setattr(mod.StreamPlanner, "_fail_alter", False,
                                raising=False)
        err = (type(ei.value).__name__, str(ei.value))
        shown = await fe.execute("SHOW MATERIALIZED VIEWS")
        await fe.step(2)
        kept = store_tables(fe.store)
        kept_ids = sorted(t for t in before if t in kept)
        await fe.close()
        return err, shown, kept_ids == sorted(before)

    port = asyncio.run(main("port"))
    assert port == asyncio.run(main("ref"))
    assert port[0][0] == "PlanError" and "dropped" in port[0][1]
    assert port[1] == [] and port[2]


# -- tests/test_fusion.py:683 ------------------------------------------------


Q7 = ("CREATE MATERIALIZED VIEW q AS SELECT window_start, MAX(price) AS "
      "max_price, COUNT(*) AS cnt FROM TUMBLE(bid, date_time, "
      "INTERVAL '10' SECOND) GROUP BY window_start")
FUSION_SOURCES = [nexmark_source(t, 2000, chunk=128,
                                 extra=", nexmark.generate.strings='false'")
                  for t in ("bid", "auction", "person")]


def fused_aggs(fe):
    out = []

    def walk(ex):
        ex = getattr(ex, "inner", None) or ex
        if type(ex).__name__ == "HashAggExecutor":
            out.append(ex.fused_stages is not None)
        for attr in ("input", "left_in", "right_in"):
            c = getattr(ex, attr, None)
            if c is not None and hasattr(c, "execute"):
                walk(c)
    for a in fe.actors.values():
        walk(a.consumer)
    return out


def test_reschedule_replays_fusion_twin():
    """:683 — CREATE fuses under the session default; with stream_fusion
    then set off, ALTER ... SET PARALLELISM = 1 re-fuses from the
    CREATE-time setting, and the state survives."""
    script = FUSION_SOURCES + [Q7, 4, "SELECT * FROM q",
                               "SET stream_fusion = 'off'", alter("q", 1),
                               4, "SELECT * FROM q"]
    out = run_twin(script, rate_limit=8, min_chunks=8)
    port = run("port", script, hook=fused_aggs, rate_limit=8, min_chunks=8)
    assert port[-1] == [True]
    rows1, rows2 = out[4], out[-1]
    assert [r for r in rows1 if r in rows2]


# -- state tables by id --------------------------------------------------------


def test_alter_1_8_1_state_tables_by_id(eight_devices, still_clock):
    """The reschedule MV through 1 → 8 → 1: every state table by id at
    each point equal to the reference's, the kernels resharded each way,
    and the drained state equal to an uninterrupted reference run's."""
    script = [SRC, MV, 6, TABLES, alter("v", 8), KERNELS, TABLES, 4,
              TABLES, alter("v", 1), KERNELS, TABLES, 40, TABLES,
              "SELECT * FROM v"]
    out = run_twin(script, epoch_pipeline=False)
    assert out[4] == sharded(8, aggs=1)
    assert out[8] == [("agg", "GroupedAggKernel", 1)]
    # each ALTER kept every table (its barriers carried more rows in)
    assert set(out[2]) <= set(out[5]) and set(out[6]) <= set(out[9])
    ref = run("ref", [SRC, MV, 40, TABLES, "SELECT * FROM v"],
              epoch_pipeline=False, **KW)
    assert out[-2] == ref[-2] and out[-1] == ref[-1]
    assert len(out[-2]) >= 3


RETRACTING_MINMAX = (
    "CREATE MATERIALIZED VIEW g AS SELECT p.id, count(*) AS c, "
    "max(a.category) AS mc, min(a.reserve) AS mr FROM person AS p "
    "LEFT JOIN auction AS a ON p.id = a.seller GROUP BY p.id")


def test_alter_minmax_over_a_join_state_tables_by_id(eight_devices,
                                                     still_clock):
    """A MIN/MAX agg over a LEFT JOIN (its input retracts: the minput
    tables) at 1 → 4: the sharded join and agg reload from the kept
    tables, and every state table by id equals the reference's after the
    ALTER and, drained, an uninterrupted reference run's."""
    sources = [nexmark_source("person", 4000, chunk=128),
               nexmark_source("auction", 4000, chunk=128)]
    script = sources + [RETRACTING_MINMAX, 4, alter("g", 4), KERNELS,
                        TABLES, 40, TABLES, "SELECT * FROM g"]
    out = run_twin(script, epoch_pipeline=False)
    assert out[4] == sharded(4, aggs=1, joins=1)
    ref = run("ref", sources + [RETRACTING_MINMAX, 44, TABLES,
                                "SELECT * FROM g"],
              epoch_pipeline=False, **KW)
    assert out[-2] == ref[-2] and out[-1] == ref[-1]
    assert any(r[2] is None for r in out[-1])
    assert any(r[2] is not None for r in out[-1])
