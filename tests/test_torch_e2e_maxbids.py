"""The cold tier and the slice's paths, the port against the JAX
reference on the CPU:

- ``state/tier.py``: the twins of tests/test_state_tier.py:71, :86,
  :100 (LRU order and cap, the pressure watermark, refresh-only touches)
  against both packages' ``StateTier``, and of :144 and :161 (an agg with
  far more groups than its cap, equal to the uncapped run through
  evictions, reloads and retractions of evicted groups; a restart with
  most groups cold) on both packages' executors;
- ``maxbids``: Nexmark q5's MaxBids subquery over 10 s tumbling windows
  (bid source → project(window_start, auction) → COUNT(*) per (window,
  auction), append-only → MAX/MIN/COUNT/SUM of the counts per window,
  retractable over materialized-input tables → materialize), built from
  the executors of each package, with and without a tier cap on the
  first agg: the MV equals a numpy oracle and the reference's, and every
  state table's rows equal the reference's;
- ``build_q7(tier_cap=8)`` against the reference's and the oracle (the
  uncapped q7 equals the oracle in tests/test_torch_e2e_q7.py), with and
  without watermark retirement, and ``tier_cap=0`` under retirement,
  where every sweep evicts the open window and the next chunk reloads
  it.

The process-global tier is reset between tests.
"""

import asyncio

import numpy as np
import pytest
import torch

from risingwave_tpu.state import tier as ref_tier
from risingwave_tpu.utils import memory as ref_memory
from risingwave_tpu_torch.state import tier as port_tier
from risingwave_tpu_torch.utils import memory as port_memory

from tests import test_torch_agg_kinds as K
from tests.test_torch_e2e_q7 import SCENARIOS, q7_oracle

torch.set_num_threads(2)

TIERS = {"ref": ref_tier, "port": port_tier}


@pytest.fixture(autouse=True)
def _fresh_tier(monkeypatch):
    """Each test starts with empty global tiers and no memory pressure
    (another test in this process may have set a soft limit)."""
    for mod, mem in ((ref_tier, ref_memory), (port_tier, port_memory)):
        monkeypatch.setattr(mod, "GLOBAL", mod.StateTier())
        monkeypatch.setattr(mem.GLOBAL, "soft_limit", None)
    yield


def _no_pressure():
    return type("M", (), {"soft_limit": None, "last_total": 0})()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tier_lru_and_cap(pkg):
    evicted = []
    tier = TIERS[pkg].StateTier(memory=_no_pressure())
    part = tier.register("p", lambda ks: evicted.extend(ks) or len(ks),
                         cap=4)
    tier.touch(part, ["a", "b", "c", "d"], 1)
    tier.touch(part, ["a"], 2)
    tier.touch(part, ["e", "f"], 3)
    assert tier.sweep(part, 4) == 3 and evicted == ["b", "c", "d"]
    assert list(part.keys) == ["a", "e", "f"]
    assert part.evicted_total == 3


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tier_pressure_watermark(pkg):
    mem = type("M", (), {"soft_limit": 100, "last_total": 500})()
    evicted = []
    tier = TIERS[pkg].StateTier(memory=mem)
    part = tier.register("p", lambda ks: evicted.extend(ks) or len(ks))
    tier.touch(part, list(range(10)), 1)
    assert tier.sweep(part, 2) == 5
    assert evicted == [0, 1, 2, 3, 4]
    mem.last_total = 50
    assert tier.sweep(part, 3) == 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tier_insert_false_refreshes_only(pkg):
    tier = TIERS[pkg].StateTier(memory=_no_pressure())
    part = tier.register("p", lambda ks: len(ks), cap=None)
    tier.touch(part, ["a"], 1)
    tier.touch(part, ["a", "b"], 2, insert=False)
    assert list(part.keys) == ["a"]
    assert tier.stats_rows() == [("p", -1, 1, 0, 0, 0)]


# -- the agg under the tier (tests/test_state_tier.py:144, :161) --------------

CALLS = [("sum", 1, False), ("count", None, False)]


def _agg_steps(n_keys=300, wave=100):
    steps, e = [("b", 1)], 2
    for lo in range(0, n_keys, wave):
        steps += [K._c(list(range(lo, lo + wave)),
                       [g * 2 for g in range(lo, lo + wave)]), ("b", e)]
        e += 1
    for lo in range(0, n_keys, wave):
        steps += [K._c(list(range(lo, lo + wave)), [5] * wave), ("b", e)]
        e += 1
    retr = list(range(50))
    steps += [K._c(retr, [g * 2 for g in retr], [2] * len(retr)), ("b", e)]
    return steps


def test_agg_high_cardinality_matches_reference_and_uncapped():
    steps = _agg_steps()
    cap_kw = dict(tier_cap=16, kernel_capacity=1 << 10)
    (recs, rows, ex, _s), _ref = K.twin(K.GV, steps, CALLS, **cap_kw)
    unc = K.run("port", K.GV, steps, CALLS, kernel_capacity=1 << 10)
    assert K.view(recs) == K.view(unc[0])
    assert rows == unc[1]
    part = ex._tier_part
    assert part.evicted_total > 0 and part.reload_total > 0
    assert len(part.keys) <= 16
    ref_part = _ref[2]._tier_part
    assert (part.evicted_total, part.reload_total) == \
        (ref_part.evicted_total, ref_part.reload_total)


def test_agg_crash_recovery_with_evicted_keys_matches_reference():
    steps, e = [("b", 1)], 2
    for lo in range(0, 300, 100):
        steps += [K._c(list(range(lo, lo + 100)), list(range(lo, lo + 100))),
                  ("b", e)]
        e += 1
    touch = list(range(0, 300, 3))
    steps2 = [("b", e), K._c(touch, [1] * len(touch)), ("b", e + 1)]
    out = {}
    for pkg in ("ref", "port"):
        r1 = K.run(pkg, K.GV, steps, CALLS, tier_cap=16,
                   kernel_capacity=1 << 10)
        assert len(r1[2]._cold_groups) > 200
        r2 = K.run(pkg, K.GV, steps2, CALLS, tier_cap=16,
                   kernel_capacity=1 << 10, store=r1[3])
        out[pkg] = (r1[:2], r2[:2])
    assert out["port"] == out["ref"]
    got = K.view(out["port"][0][0] + out["port"][1][0])
    for g in touch:
        assert got[g] == (g + 1, 2)


# -- maxbids: Nexmark q5's MaxBids over tumbling windows ------------------------

def build_maxbids(pkg, store, cfg, tier_cap=None, rate_limit=2,
                  min_chunks=2):
    """bid source → project(window_start, auction) → A: COUNT(*) per
    (window_start, auction), append-only → B: MAX, MIN, COUNT(*), SUM of
    A's counts per window_start, retractable (minput tables) →
    materialize; built from one package's executors."""
    import importlib
    base = "risingwave_tpu" if pkg == "ref" else "risingwave_tpu_torch"
    m = importlib.import_module(f"{base}.models.nexmark")
    ex = importlib.import_module(f"{base}.stream.executors.hash_agg")
    types = importlib.import_module(f"{base}.common.types")
    expr = importlib.import_module(f"{base}.expr.expr")
    kw = {} if pkg == "ref" else {"device": "cpu"}
    dt = types.DataType
    local = m.LocalBarrierManager()
    source = m._source(local, store, 1, cfg, 1, rate_limit, min_chunks)
    s = source.schema
    project = m.ProjectExecutor(
        source, exprs=[expr.tumble_start(
            expr.InputRef(s.index_of("date_time"), dt.TIMESTAMP),
            m.DEFAULT_WINDOW),
            expr.InputRef(s.index_of("auction"), dt.INT64)],
        names=["window_start", "auction"])
    kind = m.AggKind
    calls_a = [ex.AggCall(kind.COUNT)]
    sch_a, pk_a = ex.agg_state_schema(project.schema, [0, 1], calls_a)
    agg_a = ex.HashAggExecutor(
        project, [0, 1], calls_a,
        m.StateTable(2, sch_a, pk_a, store, dist_key_indices=[0, 1]),
        append_only=True, output_names=["num"], tier_cap=tier_cap, **kw)
    calls_b = [ex.AggCall(kind.MAX, 2), ex.AggCall(kind.MIN, 2),
               ex.AggCall(kind.COUNT), ex.AggCall(kind.SUM, 2)]
    sch_b, pk_b = ex.agg_state_schema(agg_a.schema, [0], calls_b)
    dist, minput = ex.agg_aux_tables(agg_a.schema, [0], calls_b, False,
                                     store, lambda c: 10 + c,
                                     lambda j: 20 + j)
    agg_b = ex.HashAggExecutor(
        agg_a, [0], calls_b,
        m.StateTable(3, sch_b, pk_b, store, dist_key_indices=[0]),
        output_names=["max_num", "min_num", "auctions", "bids"],
        minput_tables=minput, distinct_tables=dist, **kw)
    mv = m.StateTable(4, agg_b.schema, [0], store)
    mat = m.MaterializeExecutor(agg_b, mv)
    fin = dict(fragment="maxbids", fusion=False)
    if pkg == "port":
        fin["device"] = "cpu"
    p = m._finish(local, store, mat, mv, 1, {1: source.reader}, **fin)
    return p, agg_a, agg_b, minput


def maxbids_oracle(cfg, n_bids):
    from risingwave_tpu_torch.connectors.nexmark import gen_bids
    from risingwave_tpu_torch.models.nexmark import DEFAULT_WINDOW
    b = gen_bids(np.arange(n_bids, dtype=np.int64), cfg)
    w = b["date_time"] - b["date_time"] % DEFAULT_WINDOW.usecs
    pairs, num = np.unique(np.stack([w, b["auction"]], axis=1), axis=0,
                           return_counts=True)
    out = {}
    for ws in np.unique(pairs[:, 0]).tolist():
        c = num[pairs[:, 0] == ws]
        out[ws] = (int(c.max()), int(c.min()), len(c), int(c.sum()))
    return out


def _run_maxbids(pkg, tier_cap, events=20_000):
    import importlib
    base = "risingwave_tpu" if pkg == "ref" else "risingwave_tpu_torch"
    m = importlib.import_module(f"{base}.models.nexmark")
    store = importlib.import_module(f"{base}.state.store").MemoryStateStore()
    nex = importlib.import_module(f"{base}.connectors.nexmark")
    # 2 ms between events: ~5,000 events a window, each window spanning
    # two or three barriers of 2,048 bids
    cfg = nex.NexmarkConfig(event_num=events, max_chunk_size=1024,
                            min_event_gap_in_ns=2_000_000,
                            generate_strings=False)
    p, agg_a, agg_b, minput = build_maxbids(pkg, store, cfg, tier_cap)
    n_bids = events * 46 // 50
    asyncio.run(m.drive_to_completion(p, {1: n_bids}))
    mv = {r[0]: tuple(r[1:]) for _pk, r in p.mv_table.iter_rows()}
    tables = [list(agg_a.table.iter_rows()), list(agg_b.table.iter_rows())]
    tables += [list(t.iter_rows()) for t in minput.values()]
    return mv, tables, agg_a, cfg, n_bids


@pytest.mark.parametrize("tier_cap", [None, 64])
def test_maxbids_matches_oracle_and_reference(tier_cap):
    mv, tables, agg_a, cfg, n_bids = _run_maxbids("port", tier_cap)
    ref_mv, ref_tables, ref_a, _c, _n = _run_maxbids("ref", tier_cap)
    want = maxbids_oracle(cfg, n_bids)
    assert len(want) >= 3 and mv == want
    assert mv == ref_mv
    assert tables == ref_tables
    if tier_cap is not None:
        part, rpart = agg_a._tier_part, ref_a._tier_part
        assert part.evicted_total > 0 and part.reload_total > 0
        assert (part.evicted_total, part.reload_total) == \
            (rpart.evicted_total, rpart.reload_total)


# -- build_q7(tier_cap=) ----------------------------------------------------------

def _q7_tier_twins(scenario, tier_cap):
    """build_q7(tier_cap=) in both packages on one scenario: the MVs and
    the value-state rows, the port's equal to the oracle's; returns the
    two aggs (port, ref)."""
    from risingwave_tpu.common.types import Interval as RefInterval
    from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
    from risingwave_tpu.models import nexmark as ref_models
    from risingwave_tpu.state.store import MemoryStateStore as RefStore
    from risingwave_tpu_torch.common.types import Interval
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models import nexmark as port_models
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from tests.test_torch_e2e_q7 import _run

    sc = SCENARIOS[scenario]
    out = {}
    for label, build, drive, store, cfg, interval, extra in (
            ("port", port_models.build_q7, port_models.drive_to_completion,
             MemoryStateStore, NexmarkConfig, Interval,
             dict(tier_cap=tier_cap, device="cpu")),
            ("ref", ref_models.build_q7, ref_models.drive_to_completion,
             RefStore, RefConfig, RefInterval, dict(tier_cap=tier_cap))):
        p, mv, rows, agg = _run(build, drive, store(), cfg(**sc["cfg"]),
                                sc["n_bids"], sc["kw"], interval, **extra)
        out[label] = (mv, rows, agg)
    assert out["port"][0] == q7_oracle(NexmarkConfig(**sc["cfg"]),
                                       sc["n_bids"])
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    return out["port"][2], out["ref"][2]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_q7_tier_cap_matches_reference_and_oracle(scenario):
    agg, _ref_agg = _q7_tier_twins(scenario, 8)
    # q7's source chunks per barrier follow the driver's timing (no
    # min_chunks), so the eviction counts are not compared across runs
    if scenario == "plain":
        assert agg._tier_part.evicted_total > 0


def test_q7_tier_cap_zero_evicts_and_reloads_the_open_window():
    """Under watermark retirement only the open window is live at a
    sweep, so a cap of 0 is the one that binds (chip_smoke.py's q7-tier
    arm): each checkpoint evicts the open window, the next chunk that
    touches it reloads it, and a window that closes while cold is
    forgotten. Both packages evict and reload, and agree on the MV and
    the state rows."""
    agg, ref_agg = _q7_tier_twins("watermark", 0)
    for a in (agg, ref_agg):
        assert a._tier_part.evicted_total > 0
        assert a._tier_part.reload_total > 0
