"""The port's other agg kinds against the JAX reference, executor by
executor: retractable MIN/MAX over materialized-input tables (the host
recompute patched back through K9), DISTINCT over dedup tables,
approx_count_distinct on host sketches, and string_agg / array_agg over
value multisets.

Each case builds the same ``HashAggExecutor`` in both packages from the
same scripted messages (no SQL) and compares the emitted chunks record by
record, the folded view, and every state table's rows: the value state,
the materialized-input, dedup and sketch tables. These are the executor
twins of tests/test_hash_agg.py:207, :226, :248, :380 (retractable
MIN/MAX), :485, :499 (DISTINCT), :539 (the HLL primitives) and the
executor content of :559, :614, :640 and :678, which the reference runs
through SQL. Every kernel runs its plain version on the CPU, so the
states are the reference's bit for bit.
"""

import asyncio

import numpy as np
import pytest
import torch

from risingwave_tpu.common import chunk as ref_chunk
from risingwave_tpu.common import epoch as ref_epoch
from risingwave_tpu.common import types as ref_types
from risingwave_tpu.connectors import nexmark as ref_nex
from risingwave_tpu.ops import hash_agg as ref_agg
from risingwave_tpu.state.state_table import StateTable as RefStateTable
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream import message as ref_msg
from risingwave_tpu.stream.executors import hash_agg as ref_exec
from risingwave_tpu.stream.executors import test_utils as ref_utils
from risingwave_tpu_torch.common import chunk as port_chunk
from risingwave_tpu_torch.common import epoch as port_epoch
from risingwave_tpu_torch.common import types as port_types
from risingwave_tpu_torch.connectors import nexmark as port_nex
from risingwave_tpu_torch.ops import hash_agg as port_agg
from risingwave_tpu_torch.state.state_table import StateTable as PortStateTable
from risingwave_tpu_torch.state.store import MemoryStateStore as PortStore
from risingwave_tpu_torch.stream import message as port_msg
from risingwave_tpu_torch.stream.executors import hash_agg as port_exec
from risingwave_tpu_torch.stream.executors import test_utils as port_utils

torch.set_num_threads(2)

PKG = {
    "ref": dict(types=ref_types, epoch=ref_epoch, msg=ref_msg,
                chunk=ref_chunk, ex=ref_exec, utils=ref_utils,
                Table=RefStateTable, Store=RefStore, agg=ref_agg,
                nex=ref_nex, kw={}),
    "port": dict(types=port_types, epoch=port_epoch, msg=port_msg,
                 chunk=port_chunk, ex=port_exec, utils=port_utils,
                 Table=PortStateTable, Store=PortStore, agg=port_agg,
                 nex=port_nex, kw={"device": "cpu"}),
}


def barrier(pkg, n):
    m, e = PKG[pkg]["msg"], PKG[pkg]["epoch"]
    curr = e.Epoch.from_physical(n)
    prev = e.Epoch.from_physical(n - 1) if n > 1 else e.Epoch.INVALID
    return m.Barrier(e.EpochPair(curr, prev), m.BarrierKind.CHECKPOINT)


def schema(pkg, cols):
    """cols: [(name, DataType name)]."""
    t = PKG[pkg]["types"]
    return t.Schema([t.Field(n, t.DataType[d]) for n, d in cols])


def script(pkg, cols, steps):
    """Abstract steps → one package's messages: ("b", n) or ("c",
    {col: values}, ops | None)."""
    sch = schema(pkg, cols)
    out = []
    for s in steps:
        if s[0] == "b":
            out.append(barrier(pkg, s[1]))
        else:
            out.append(PKG[pkg]["chunk"].StreamChunk.from_pydict(
                sch, s[1], ops=s[2]))
    return out


def make_calls(pkg, calls):
    """calls: [(kind, input_idx, distinct[, delimiter])]."""
    p = PKG[pkg]
    out = []
    for c in calls:
        kw = {"distinct": c[2]}
        if len(c) > 3:
            kw["delimiter"] = c[3]
        out.append(p["ex"].AggCall(p["agg"].AggKind(c[0]), c[1], **kw))
    return out


def build(pkg, cols, msgs, calls, group=(0,), append_only=False,
          store=None, tier_cap=None, kernel_capacity=None):
    """A HashAggExecutor over a MockSource, with the aux tables of
    ``agg_aux_tables``. Returns (executor, {name: table}, store)."""
    p = PKG[pkg]
    store = store if store is not None else p["Store"]()
    sch = schema(pkg, cols)
    agg_calls = make_calls(pkg, calls)
    sschema, spk = p["ex"].agg_state_schema(sch, list(group), agg_calls)
    table = p["Table"](10, sschema, spk, store,
                       dist_key_indices=list(range(len(group))))
    dist, minput = p["ex"].agg_aux_tables(
        sch, list(group), agg_calls, append_only, store,
        lambda col: 50 + col, lambda j: 100 + j)
    kw = dict(p["kw"])
    if tier_cap is not None:
        kw["tier_cap"] = tier_cap
    if kernel_capacity is not None:
        kw["kernel_capacity"] = kernel_capacity
    ex = p["ex"].HashAggExecutor(
        p["utils"].MockSource(sch, msgs), list(group), agg_calls, table,
        append_only=append_only, minput_tables=minput,
        distinct_tables=dist, **kw)
    tables = {"value": table}
    tables.update({f"minput{j}": t for j, t in minput.items()})
    tables.update({f"distinct{c}": t for c, t in dist.items()})
    return ex, tables, store


def records(msgs):
    return [m.to_records() if hasattr(m, "to_records")
            else type(m).__name__ for m in msgs]


def table_rows(tables):
    out = {}
    for name, t in tables.items():
        out[name] = [(pk, tuple(r)) for pk, r in t.iter_rows()]
    return out


def run(pkg, cols, steps, calls, **kw):
    msgs = script(pkg, cols, steps)
    ex, tables, store = build(pkg, cols, msgs, calls, **kw)
    n = sum(1 for s in steps if s[0] == "b")
    out = asyncio.run(PKG[pkg]["utils"].collect_until_n_barriers(ex, n))
    return records(out), table_rows(tables), ex, store


def view(recs):
    """Fold emitted records into group → outputs (group = first col)."""
    v = {}
    for rs in recs:
        if not isinstance(rs, list):
            continue
        for op, row in rs:
            if op.name in ("INSERT", "UPDATE_INSERT"):
                v[row[0]] = tuple(row[1:])
            else:
                assert v.get(row[0]) == tuple(row[1:]), (row, v.get(row[0]))
                if op.name == "DELETE":
                    del v[row[0]]
    return v


def twin(cols, steps, calls, **kw):
    """Both packages on the same script: equal records and tables."""
    ref = run("ref", cols, steps, calls, **kw)
    port = run("port", cols, steps, calls, **kw)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    return port, ref


GV = [("g", "INT64"), ("v", "INT64")]


def _c(gs, vs, ops=None):
    return ("c", {"g": gs, "v": vs}, ops)


# -- retractable MIN/MAX (tests/test_hash_agg.py:207, :226, :248, :380) -------

def test_retractable_max_with_deletes_matches_reference():
    steps = [("b", 1), _c([1, 1, 1, 2], [5, 9, 7, 3]), ("b", 2),
             _c([1, 2], [9, 3], [2, 2]), ("b", 3),
             _c([1, 1], [7, 6], [2, 1]), ("b", 4)]
    (recs, rows, ex, _s), _ref = twin(
        GV, steps, [("max", 1, False), ("min", 1, False),
                    ("count", None, False)])
    assert view(recs) == {1: (6, 5, 2)}
    assert set(rows) == {"value", "minput0", "minput1"}


def _random_minmax_steps(seed=31, epochs=7, rows=40, groups=5):
    rng = np.random.default_rng(seed)
    live = []
    steps = [("b", 1)]
    for e in range(2, epochs + 1):
        gs, vs, ops = [], [], []
        for _ in range(rows):
            if live and rng.random() < 0.4:
                g, v = live.pop(int(rng.integers(0, len(live))))
                gs.append(g), vs.append(v), ops.append(2)
            else:
                g, v = int(rng.integers(0, groups)), int(rng.integers(-50, 50))
                live.append((g, v))
                gs.append(g), vs.append(v), ops.append(1)
        steps.append(_c(gs, vs, ops))
        steps.append(("b", e))
    return steps, live


def test_retractable_minmax_random_matches_reference_and_oracle():
    steps, live = _random_minmax_steps()
    (recs, _rows, _ex, _s), _ref = twin(
        GV, steps, [("max", 1, False), ("min", 1, False),
                    ("sum", 1, False)])
    want = {}
    for g, v in live:
        want.setdefault(g, []).append(v)
    assert view(recs) == {g: (max(v), min(v), sum(v))
                          for g, v in want.items()}


def test_retractable_max_recovers_from_state_like_reference():
    out = {}
    for pkg in ("ref", "port"):
        _r, _rows, _ex, store = run(
            pkg, GV, [("b", 1), _c([1, 1], [10, 20]), ("b", 2)],
            [("max", 1, False)])
        e = PKG[pkg]["epoch"].Epoch.from_physical(1).value
        store.seal_epoch(e, True)
        store.sync(e)
        out[pkg] = run(pkg, GV, [("b", 2), _c([1], [20], [2]), ("b", 3)],
                       [("max", 1, False)], store=store)[:2]
    assert out["port"] == out["ref"]
    recs = [r for m in out["port"][0] if isinstance(m, list) for r in m]
    assert [(op.name, row) for op, row in recs] == [
        ("UPDATE_DELETE", (1, 20)), ("UPDATE_INSERT", (1, 10))]


def test_retractable_max_rejected_without_minput_like_reference():
    for pkg in ("ref", "port"):
        p = PKG[pkg]
        sch = schema(pkg, GV)
        calls = make_calls(pkg, [("max", 1, False)])
        sschema, spk = p["ex"].agg_state_schema(sch, [0], calls)
        t = p["Table"](10, sschema, spk, p["Store"](), dist_key_indices=[0])
        with pytest.raises(ValueError):
            p["ex"].HashAggExecutor(p["utils"].MockSource(sch, []), [0],
                                    calls, t, **p["kw"])


def test_patch_passes_untouched_float_and_int_sums_through():
    """A retraction of a MAX beside a float SUM and an integer SUM: the
    patch rewrites only the MAX call; the sums keep K2's own (hi, lo)
    pair and limbs, bit for bit with the reference."""
    cols = [("g", "INT64"), ("v", "INT64"), ("f", "FLOAT64")]
    rng = np.random.default_rng(5)
    f = (rng.standard_normal(12) * 1e6).tolist()
    steps = [("b", 1),
             ("c", {"g": [1] * 6 + [2] * 6, "v": list(range(12)), "f": f},
              None), ("b", 2),
             ("c", {"g": [1, 2], "v": [5, 11], "f": [f[5], f[11]]},
              [2, 2]), ("b", 3)]
    (recs, rows, _ex, _s), _ref = twin(
        cols, steps, [("max", 1, False), ("sum", 2, False),
                      ("sum", 1, False)])
    assert view(recs)[1][0] == 4 and view(recs)[2][0] == 10


# -- DISTINCT (tests/test_hash_agg.py:485, :499) ---------------------------------

DISTINCT_CALLS = [("count", 1, True), ("sum", 1, True), ("count", 1, False)]


def test_distinct_count_sum_matches_reference():
    steps = [("b", 1), _c([1, 1, 1, 2], [10, 10, 20, 10]), ("b", 2),
             _c([1, 2], [10, 10]), ("b", 3)]
    (recs, rows, _ex, _s), _ref = twin(GV, steps, DISTINCT_CALLS)
    assert view(recs) == {1: (2, 30, 4), 2: (1, 10, 2)}
    assert "distinct1" in rows


def test_distinct_retraction_and_recovery_matches_reference():
    out = {}
    for pkg in ("ref", "port"):
        r1 = run(pkg, GV, [("b", 1), _c([1, 1, 1], [10, 10, 20]), ("b", 2),
                           _c([1], [10], [2]), ("b", 3)], DISTINCT_CALLS)
        store = r1[3]
        r2 = run(pkg, GV, [("b", 4), _c([1], [10], [2]), ("b", 5)],
                 DISTINCT_CALLS, store=store)
        out[pkg] = (r1[:2], r2[:2])
    assert out["port"] == out["ref"]
    assert view(out["port"][0][0]) == {1: (2, 30, 2)}
    assert view(out["port"][0][0] + out["port"][1][0]) == {1: (1, 20, 1)}


# -- approx_count_distinct (tests/test_hash_agg.py:539, :559, :614) ---------------

def test_hll_primitives_match_reference_and_stay_accurate():
    P, R = port_agg, ref_agg
    assert (P.HLL_B, P.HLL_M, P.HLL_RHO_MAX, P.HLL_ALPHA) == \
        (R.HLL_B, R.HLL_M, R.HLL_RHO_MAX, R.HLL_ALPHA)
    edge = np.asarray([0, 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    np.testing.assert_array_equal(P._clz64(edge), R._clz64(edge))
    rng = np.random.default_rng(3)
    for n, tol in ((100, 0.05), (10_000, 0.03), (200_000, 0.02)):
        v = rng.integers(-2**62, 2**62, n)
        v = np.unique(v)
        reg, rho = P.hll_lanes(v)
        rreg, rrho = R.hll_lanes(v)
        np.testing.assert_array_equal(reg, rreg)
        np.testing.assert_array_equal(rho, rrho)
        arr = np.zeros(P.HLL_M, dtype=np.uint8)
        np.maximum.at(arr, reg, rho.astype(np.uint8))
        est = int(P.hll_estimate_dense(arr)[0])
        assert est == int(R.hll_estimate_dense(arr)[0])
        assert abs(est - len(v)) / len(v) < tol, (len(v), est)


def _bid_steps(n_events, chunk, per_barrier, seed_cfg=None, start=1):
    cfg = port_nex.NexmarkConfig(event_num=n_events, max_chunk_size=chunk)
    n = n_events * 46 // 50
    b = port_nex.gen_bids(np.arange(n, dtype=np.int64), cfg)
    steps, e = [("b", start)], start + 1
    for i, lo in enumerate(range(0, n, chunk)):
        sl = slice(lo, lo + chunk)
        steps.append(("c", {"auction": b["auction"][sl].tolist(),
                            "bidder": b["bidder"][sl].tolist()}, None))
        if i % per_barrier == per_barrier - 1:
            steps.append(("b", e))
            e += 1
    steps.append(("b", e))
    return steps, b


AB = [("auction", "INT64"), ("bidder", "INT64")]


def test_approx_count_distinct_executor_and_recovery_match_reference():
    """approx_count_distinct(bidder) and count(*) per auction over bids,
    restarted halfway on the same store: the sketch table reloads and the
    estimates continue exactly as the reference's."""
    steps, b = _bid_steps(6000, 256, 4)
    half = next(i for i, s in enumerate(steps[len(steps) // 2:],
                                        len(steps) // 2) if s[0] == "b")
    calls = [("approx_count_distinct", 1, False), ("count", None, False)]
    out = {}
    for pkg in ("ref", "port"):
        r1 = run(pkg, AB, steps[:half + 1], calls, append_only=True)
        store = r1[3]
        r2 = run(pkg, AB, steps[half:], calls, append_only=True,
                 store=store)
        out[pkg] = (r1[:2], r2[:2])
    assert out["port"] == out["ref"]
    final = view(out["port"][0][0] + out["port"][1][0])
    exact = {}
    for a, bd in zip(b["auction"].tolist(), b["bidder"].tolist()):
        exact.setdefault(a, set()).add(bd)
    assert set(final) == set(exact)
    for a, (acd, cnt) in final.items():
        assert abs(acd - len(exact[a])) <= max(3, 0.7 * len(exact[a]))


def test_approx_count_distinct_rejects_retracting_upstream():
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError, match="append-only"):
            build(pkg, AB, [], [("approx_count_distinct", 1, False)],
                  append_only=False)


# -- string_agg / array_agg (tests/test_hash_agg.py:640, :678) ------------------

def test_array_agg_over_a_retracting_upstream_matches_reference():
    """count(*) per auction feeds array_agg(auction) per count: auctions
    move between count groups as their counts grow (U-/U+ pairs)."""
    out = {}
    steps, b = _bid_steps(4000, 256, 2)
    for pkg in ("ref", "port"):
        p = PKG[pkg]
        msgs = script(pkg, AB, steps)
        first, _t, store = build(pkg, AB, msgs, [("count", None, False)],
                                 append_only=True)
        calls = make_calls(pkg, [("array_agg", 0, False)])
        sch = first.schema
        sschema, spk = p["ex"].agg_state_schema(sch, [1], calls)
        table = p["Table"](20, sschema, spk, store, dist_key_indices=[0])
        dist, minput = p["ex"].agg_aux_tables(
            sch, [1], calls, False, store, lambda c: 60 + c,
            lambda j: 70 + j)
        second = p["ex"].HashAggExecutor(first, [1], calls, table,
                                         minput_tables=minput,
                                         distinct_tables=dist, **p["kw"])
        n = sum(1 for s in steps if s[0] == "b")
        got = asyncio.run(p["utils"].collect_until_n_barriers(second, n))
        out[pkg] = (records(got), table_rows({"v": table, **{
            f"m{j}": t for j, t in minput.items()}}))
    assert out["port"] == out["ref"]
    counts = {}
    for a in b["auction"].tolist():
        counts[a] = counts.get(a, 0) + 1
    want = {}
    for a, c in counts.items():
        want.setdefault(c, []).append(a)
    assert view(out["port"][0]) == {c: (tuple(sorted(v)),)
                                    for c, v in want.items()}


def test_string_agg_with_recovery_matches_reference():
    """string_agg(city, '|') per state over persons, restarted halfway."""
    cfg = port_nex.NexmarkConfig(table_type="person", event_num=8000)
    n = 8000 // 50
    ps = port_nex.gen_persons(np.arange(n, dtype=np.int64), cfg)
    cols = [("state", "VARCHAR"), ("city", "VARCHAR")]
    steps, e = [("b", 1)], 2
    for lo in range(0, n, 40):
        steps += [("c", {"state": ps["state"][lo:lo + 40].tolist(),
                         "city": ps["city"][lo:lo + 40].tolist()}, None),
                  ("b", e)]
        e += 1
    half = len(steps) // 2
    half += steps[half][0] != "b"
    calls = [("string_agg", 1, False, "|")]
    out = {}
    for pkg in ("ref", "port"):
        r1 = run(pkg, cols, steps[:half + 1], calls)
        r2 = run(pkg, cols, steps[half:], calls, store=r1[3])
        out[pkg] = (r1[:2], r2[:2])
    assert out["port"] == out["ref"]
    final = view(out["port"][0][0] + out["port"][1][0])
    want = {}
    for st, city in zip(ps["state"].tolist(), ps["city"].tolist()):
        want.setdefault(st, []).append(city)
    assert final == {st: ("|".join(sorted(v)),) for st, v in want.items()}
