"""TPC-H on the PyTorch port, against the JAX reference, on the CPU.

- ``connectors/tpch.py``: every table's chunks equal the reference's bit
  for bit (values, dtypes, validity, visibility, ops; DECIMAL as scaled
  int64) at two offsets of a replayable reader;
- ``models/tpch.py`` ``build_q3`` at 120 customers / 1,200 orders (the
  reference's ``tests/test_fusion.py:336`` shape): the MV equals the
  reference's and an exact oracle (``tests/test_tpch.py:22``'s, on the
  port's generators), and every state table (the three sources' splits,
  both joins' sides, the agg, the TopN, the MV) equals the reference's.
  The epoch clock is held still in both packages, so the generated
  ``_row_id`` columns (the time part of a row id is the barrier's
  epoch) are equal too;
- q3 with ``fusion=True``: the same MV, and the rewrite report equal to
  the reference's on the same plan (the agg absorbs the revenue
  projection; the orders and lineitem sides their filters and row ids;
  the customer side's VARCHAR predicate stays interpretive);
- q3's fused agg prelude (the DECIMAL revenue, ``OP_DECMUL``) as the
  port's plain program against the reference's traced prelude, on TPC-H
  rows and on signed, wide DECIMALs.
"""

import asyncio
from collections import defaultdict

import numpy as np
import pytest
import torch

import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.connectors.tpch as r_tpch
import risingwave_tpu.frontend.opt as r_opt
import risingwave_tpu.models.nexmark as r_nexmark
import risingwave_tpu.models.tpch as r_models
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.connectors.tpch as p_tpch
import risingwave_tpu_torch.frontend.opt as p_opt
import risingwave_tpu_torch.models.nexmark as p_nexmark
import risingwave_tpu_torch.models.tpch as p_models
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store

torch.set_num_threads(2)

CUSTOMERS, ORDERS = 120, 1200
PKGS = {"ref": (r_models, r_nexmark, r_store, r_st, r_opt),
        "port": (p_models, p_nexmark, p_store, p_st, p_opt)}


@pytest.fixture(autouse=True)
def _strict_and_still_clock(monkeypatch):
    """The port's checker strict; both packages' epoch clocks held at one
    millisecond, so epochs step by their sequence and row ids agree."""
    p_opt.set_strict_checker(True)
    for mod in (r_epoch, p_epoch):
        monkeypatch.setattr(mod, "physical_now_ms", lambda: 1_000_000)
    yield
    p_opt.set_strict_checker(False)


# -- the generators -----------------------------------------------------------

@pytest.mark.parametrize("table", list(p_tpch.TABLE_SCHEMAS))
def test_tables_match_reference_bit_for_bit(table):
    kw = dict(table=table, customers=150, orders=1500, max_chunk_size=256)
    total = p_tpch.TpchConfig(**kw).total_rows
    assert total == r_tpch.TpchConfig(**kw).total_rows
    for offset in (0, max(total - 300, 1)):
        pr = p_tpch.TpchSplitReader(p_tpch.TpchConfig(**kw))
        rr = r_tpch.TpchSplitReader(r_tpch.TpchConfig(**kw), offset=offset)
        pr.seek(offset)
        assert pr.split_id == rr.split_id
        n = 0
        while True:
            pc, rc = pr.next_chunk(), rr.next_chunk()
            if rc is None:
                assert pc is None
                break
            n += 1
            assert [f.name for f in pc.schema] == \
                [f.name for f in rc.schema]
            assert [f.data_type.value for f in pc.schema] == \
                [f.data_type.value for f in rc.schema]
            np.testing.assert_array_equal(pc.visibility,
                                          np.asarray(rc.visibility))
            np.testing.assert_array_equal(pc.ops, np.asarray(rc.ops))
            for a, b in zip(pc.columns, rc.columns):
                va, vb = a.values, np.asarray(b.values)
                assert va.dtype == vb.dtype and va.shape == vb.shape
                if va.dtype == object:
                    assert va.tolist() == vb.tolist()
                else:
                    assert va.tobytes() == vb.tobytes()
                assert (a.validity is None) == (b.validity is None)
        assert pr.offset == rr.offset == total and n > 0


def test_lineitem_decimals_are_scaled_int64():
    cfg = p_tpch.TpchConfig(customers=10, orders=50)
    c = p_tpch.TpchSplitReader(cfg).next_chunk()
    price = c.columns[c.schema.index_of("l_extendedprice")]
    assert price.values.dtype == np.int64
    assert (price.values[:200] % 100 == 0).all()          # whole cents
    assert c.to_pylist()[0][1] == \
        r_tpch.TpchSplitReader(r_tpch.TpchConfig(customers=10, orders=50)) \
        .next_chunk().to_pylist()[0][1]


# -- q3 end to end ------------------------------------------------------------

def q3_oracle(top_limit=10):
    """tests/test_tpch.py:22's oracle on the port's generators: exact
    scaled revenue, (revenue DESC, orderdate, orderkey) order, top 10."""
    cfg = p_tpch.TpchConfig(customers=CUSTOMERS, orders=ORDERS)
    cust = p_tpch.gen_customer(np.arange(CUSTOMERS, dtype=np.int64), cfg)
    ordr = p_tpch.gen_orders(np.arange(ORDERS, dtype=np.int64), cfg)
    line = p_tpch.gen_lineitem(np.arange(
        ORDERS * p_tpch.LINES_PER_ORDER, dtype=np.int64), cfg)
    building = {int(k) for k, seg in zip(cust["c_custkey"],
                                         cust["c_mktsegment"])
                if seg == "BUILDING"}
    okeys = {}
    for i in range(ORDERS):
        if int(ordr["o_custkey"][i]) in building and \
                int(ordr["o_orderdate"][i]) < p_models.CUTOFF:
            okeys[int(ordr["o_orderkey"][i])] = (
                int(ordr["o_orderdate"][i]), int(ordr["o_shippriority"][i]))
    groups = defaultdict(int)
    for i in range(ORDERS * p_tpch.LINES_PER_ORDER):
        ok = int(line["l_orderkey"][i])
        if ok in okeys and int(line["l_shipdate"][i]) > p_models.CUTOFF:
            price = int(line["l_extendedprice"][i])
            disc = int(line["l_discount"][i])
            groups[(ok,) + okeys[ok]] += price * (10000 - disc) // 10000
    rows = [k + (v,) for k, v in groups.items()]
    rows.sort(key=lambda r: (-r[3], r[1], r[0], r[2]))
    return rows[:top_limit]


def _walk(ex, seen):
    """Every executor of a plan (through the reference's monitoring
    wrappers)."""
    while hasattr(ex, "inner"):
        ex = ex.inner
    if id(ex) in seen:
        return
    seen[id(ex)] = ex
    for attr in ("input", "upstream", "left_in", "right_in"):
        child = getattr(ex, attr, None)
        if child is not None and hasattr(child, "execute"):
            _walk(child, seen)


def state_tables(p, st_mod) -> dict:
    """table id → rows of every state table the plan holds."""
    seen = {}
    _walk(p.actor.consumer, seen)
    out = {}
    for ex in seen.values():
        cands = list(vars(ex).values()) + [s.table for s in
                                           getattr(ex, "sides", ())]
        for t in cands:
            if isinstance(t, st_mod.StateTable):
                out[t.table_id] = [tuple(r) for _pk, r in t.iter_rows()]
    return out


def run_q3(pkg, fusion=False, **kw):
    models, nexmark, store, st, _opt = PKGS[pkg]
    if pkg == "port":
        kw["device"] = "cpu"
    p = models.build_q3(store.MemoryStateStore(), customers=CUSTOMERS,
                        orders=ORDERS, rate_limit=4, min_chunks=8,
                        fusion=fusion, **kw)
    targets = {1: CUSTOMERS, 2: ORDERS,
               3: ORDERS * p_tpch.LINES_PER_ORDER}
    asyncio.run(nexmark.drive_to_completion(p, targets, in_flight=1))
    mv = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    return p, mv, state_tables(p, st)


def test_q3_matches_reference_and_oracle():
    p, mv, tables = run_q3("port")
    _rp, ref_mv, ref_tables = run_q3("ref")
    want = q3_oracle()
    got = sorted(mv, key=lambda r: (-r[3], r[1], r[0], r[2]))
    assert got == want and len(got) == 10
    assert mv == ref_mv
    assert sorted(tables) == list(range(1, 11))
    assert tables == ref_tables
    j2 = p.actor.consumer.input.input.input.input
    assert len(tables[7]) == j2.sides[1].next_ref - len(j2.sides[1].free)
    assert all(r.offset == r.cfg.total_rows for r in p.readers.values())


def _reports(monkeypatch):
    got = []
    for mod in (r_opt, p_opt):
        orig = mod.rewrite_stream_plan

        def rec(*a, _orig=orig, **k):
            root, report = _orig(*a, **k)
            got.append(report)
            return root, report
        monkeypatch.setattr(mod, "rewrite_stream_plan", rec)
    return got


def test_q3_fused_equals_unfused_and_rewrite_report(monkeypatch):
    reports = _reports(monkeypatch)
    p, mv_on, _t = run_q3("port", fusion=True)
    _rp, ref_on, _rt = run_q3("ref", fusion=True)
    mv_off = run_q3("port")[1]
    assert mv_on == mv_off == ref_on and mv_on
    port_rep, ref_rep = reports[0], reports[1]
    assert port_rep.fired == ref_rep.fired == {"fusion_grouping": 3}
    assert port_rep.details == ref_rep.details
    assert port_rep.fallbacks == ref_rep.fallbacks == []
    detail = port_rep.details[0][1]
    assert "agg absorbed ProjectExecutor" in detail
    assert "join side 0 run NOT fused (operator '=' over host type " \
        "varchar)" in detail
    agg = p.actor.consumer.input.input
    assert agg.fused_stages is not None
    j2 = agg.input
    assert [s.fused_input is not None for s in j2.sides] == [False, True]
    j1 = j2.left_in
    assert [s.fused_input is not None for s in j1.sides] == [False, True]


# -- q3's revenue prelude (OP_DECMUL) against the reference's -----------------

def fused_ref_agg(p):
    """The fused HashAggExecutor of a reference pipeline."""
    seen = {}
    _walk(p.actor.consumer, seen)
    aggs = [ex for ex in seen.values()
            if getattr(ex, "fused_stages", None) is not None
            and hasattr(ex, "agg_calls")]
    assert len(aggs) == 1
    return aggs[0]


def ref_prelude_packed(agg, raw):
    """The reference's traced agg prelude over `raw`, packed as the port's
    kernel input (``pack_chunk``)."""
    import jax

    from risingwave_tpu.ops import fused as RF
    from risingwave_tpu_torch.ops import hash_agg as H
    pre = RF.build_agg_prelude(agg.fused_stages, agg.group_indices,
                               agg.agg_calls, agg.specs)
    key_lanes, signs, vis, call_inputs, stage_rows = jax.jit(pre)(raw)
    inputs = [(tuple(np.asarray(x) for x in lanes_),
               None if ok is None else np.asarray(ok))
              for lanes_, ok in call_inputs]
    specs = [H.AggSpec(H.AggKind(s.kind.value), s.in_dtype)
             for s in agg.specs]
    return H.pack_chunk(3 * len(agg.group_indices), specs,
                        np.asarray(key_lanes), np.asarray(signs),
                        np.asarray(vis), inputs), np.asarray(stage_rows)


@pytest.mark.parametrize("data", ["tpch", "signed"])
def test_q3_revenue_prelude_plain_matches_reference(data):
    """q3's fused agg prelude (the DECIMAL revenue through OP_DECMUL, the
    three group keys) as the port's plain program against the
    reference's traced prelude: on q3's own second-join rows (SF0.001's
    lineitems with their orders' dates) and on signed, wide DECIMALs
    (the product truncates toward zero)."""
    import torch

    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.models import prelude_cases as PC
    if data == "signed":
        cols = PC.signed_revenue_cols(1500, seed=3)
    else:
        cfg = p_tpch.TpchConfig(customers=150, orders=1500)
        li = p_tpch.gen_lineitem(np.arange(1500, dtype=np.int64), cfg)
        od = p_tpch.gen_orders(li["l_orderkey"] - 1, cfg)
        cols = {k: li[k] for k in ("l_orderkey", "l_extendedprice",
                                   "l_discount")}
        cols.update(o_orderdate=od["o_orderdate"],
                    o_shippriority=od["o_shippriority"])
    prog, raw, _fs = PC.q3_revenue_agg_case(cols, chunk_rows=256, rows=2048)
    assert F.OP_DECMUL in prog.opcodes()
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    got = F.run_program_plain(prog, torch.from_numpy(raw), None,
                              counts).numpy()
    rp = r_models.build_q3(r_store.MemoryStateStore(), customers=10,
                           orders=100, fusion=True)
    want, stage_rows = ref_prelude_packed(fused_ref_agg(rp), raw)
    np.testing.assert_array_equal(got, want)
    ex = p_models.build_q3(p_store.MemoryStateStore(), customers=10,
                           orders=100, fusion=True, device="cpu")
    fs = ex.actor.consumer.input.input.fused_stages
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  stage_rows)
