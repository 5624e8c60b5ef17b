"""Nexmark q5-hot on the PyTorch port, against the JAX reference, on the
CPU (every kernel's plain version).

q5-hot: bids → hop windows (slide 2 s, size 10 s) → COUNT(*) per
(window_start, auction) → per window the auction with the most bids
(ties to the smallest id) → materialize. Both packages run ``build_q5``
on the same ``NexmarkConfig``:

- at 4,000 events (``tests/test_state_tier.py:424``'s shape), with
  ``tests/test_e2e_q5.py``'s 100 ms event gap (over 50 windows), and
  with barriers of ~5 s of event time: the MV equals the oracle (``tests/test_e2e_q5.py:16``'s, on
  the port's generator) and the reference's, and every state table (the
  split, the agg, the TopN, the MV) equals the reference's;
- fused = unfused: the agg absorbs the hop and the projection
  (``agg_prelude`` in hop mode), and the rewrite report equals the
  reference's;
- capped = uncapped: ``tier_cap=8`` on both stateful stages (the agg
  then stays unfused, as in the reference: its tier touches host keys),
  with equal state tables, at the reference's shape (also equal to the
  reference's capped run, with the same eviction and reload counts) and
  at one whose barriers span ~5 s of event time, where both stages
  evict and reload.
"""

import asyncio
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

import risingwave_tpu.connectors.nexmark as r_nexmark
import risingwave_tpu.frontend.opt as r_opt
import risingwave_tpu.models.nexmark as r_models
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu.state.tier as r_tier
import risingwave_tpu.utils.memory as r_memory
import risingwave_tpu_torch.connectors.nexmark as p_nexmark
import risingwave_tpu_torch.frontend.opt as p_opt
import risingwave_tpu_torch.models.nexmark as p_models
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store
import risingwave_tpu_torch.state.tier as p_tier
import risingwave_tpu_torch.utils.memory as p_memory

from tests.test_torch_tpch import _reports, state_tables

torch.set_num_threads(2)

SLIDE, SIZE = 2_000_000, 10_000_000
UNITS = SIZE // SLIDE
PKGS = {"ref": (r_models, r_nexmark, r_store, r_st),
        "port": (p_models, p_nexmark, p_store, p_st)}
SHAPES = {
    # tests/test_state_tier.py:424
    "tier": dict(cfg=dict(event_num=4000, max_chunk_size=512),
                 in_flight=2),
    # tests/test_e2e_q5.py:31's 100 ms event gap: ~200 windows
    "gap": dict(cfg=dict(event_num=4000, max_chunk_size=256,
                         min_event_gap_in_ns=100_000_000), in_flight=2),
    # 4 chunks of 256 rows a barrier, 5 ms apart: a barrier spans ~5 s of
    # event time, so windows and (window, auction) groups evicted at one
    # checkpoint are touched again by the next barrier's bids (both
    # stages reload)
    "reload": dict(cfg=dict(event_num=3000, max_chunk_size=256,
                            min_event_gap_in_ns=5_000_000), in_flight=2,
                   rate=4),
}


@pytest.fixture(autouse=True)
def _strict_fresh_tier(monkeypatch):
    p_opt.set_strict_checker(True)
    for mod, mem in ((r_tier, r_memory), (p_tier, p_memory)):
        monkeypatch.setattr(mod, "GLOBAL", mod.StateTier())
        monkeypatch.setattr(mem.GLOBAL, "soft_limit", None)
    yield
    p_opt.set_strict_checker(False)


def q5_oracle(cfg, n_bids):
    """window_start → (auction, bids) of the top auction (ties to the
    smallest id), on the port's generator."""
    bids = p_nexmark.gen_bids(np.arange(n_bids, dtype=np.int64), cfg)
    counts = defaultdict(Counter)
    for ts, a in zip(bids["date_time"].tolist(), bids["auction"].tolist()):
        base = ts // SLIDE * SLIDE
        for i in range(UNITS):
            counts[base - i * SLIDE][a] += 1
    return {w: max(c.items(), key=lambda kv: (kv[1], -kv[0]))
            for w, c in counts.items()}


def run_q5(pkg, shape="tier", fusion=False, tier_cap=None):
    models, nexmark, store, st = PKGS[pkg]
    sh = SHAPES[shape]
    cfg = nexmark.NexmarkConfig(generate_strings=False, **sh["cfg"])
    kw = dict(device="cpu") if pkg == "port" else {}
    rate = sh.get("rate", 8)
    p = models.build_q5(store.MemoryStateStore(), cfg, rate_limit=rate,
                        min_chunks=rate, tier_cap=tier_cap, fusion=fusion,
                        **kw)
    n_bids = cfg.event_num * 46 // 50
    asyncio.run(models.drive_to_completion(p, {1: n_bids},
                                           in_flight=sh["in_flight"]))
    mv = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    return p, mv, state_tables(p, st), cfg, n_bids


@pytest.mark.parametrize("shape", list(SHAPES))
def test_q5_hot_matches_oracle_and_reference(shape):
    p, mv, tables, cfg, n_bids = run_q5("port", shape)
    _rp, ref_mv, ref_tables, _c, _n = run_q5("ref", shape)
    want = q5_oracle(cfg, n_bids)
    got = {r[0]: (r[1], r[2]) for r in mv}
    assert got == want and len(mv) == len(want)
    assert mv == ref_mv
    assert sorted(tables) == [1, 2, 3, 4]
    assert tables == ref_tables
    if shape == "gap":
        assert len(want) > 50
    assert p.reader.offset == n_bids


def test_q5_hot_fused_equals_unfused_and_rewrite_report(monkeypatch):
    reports = _reports(monkeypatch)
    p, mv_on, tables_on, _c, _n = run_q5("port", fusion=True)
    _rp, ref_on, _rt, _c, _n = run_q5("ref", fusion=True)
    _p, mv_off, tables_off, _c, _n = run_q5("port")
    assert mv_on == mv_off == ref_on and mv_on
    assert tables_on == tables_off
    port_rep, ref_rep = reports[0], reports[1]
    assert port_rep.fired == ref_rep.fired == {"fusion_grouping": 1}
    assert port_rep.details == ref_rep.details == [
        ("fusion_grouping", "agg absorbed HopWindowExecutor→ProjectExecutor")]
    agg = p.actor.consumer.input.input
    assert agg.fused_stages.hop.units == UNITS
    assert agg.kernel._prelude.units == UNITS
    assert type(agg.input).__name__ == "SourceExecutor"


@pytest.mark.parametrize("shape", ["tier", "reload"])
def test_q5_hot_capped_equals_uncapped(shape):
    """Capped = uncapped; at the reference's shape also = the reference's
    capped run, with its eviction and reload counts (the reference's
    capped run at the reload shape takes ~17 s, so there the port is held
    to its own uncapped run only)."""
    p, mv_cap, tables_cap, _c, _n = run_q5("port", shape, tier_cap=8)
    _p, mv_unc, tables_unc, _c, _n = run_q5("port", shape)
    assert mv_cap == mv_unc and mv_cap
    assert tables_cap == tables_unc
    topn = p.actor.consumer.input
    agg = topn.input
    assert agg.fused_stages is None
    assert agg._tier_part.evicted_total > 0
    if shape == "reload":
        for ex in (agg, topn):
            assert ex._tier_part.evicted_total > 0
            assert ex._tier_part.reload_total > 0
        return
    rp, ref_cap, ref_tables, _c, _n = run_q5("ref", shape, tier_cap=8)
    assert mv_cap == ref_cap and tables_cap == ref_tables
    ref_topn = rp.actor.consumer.input
    for ex, ref_ex in ((agg, ref_topn.input), (topn, ref_topn)):
        part, ref_part = ex._tier_part, ref_ex._tier_part
        assert (part.evicted_total, part.reload_total) == \
            (ref_part.evicted_total, ref_part.reload_total)


def test_q5_hot_hop_prelude_plain_matches_reference():
    """q5-hot's fused agg prelude (5 hop copies of each raw row, then the
    (window_start, auction) projection and key lanes) as the port's plain
    program against the reference's traced prelude, on Nexmark bid chunks
    with separator rows, from the stream's start and from its middle."""
    from risingwave_tpu_torch.ops import fused as F
    from risingwave_tpu_torch.models import prelude_cases as PC
    from tests.test_torch_tpch import fused_ref_agg, ref_prelude_packed
    rp = r_models.build_q5(r_store.MemoryStateStore(),
                           r_nexmark.NexmarkConfig(event_num=4000),
                           fusion=True)
    for first in (0, 1 << 20):
        prog, raw, fs = PC.q5_hot_agg_case(n_chunks=3, chunk_rows=200,
                                           rows=1024, first=first)
        assert prog.units == UNITS
        counts = torch.zeros(prog.n_counts, dtype=torch.int64)
        got = F.run_program_plain(prog, torch.from_numpy(raw), None,
                                  counts).numpy()
        assert got.shape[0] == UNITS * 1024
        want, stage_rows = ref_prelude_packed(fused_ref_agg(rp), raw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                      stage_rows)
