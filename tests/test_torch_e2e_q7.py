"""Nexmark q7-core end to end on the PyTorch port, against the JAX
reference pipeline and an oracle.

Both ``tests/test_e2e_q7.py`` scenarios at their sizes: the plain
pipeline, and the watermark variant that retires closed windows on the
device. The port runs on the CPU (every kernel's plain version); its MV
must equal its own copy of ``q7_oracle`` and the reference pipeline's MV
row for row, and the agg value-state rows must be equal too.
"""

import asyncio
from collections import defaultdict

import numpy as np
import pytest
import torch

from risingwave_tpu.common.types import Interval as RefInterval
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.models import nexmark as ref_models
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu_torch.common.types import Interval
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig, gen_bids
from risingwave_tpu_torch.models.nexmark import (
    DEFAULT_WINDOW, build_q7, drive_to_completion,
)
from risingwave_tpu_torch.state.store import MemoryStateStore

# Under pytest-xdist these tests share the host's cores with timing-bound
# tests on other workers (tests/test_chaos.py's 8 s barrier timeouts), so
# torch's intra-op pool stays small.
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _strict_port_checker():
    """The port's plan checker in assert-don't-fallback mode: a fused
    path that breaks a plan invariant fails instead of falling back to
    the unfused plan."""
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    set_strict_checker(True)
    yield
    set_strict_checker(False)


def q7_oracle(cfg, n_bids):
    """The reference test's oracle, on the port's generator."""
    bids = gen_bids(np.arange(n_bids, dtype=np.int64), cfg)
    w = (bids["date_time"] // DEFAULT_WINDOW.usecs) * DEFAULT_WINDOW.usecs
    out = defaultdict(lambda: (0, 0))
    for wi, p in zip(w.tolist(), bids["price"].tolist()):
        mx, c = out[wi]
        out[wi] = (max(mx, p), c + 1)
    return dict(out)


SCENARIOS = {
    # tests/test_e2e_q7.py::test_q7_end_to_end
    "plain": dict(cfg=dict(event_num=50 * 50 * 40, max_chunk_size=1024,
                           min_event_gap_in_ns=100_000_000),
                  n_bids=46 * 50 * 40, kw={}),
    # tests/test_e2e_q7.py::test_q7_watermark_cleaning_bounded_state
    "watermark": dict(cfg=dict(event_num=50 * 30 * 60, max_chunk_size=512,
                               min_event_gap_in_ns=200_000_000),
                      n_bids=46 * 30 * 60,
                      kw=dict(rate_limit=2, watermark_delay=0)),
}


def _run(build, drive, store, cfg, n_bids, kw, interval, **extra):
    kw = dict(kw)
    if "watermark_delay" in kw:
        kw["watermark_delay"] = interval(usecs=kw["watermark_delay"])
    p = build(store, cfg, **kw, **extra)
    asyncio.run(drive(p, {1: n_bids}))
    mv = {row[0]: (row[1], row[2]) for _pk, row in p.mv_table.iter_rows()}
    agg = p.actor.consumer.input          # materialize ← agg
    return p, mv, list(agg.table.iter_rows()), agg


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_q7_port_matches_oracle_and_reference(scenario):
    sc = SCENARIOS[scenario]
    port, mv, state_rows, agg = _run(
        build_q7, drive_to_completion, MemoryStateStore(),
        NexmarkConfig(**sc["cfg"]), sc["n_bids"], sc["kw"], Interval,
        device="cpu")
    _rp, ref_mv, ref_state_rows, _ra = _run(
        ref_models.build_q7, ref_models.drive_to_completion, RefStore(),
        RefConfig(**sc["cfg"]), sc["n_bids"], sc["kw"], RefInterval)
    expect = q7_oracle(NexmarkConfig(**sc["cfg"]), sc["n_bids"])
    assert len(expect) > 10
    assert mv == expect
    assert mv == ref_mv
    assert state_rows == ref_state_rows
    assert port.reader.offset == sc["n_bids"]
    if scenario == "watermark":
        # bounded state: only windows at/after the final watermark stay,
        # in the value-state table and on the device
        assert len(state_rows) < len(expect) / 2
        assert agg._cleaned_wm is not None
        assert all(row[0] >= agg._cleaned_wm for _pk, row in state_rows)
        occ = int((agg.kernel.state.table.occ != 0).sum())
        assert occ <= len(state_rows) + 1


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_q7_fused_matches_reference_and_unfused(scenario):
    """build_q7(fusion=True): the agg absorbs the tumble projection (its
    prelude is agg_prelude), and the MV and value-state rows equal the
    reference's fused run, the port's unfused run and the oracle."""
    sc = SCENARIOS[scenario]
    cfg = NexmarkConfig(**sc["cfg"])
    _p, mv, state_rows, agg = _run(
        build_q7, drive_to_completion, MemoryStateStore(), cfg,
        sc["n_bids"], sc["kw"], Interval, device="cpu", fusion=True)
    assert agg.fused_stages is not None
    assert agg.fused_stages.describe() == "ProjectExecutor"
    _u, mv_off, state_off, _a = _run(
        build_q7, drive_to_completion, MemoryStateStore(), cfg,
        sc["n_bids"], sc["kw"], Interval, device="cpu")
    _rp, ref_mv, ref_state_rows, _ra = _run(
        ref_models.build_q7, ref_models.drive_to_completion, RefStore(),
        RefConfig(**sc["cfg"]), sc["n_bids"], sc["kw"], RefInterval,
        fusion=True)
    assert mv == q7_oracle(cfg, sc["n_bids"])
    assert mv == ref_mv == mv_off
    assert state_rows == ref_state_rows == state_off
    rows = dict((name, n) for name, n, _c in
                agg.fused_stages.drain_stage_metrics())
    assert rows["ProjectExecutor"] == sc["n_bids"]
    if scenario == "watermark":
        # window watermarks still derive through the absorbed project
        assert agg._cleaned_wm is not None


def test_q7_port_refuses_unported_options():
    from risingwave_tpu_torch.parallel import ShardMesh
    cfg = NexmarkConfig(event_num=1000)
    # tier_cap is ported on one device; sharded eviction stays refused
    for kw in (dict(coalesce_rows=64),
               dict(tier_cap=8, mesh=ShardMesh(8, "cpu"))):
        with pytest.raises(NotImplementedError):
            build_q7(MemoryStateStore(), cfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        build_q7(object(), cfg, device="cpu")
    # the mesh is ported: it must be the port's own ShardMesh
    with pytest.raises(TypeError):
        build_q7(MemoryStateStore(), cfg, device="cpu", mesh=object())
