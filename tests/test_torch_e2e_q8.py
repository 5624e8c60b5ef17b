"""Nexmark q8 end to end on the PyTorch port, against the JAX reference
pipeline and an oracle.

q8 (who has entered the system and created an auction in the same 10 s
window): persons ⋈ distinct (seller, window) of auctions, on id = seller
and the same window. Both packages run ``build_q8`` on the same
``NexmarkConfig`` (the reference test's, ``tests/test_e2e_q8.py``); the
port runs on the CPU (every kernel's plain version). Its MV must equal
its own oracle and the reference's MV row for row, and both join state
tables must equal the reference's.
"""

import asyncio

import numpy as np
import pytest
import torch

from risingwave_tpu.common import chunk as ref_chunk
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.models import nexmark as ref_models
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu_torch.connectors.nexmark import (
    NexmarkConfig, gen_auctions, gen_persons,
)
from risingwave_tpu_torch.models import nexmark as port_models
from risingwave_tpu_torch.models.nexmark import (
    DEFAULT_WINDOW, build_q8, drive_to_completion,
)
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream.executors import hash_join as port_hj

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


def q8_oracle(cfg, n_persons, n_auctions):
    """The reference test's oracle, on the port's generators."""
    persons = gen_persons(np.arange(n_persons, dtype=np.int64), cfg)
    auctions = gen_auctions(np.arange(n_auctions, dtype=np.int64), cfg)
    w = DEFAULT_WINDOW.usecs
    p_win = (persons["date_time"] // w) * w
    a_win = (auctions["date_time"] // w) * w
    sellers = {(int(s), int(x)) for s, x in zip(auctions["seller"], a_win)}
    return {(int(pid), str(name), int(x))
            for pid, name, x in zip(persons["id"], persons["name"], p_win)
            if (int(pid), int(x)) in sellers}


def _cfg(n_events):
    return dict(event_num=n_events, max_chunk_size=256,
                min_event_gap_in_ns=50_000_000, active_people=40,
                hot_seller_ratio=2)


def _run(build, drive, store, config, n_events, **extra):
    cfg = config(**_cfg(n_events))
    cfg_p = config(**{**cfg.__dict__, "table_type": "person"})
    cfg_a = config(**{**cfg.__dict__, "table_type": "auction"})
    p = build(store, cfg_p, cfg_a, **extra)
    asyncio.run(drive(p, {1: n_events // 50, 2: n_events * 3 // 50},
                      max_epochs=400))
    mv = [tuple(r) for _pk, r in p.mv_table.iter_rows()]
    join = p.actor.consumer.input.input        # materialize ← project ← join
    state = [list(s.table.iter_rows()) for s in join.sides]
    return p, mv, state, join


def _compare(n_events, **extra):
    port, mv, state, join = _run(build_q8, drive_to_completion,
                                 MemoryStateStore(), NexmarkConfig,
                                 n_events, device="cpu", **extra)
    _rp, ref_mv, ref_state, ref_join = _run(
        ref_models.build_q8, ref_models.drive_to_completion, RefStore(),
        RefConfig, n_events)
    expect = q8_oracle(NexmarkConfig(**_cfg(n_events)), n_events // 50,
                       n_events * 3 // 50)
    assert len(expect) > 10
    assert set(mv) == expect and len(mv) == len(expect)
    assert mv == ref_mv
    assert state == ref_state
    assert port.readers[1].offset == n_events // 50
    assert port.readers[2].offset == n_events * 3 // 50
    return join, ref_join


def test_q8_port_matches_oracle_and_reference():
    _compare(50 * 400)


def test_q8_port_growth_and_compaction_match_reference(monkeypatch):
    """Join key tables presized at 2^10 so they grow (K1 rehash + the
    head remap), and compaction forced every barrier (q8's join sees no
    deletes, so the dead-ref ratio is set to 0): the rebuild path —
    probe_insert, link, payload scatter — runs in both packages."""
    small = lambda n, floor=0, ceil=0: 1 << 10     # noqa: E731
    monkeypatch.setattr(ref_chunk, "presize_cap", small)
    monkeypatch.setattr(port_models, "presize_cap", small)
    compactions = {"port": 0, "ref": 0}
    for key, mod in (("port", port_hj), ("ref", ref_hj)):
        monkeypatch.setattr(mod._JoinSide, "COMPACT_MIN_REFS", 64)
        monkeypatch.setattr(mod._JoinSide, "COMPACT_DEAD_RATIO", 0.0)
        orig = mod._JoinSide.compact

        def counted(self, _orig=orig, _key=key):
            compactions[_key] += 1
            return _orig(self)
        monkeypatch.setattr(mod._JoinSide, "compact", counted)
    join, ref_join = _compare(50 * 1000)
    # both packages compacted (how often depends on how many barriers
    # drive_to_completion pipelined, which is timing-dependent)
    assert compactions["port"] > 0 and compactions["ref"] > 0
    for side, ref_side in zip(join.sides, ref_join.sides):
        assert side.kernel.table.capacity == ref_side.kernel.table.capacity
    assert join.sides[0].kernel.table.capacity > 1 << 10


def _fused_run(build, drive, store, config, fusion, **extra):
    """tests/test_fusion.py:354's q8 arm: 40K events, 256-row chunks."""
    base = config(event_num=40_000, max_chunk_size=256,
                  generate_strings=False)
    cfg_p = config(**{**base.__dict__, "table_type": "person"})
    cfg_a = config(**{**base.__dict__, "table_type": "auction"})
    p = build(store, cfg_p, cfg_a, rate_limit=16, min_chunks=16,
              fusion=fusion, **extra)
    asyncio.run(drive(p, {1: 40_000 // 50, 2: 40_000 * 3 // 50},
                      in_flight=1))
    join = p.actor.consumer.input.input
    return (sorted(tuple(r) for _pk, r in p.mv_table.iter_rows()),
            [list(s.table.iter_rows()) for s in join.sides], join)


def test_q8_fused_matches_reference_and_unfused():
    """build_q8(fusion=True): both join sides absorb their projections
    (join_prelude builds their lanes) and the dedup agg its tumble
    projection (agg_prelude); MV rows and both join state tables equal
    the reference's fused run and the port's unfused run."""
    mv, state, join = _fused_run(build_q8, drive_to_completion,
                                 MemoryStateStore(), NexmarkConfig, True,
                                 device="cpu")
    assert all(s.fused_input is not None for s in join.sides)
    assert join.right_in.fused_stages is not None
    mv_off, state_off, _j = _fused_run(build_q8, drive_to_completion,
                                       MemoryStateStore(), NexmarkConfig,
                                       False, device="cpu")
    ref_mv, ref_state, _rj = _fused_run(
        ref_models.build_q8, ref_models.drive_to_completion, RefStore(),
        RefConfig, True)
    assert len(mv) > 10
    assert mv == ref_mv == mv_off
    assert state == ref_state == state_off


def test_q8_port_refuses_unported_options():
    """build_q8's argument checks and its store guard stand; q8's join
    inputs build as every join type, and with the cold tier, on one
    device and over 8 shards, except where the reference refuses:
    ``state_cap`` on a mesh, and ``state_cap`` with a semi or anti
    join."""
    from risingwave_tpu_torch.parallel import ShardMesh
    cfg = NexmarkConfig(event_num=1000)
    with pytest.raises(TypeError):          # a mesh is a ShardMesh
        build_q8(MemoryStateStore(), cfg, cfg, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        build_q8(object(), cfg, cfg, device="cpu")
    p = build_q8(MemoryStateStore(), NexmarkConfig(table_type="person"),
                 NexmarkConfig(table_type="auction"), device="cpu")
    join = p.actor.consumer.input.input
    mesh = ShardMesh(8, "cpu")

    def build(**kw):
        return port_hj.HashJoinExecutor(
            join.left_in, join.right_in, [0, 2], [0, 1],
            join.sides[0].table, join.sides[1].table, device="cpu", **kw)
    for jt in port_hj.JoinType:
        for m in (None, mesh):
            assert build(join_type=jt, mesh=m).join_type is jt
        if not jt.is_semi_or_anti:
            # both state tables' pks start with the join keys
            ex = build(join_type=jt, state_cap=1 << 10)
            assert [s.state_cap for s in ex.sides] == [1 << 10] * 2
    for kw in (dict(state_cap=1 << 10, mesh=mesh),
               dict(state_cap=1 << 10,
                    join_type=port_hj.JoinType.LEFT_SEMI)):
        with pytest.raises(ValueError):
            build(**kw)
