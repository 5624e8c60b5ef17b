"""Nexmark q7-core over 8 logical shards on the PyTorch port, against the
JAX reference's mesh pipeline and an oracle.

``build_q7(mesh=ShardMesh(8, "cpu"))`` runs the agg vnode-sharded
(``parallel/agg.ShardedAggKernel``, every kernel's plain version here);
the reference runs ``build_q7(mesh=Mesh(eight_devices))`` on the 8-device
CPU mesh that tests/conftest.py sets up. The MV and the agg's value-state
rows must equal the reference's and the oracle, with and without
watermark retirement, unfused and with ``fusion=True`` (the prelude then
sits on the injected sharded kernel), and across a kill-and-rebuild on
one store (tests/test_multichip_agg.py:74, :101). A hand-built fused
sharded agg whose group key is a raw column (so the host feeds per-row
owners to the skew-exact bucket), fed a U-/U+ pair that straddles a
shard-block boundary, leaves the reference's per-shard state
(``_build_raw_step`` runs the prelude on each shard's block alone).
"""

import asyncio

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from risingwave_tpu.common import chunk as ref_chunk
from risingwave_tpu.common import epoch as ref_epoch
from risingwave_tpu.common import types as ref_types
from risingwave_tpu.common.types import Interval as RefInterval
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.expr import expr as ref_expr
from risingwave_tpu.frontend.opt import rewrite_stream_plan as ref_rewrite
from risingwave_tpu.models import nexmark as ref_models
from risingwave_tpu.parallel.agg import ShardedAggKernel as RefKernel
from risingwave_tpu.state.state_table import StateTable as RefStateTable
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream import message as ref_msg
from risingwave_tpu.stream.executors import hash_agg as ref_exec
from risingwave_tpu.stream.executors import simple as ref_simple
from risingwave_tpu.stream.executors import test_utils as ref_utils
from risingwave_tpu_torch.common import chunk as port_chunk
from risingwave_tpu_torch.common import epoch as port_epoch
from risingwave_tpu_torch.common import types as port_types
from risingwave_tpu_torch.common.types import Interval
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
from risingwave_tpu_torch.expr import expr as port_expr
from risingwave_tpu_torch.frontend.opt import (
    rewrite_stream_plan, set_strict_checker,
)
from risingwave_tpu_torch.models.nexmark import build_q7, drive_to_completion
from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.parallel import ShardedAggKernel, ShardMesh
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream import message as port_msg
from risingwave_tpu_torch.stream.executors import hash_agg as port_exec
from risingwave_tpu_torch.stream.executors import simple as port_simple
from risingwave_tpu_torch.stream.executors import test_utils as port_utils
from tests.test_torch_e2e_q7 import q7_oracle

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _strict_port_checker():
    set_strict_checker(True)
    yield
    set_strict_checker(False)


SCENARIOS = {
    # tests/test_multichip_agg.py::test_q7_pipeline_with_sharded_agg_...
    "watermark": dict(cfg=dict(event_num=50 * 30 * 20, max_chunk_size=512,
                               min_event_gap_in_ns=200_000_000),
                      n_bids=46 * 30 * 20,
                      kw=dict(rate_limit=2, watermark_delay=0)),
    "plain": dict(cfg=dict(event_num=50 * 20 * 20, max_chunk_size=512,
                           min_event_gap_in_ns=200_000_000),
                  n_bids=46 * 20 * 20, kw=dict(rate_limit=2)),
}


def _run(build, store, cfg, n_bids, kw, interval, mesh, drive_to=None,
         **extra):
    kw = dict(kw)
    if "watermark_delay" in kw:
        kw["watermark_delay"] = interval(usecs=kw["watermark_delay"])
    drive = drive_to_completion if build is build_q7 \
        else ref_models.drive_to_completion
    p = build(store, cfg, mesh=mesh, **kw, **extra)
    asyncio.run(drive(p, {1: drive_to or n_bids}))
    mv = {row[0]: (row[1], row[2]) for _pk, row in p.mv_table.iter_rows()}
    agg = p.actor.consumer.input          # materialize ← agg
    while not hasattr(agg, "agg_calls"):  # the reference's monitor wrap
        agg = getattr(agg, "inner", None) or agg.input
    return mv, list(agg.table.iter_rows()), agg


@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_q7_mesh_matches_reference_and_oracle(eight_devices, scenario,
                                              fusion):
    sc = SCENARIOS[scenario]
    cfg = NexmarkConfig(**sc["cfg"])
    mv, rows, agg = _run(build_q7, MemoryStateStore(), cfg, sc["n_bids"],
                         sc["kw"], Interval, ShardMesh(8, "cpu"),
                         device="cpu", fusion=fusion)
    ref_mv, ref_rows, ref_agg = _run(
        ref_models.build_q7, RefStore(), RefConfig(**sc["cfg"]),
        sc["n_bids"], sc["kw"], RefInterval,
        Mesh(np.asarray(eight_devices), ("d",)), fusion=fusion)
    expect = q7_oracle(cfg, sc["n_bids"])
    assert len(expect) > 10
    assert mv == expect == ref_mv
    assert rows == ref_rows
    assert isinstance(agg.kernel, ShardedAggKernel)
    assert agg.kernel.n_dev == 8
    # the prelude sits on the injected sharded kernel
    # (tests/test_sharded_epoch.py:370's check)
    assert (agg.fused_stages is not None) == fusion
    assert (agg.kernel._prelude is not None) == fusion
    assert (ref_agg.kernel._prelude is not None) == fusion
    if fusion:
        counts = dict((n, r) for n, r, _c in
                      agg.fused_stages.drain_stage_metrics())
        assert counts["ProjectExecutor"] == sc["n_bids"]
    if scenario == "watermark":
        assert agg._cleaned_wm is not None
        assert len(rows) < len(expect) / 2
        occ = int((agg.kernel.state.table.occ != 0).sum())
        assert occ <= len(rows) + 8


@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
def test_q7_mesh_recovery(eight_devices, fusion):
    """Kill halfway, rebuild a fresh pipeline and sharded kernel on the
    same store, run to the end: the oracle's MV, and the reference's
    state rows (tests/test_multichip_agg.py:101)."""
    raw = dict(event_num=50 * 40, max_chunk_size=256,
               min_event_gap_in_ns=100_000_000)
    n_bids = 46 * 40
    kw = dict(rate_limit=1, min_chunks=1)
    store = MemoryStateStore()
    _run(build_q7, store, NexmarkConfig(**raw), n_bids, kw, Interval,
         ShardMesh(8, "cpu"), drive_to=n_bids // 2, device="cpu",
         fusion=fusion)
    mv, rows, agg = _run(build_q7, store, NexmarkConfig(**raw), n_bids, kw,
                         Interval, ShardMesh(8, "cpu"), device="cpu",
                         fusion=fusion)
    mesh = Mesh(np.asarray(eight_devices), ("d",))
    ref_store = RefStore()
    _run(ref_models.build_q7, ref_store, RefConfig(**raw), n_bids, kw,
         RefInterval, mesh, drive_to=n_bids // 2, fusion=fusion)
    ref_mv, ref_rows, _a = _run(ref_models.build_q7, ref_store,
                                RefConfig(**raw), n_bids, kw, RefInterval,
                                mesh, fusion=fusion)
    assert mv == q7_oracle(NexmarkConfig(**raw), n_bids) == ref_mv
    assert rows == ref_rows
    assert agg.kernel.dispatches > 0


# -- a fused sharded agg keyed on a raw column ---------------------------------

N_SHARDS = 4
ROWS = 31          # + the separator row: a 32-row step of 4 blocks of 8
UD, UI = 7, 8      # a U-/U+ pair across the block edge 7 | 8


def _steps():
    """Chunks of (auction, price) rows with U-/U+ pairs whose outputs are
    equal (a no-op pair the prelude drops when both rows sit in one
    block), one across a block edge."""
    rng = np.random.default_rng(5)
    steps = [("b", 1)]
    for b in range(2, 5):
        auction = rng.integers(0, 12, ROWS).tolist()
        price = rng.integers(1, 1000, ROWS).tolist()
        ops = [1] * ROWS
        for a, u in ((UD, UI), (2, 3), (20, 21)):
            auction[u], price[u] = auction[a], price[a]
            ops[a], ops[u] = 3, 4
        steps.append(("c", auction, price, ops))
        steps.append(("b", b))
    return steps


def _fused_agg(pkg, eight_devices):
    if pkg == "port":
        types, epoch, msg, chunk, expr, simple, ex_mod, utils, Table, \
            Store = (port_types, port_epoch, port_msg, port_chunk,
                     port_expr, port_simple, port_exec, port_utils,
                     StateTable, MemoryStateStore)
    else:
        types, epoch, msg, chunk, expr, simple, ex_mod, utils, Table, \
            Store = (ref_types, ref_epoch, ref_msg, ref_chunk, ref_expr,
                     ref_simple, ref_exec, ref_utils, RefStateTable,
                     RefStore)
    dt = types.DataType
    schema = types.Schema.of(auction=dt.INT64, price=dt.INT64)
    script = []
    for s in _steps():
        if s[0] == "b":
            curr = epoch.Epoch.from_physical(s[1])
            prev = epoch.Epoch.from_physical(s[1] - 1) if s[1] > 1 \
                else epoch.Epoch.INVALID
            script.append(msg.Barrier(epoch.EpochPair(curr, prev),
                                      msg.BarrierKind.CHECKPOINT))
        else:
            script.append(chunk.StreamChunk.from_pydict(
                schema, {"auction": s[1], "price": s[2]}, ops=s[3],
                capacity=ROWS))
    src = utils.MockSource(schema, script)
    proj = simple.ProjectExecutor(
        src, [expr.InputRef(0, dt.INT64), expr.InputRef(1, dt.INT64)],
        ["auction", "price"])
    calls = [ex_mod.AggCall(ex_mod.AggKind.COUNT),
             ex_mod.AggCall(ex_mod.AggKind.SUM, 1)]
    sch, pk = ex_mod.agg_state_schema(proj.schema, [0], calls)
    table = Table(7, sch, pk, Store(), dist_key_indices=[0])
    specs = [c.spec(proj.schema) for c in calls]
    if pkg == "port":
        kernel = ShardedAggKernel(ShardMesh(N_SHARDS, "cpu"), 3, specs,
                                  capacity=256)
        agg = ex_mod.HashAggExecutor(proj, [0], calls, table, kernel=kernel,
                                     device="cpu")
        root, _r = rewrite_stream_plan(agg, "none", fusion=True,
                                       device="cpu")
    else:
        kernel = RefKernel(Mesh(np.asarray(eight_devices[:N_SHARDS]),
                                ("d",)), 3, specs, capacity=256)
        agg = ex_mod.HashAggExecutor(proj, [0], calls, table, kernel=kernel)
        root, _r = ref_rewrite(agg, "none", record=False, fusion=True)
    msgs = asyncio.run(utils.collect_until_n_barriers(root, 4))
    records = [m.to_records() for m in msgs if hasattr(m, "to_records")]
    return root, records, list(table.iter_rows())


def test_fused_mesh_agg_on_a_raw_key_matches_reference(eight_devices):
    port, records, rows = _fused_agg("port", eight_devices)
    ref, ref_records, ref_rows = _fused_agg("ref", eight_devices)
    assert port.fused_stages is not None and ref.fused_stages is not None
    assert port.fused_stages.input_positions([0]) == [0]
    assert records == ref_records and rows == ref_rows
    got = H.to_numpy_sharded_state(port.kernel.state, port.kernel.specs)
    want = jax.device_get(ref.kernel.state)
    assert np.array_equal(got.table.keys, np.asarray(want.table.keys))
    for name in ("group_rows", "dirty", "emitted_valid", "emitted_rows"):
        assert np.array_equal(getattr(got, name),
                              np.asarray(getattr(want, name))), name
    for a, b in zip(got.accs + got.emitted_accs,
                    tuple(want.accs) + tuple(want.emitted_accs)):
        assert np.array_equal(a, np.asarray(b))
    # the straddling pair is what tells per-block rolls from whole-step
    # ones: the prelude over one ring drops it, over the blocks it stays
    ch = [m for m in _steps() if m[0] == "c"][0]
    schema = port_types.Schema.of(auction=port_types.DataType.INT64,
                                  price=port_types.DataType.INT64)
    c = port_chunk.StreamChunk.from_pydict(
        schema, {"auction": ch[1], "price": ch[2]}, ops=ch[3],
        capacity=ROWS)
    raw = F.encode_raw_chunk(c, port.fused_stages.ref_cols)
    raw = torch.from_numpy(np.concatenate([raw, np.zeros((1, raw.shape[1]),
                                                         np.int64)]))
    prog = port.kernel._prelude
    vis_col = 3 + 1
    blocks = F.agg_prelude(prog, raw, seg=(ROWS + 1) // N_SHARDS)[:, vis_col]
    ring = F.agg_prelude(prog, raw)[:, vis_col]
    assert (int(blocks[UD]), int(blocks[UI])) == (1, 1)
    assert (int(ring[UD]), int(ring[UI])) == (0, 0)
    assert torch.equal(blocks[:UD], ring[:UD])
