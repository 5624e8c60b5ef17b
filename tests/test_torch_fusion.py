"""Fragment fusion on the PyTorch port, against the JAX reference.

Mirrors ``tests/test_fusion.py``: the eligibility walker, the rule's
decisions on hand-built chains, the checker's fallback on a broken fused
block, the hop expansion and the absorbed watermark filter. The three
entry points' plain versions (the compiled expression program run as
torch ops on the CPU) are held bit for bit to the reference's traced
functions — ``build_chain_step``, ``build_agg_prelude(...)(raw)`` and
``build_join_prelude(...)(raw)`` under jit — on random expression trees
over every device type and U-/U+ pair chunks with separator rows, and to
the port's numpy ``chain_body``, which evaluates the expression objects
directly. The trees avoid the shapes ROADMAP.md queue C declares
(``fused_cases`` ``xla_safe``); tests/test_torch_expr.py covers those.
"""

import asyncio

import numpy as np
import pytest
import torch

import risingwave_tpu.expr.expr as RE
import risingwave_tpu.ops.fused as RF
from risingwave_tpu.common.chunk import Column as RColumn
from risingwave_tpu.common.chunk import StreamChunk as RChunk
from risingwave_tpu.common.types import DataType as RD
from risingwave_tpu.common.types import Field as RField
from risingwave_tpu.common.types import Interval as RInterval
from risingwave_tpu.common.types import Schema as RSchema
from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
from risingwave_tpu_torch.common.types import (
    DataType, Field, Interval, Schema,
)
from risingwave_tpu_torch.expr import expr as E
from risingwave_tpu_torch.expr.expr import BinaryOp, Cast, InputRef, lit
from risingwave_tpu_torch.frontend.opt import (
    rewrite_stream_plan, set_strict_checker,
)
from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.ops import fused_cases as FC
from risingwave_tpu_torch.ops import hash_agg as H

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _strict_port_checker():
    """The port's checker in assert-don't-fallback mode, as the
    reference's tier-1 conftest arms its own."""
    set_strict_checker(True)
    yield
    set_strict_checker(False)


SCHEMA = Schema([Field("k", DataType.INT64), Field("v", DataType.INT64),
                 Field("f", DataType.FLOAT64), Field("s", DataType.VARCHAR)])
RSCHEMA = RSchema([RField("k", RD.INT64), RField("v", RD.INT64),
                   RField("f", RD.FLOAT64), RField("s", RD.VARCHAR)])


# -- eligibility walker ----------------------------------------------------


def test_traceable_reason_matches_reference():
    """Mirror of test_fusion.py:45, held reason for reason."""
    cases = [
        ("bin", "+", ("ref", 0, "INT64"), ("ref", 1, "INT64")),
        ("ref", 3, "VARCHAR"),
        ("bin", "=", ("ref", 3, "VARCHAR"), ("lit", "x", "VARCHAR")),
        ("cast", ("ref", 2, "FLOAT64"), "DECIMAL"),
        ("func", "tumble_start", [("ref", 0, "INT64"), ("interval", 10)],
         "INT64"),
        ("bin", "*", ("ref", 2, "FLOAT64"), ("lit", "1.5", "DECIMAL")),
        ("cast", ("ref", 3, "VARCHAR"), "INT64"),
        ("case", [(("ref", 0, "INT64"), ("ref", 1, "INT64"))],
         ("ref", 1, "INT64")),
    ]
    for desc in cases[:7]:
        pe = FC.build(desc, E, DataType, Interval)
        re_ = FC.build(desc, RE, RD, RInterval)
        assert F.traceable_reason(pe, SCHEMA) == \
            RF.traceable_reason(re_, RSCHEMA), desc
    assert F.traceable_reason(
        InputRef(0, DataType.INT64) + lit(1), SCHEMA) is None


# -- rule decisions on hand-built chains -----------------------------------


def _mini_agg_chain(group_type=DataType.INT64, distinct=False):
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.hash_agg import (
        AggCall, HashAggExecutor, agg_aux_tables, agg_state_schema,
    )
    from risingwave_tpu_torch.stream.executors.materialize import (
        MaterializeExecutor,
    )
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    store = MemoryStateStore()
    src = MockSource(Schema.of(k=group_type, v=DataType.INT64), [])
    filt = FilterExecutor(src, InputRef(1, DataType.INT64) > lit(0))
    proj = ProjectExecutor(
        filt, [InputRef(0, group_type),
               BinaryOp("*", InputRef(1, DataType.INT64), lit(2))],
        ["k", "v2"])
    calls = [AggCall(H.AggKind.SUM, 1, distinct=distinct)]
    sch, pk = agg_state_schema(proj.schema, [0], calls)
    distinct_tables, minput = agg_aux_tables(
        proj.schema, [0], calls, False, store,
        dedup_table_id=lambda c: 90 + c, minput_table_id=lambda j: 95 + j)
    agg = HashAggExecutor(proj, [0], calls, StateTable(2, sch, pk, store),
                          distinct_tables=distinct_tables,
                          minput_tables=minput, device="cpu")
    mv = StateTable(3, agg.schema, [0], store)
    return MaterializeExecutor(agg, mv)


def test_rule_absorbs_run_into_agg():
    """Mirror of test_fusion.py:420."""
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    new_root, report = rewrite_stream_plan(_mini_agg_chain(), "none",
                                           fusion=True, device="cpu")
    assert report.fired.get("fusion_grouping") == 1
    agg = new_root.input
    assert agg.fused_stages is not None
    assert agg.fused_stages.describe() == "FilterExecutor→ProjectExecutor"
    assert isinstance(agg.input, MockSource)
    _r2, report2 = rewrite_stream_plan(_mini_agg_chain(), "none")
    assert "fusion_grouping" not in report2.fired


def test_rule_refuses_an_ineligible_agg():
    """Mirror of test_fusion.py:438: a DISTINCT agg cannot absorb the run
    (its dedup multisets read the post-stage chunks), and neither can an
    agg with a host-typed (interned) group key; each keeps its input, and
    the run fuses as a standalone block feeding it."""
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )
    for chain in (_mini_agg_chain(distinct=True),
                  _mini_agg_chain(DataType.VARCHAR)):
        new, report = rewrite_stream_plan(chain, "none", fusion=True,
                                          device="cpu")
        agg = new.input
        assert agg.fused_stages is None
        assert isinstance(agg.input, FusedFragmentExecutor)
        assert report.fired.get("fusion_grouping") == 1


def test_rule_absorbs_join_sides_and_q1_block():
    """Both q8 join sides absorb their projections (the left one carries
    a varchar passthrough around the device pass), the dedup agg absorbs
    its tumble projection, and q1 becomes one fused block."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
    from risingwave_tpu_torch.models.nexmark import build_q1, build_q8
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )
    base = NexmarkConfig(event_num=1000, generate_strings=False)
    p = build_q8(MemoryStateStore(),
                 NexmarkConfig(**{**base.__dict__, "table_type": "person"}),
                 NexmarkConfig(**{**base.__dict__,
                                  "table_type": "auction"}),
                 fusion=True, device="cpu")
    join = p.actor.consumer.input.input
    left, right = join.sides
    assert left.fused_input is not None and right.fused_input is not None
    assert left.fused_input.host_out == {1: 1}
    assert join.right_in.fused_stages.describe() == "ProjectExecutor"
    q1 = build_q1(MemoryStateStore(), NexmarkConfig(event_num=100),
                  fusion=True, device="cpu")
    block = q1.actor.consumer.input
    assert isinstance(block, FusedFragmentExecutor)
    assert [s.kind for s in block.fused_stages.stages] == \
        ["row_id_gen", "project"]


def test_checker_catches_broken_fused_block():
    """Mirror of test_fusion.py:456: a fused run planned against the
    wrong input schema trips the checker (fallback off-strict, raise in
    strict)."""
    import copy

    from risingwave_tpu_torch.stream.executor import ExecutorInfo
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )

    def broken_rule(root):
        agg = root.input
        wrong = Schema.of(a=DataType.INT64)
        fs = F.FusedStages(wrong, [F.FusedStage(
            "filter", "FilterExecutor",
            exprs=(InputRef(0, DataType.INT64) > lit(0),))])
        bad = FusedFragmentExecutor.__new__(FusedFragmentExecutor)
        bad.input = agg.input.input
        bad.fused_stages = fs
        bad._info = ExecutorInfo(fs.out_schema, [], "FusedFragment")
        new_agg = copy.copy(agg)
        new_agg.input = bad
        new_root = copy.copy(root)
        new_root.input = new_agg
        return new_root, 1, "broken"

    root = _mini_agg_chain()
    set_strict_checker(False)
    try:
        _new, report = rewrite_stream_plan(
            root, "none", extra_rules={"broken_fusion": broken_rule})
        assert any(r == "broken_fusion" for r, _ in report.fallbacks)
    finally:
        set_strict_checker(True)
    with pytest.raises(AssertionError):
        rewrite_stream_plan(root, "none",
                            extra_rules={"broken_fusion": broken_rule})


# -- plain versions against the reference's traced functions ----------------


def _ref_stages(fs_port, seed, n_pred=2):
    """The reference's FusedStages of the same random case."""
    preds, outs = FC.random_exprs(seed, n_pred=n_pred, xla_safe=True)
    rs = RSchema([RField(nm, RD[t]) for nm, t in FC.COLS])
    stages = [RF.FusedStage("filter", "FilterExecutor",
                            exprs=(FC.build(p, RE, RD, RInterval),))
              for p in preds]
    stages.append(RF.FusedStage(
        "project", "ProjectExecutor",
        exprs=tuple(FC.build(o, RE, RD, RInterval) for o in outs),
        names=tuple(f"o{j}" for j in range(len(outs)))))
    return RF.FusedStages(rs, stages)


def _ref_chunk(chunk):
    rs = RSchema([RField(nm, RD[t]) for nm, t in FC.COLS])
    return RChunk(rs, [RColumn(RD[t], c.values, c.validity)
                       for (_n, t), c in zip(FC.COLS, chunk.columns)],
                  chunk.visibility, chunk.ops)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        same = (a.view(np.int64 if a.itemsize == 8 else np.int32)
                == b.view(np.int64 if b.itemsize == 8 else np.int32))
        return same | (np.isnan(a) & np.isnan(b))
    return a == b


SEEDS = list(range(10))


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_chain_plain_matches_chain_step(seed):
    fs, chunk = FC.port_case(seed, 128, False, separators=3,
                             xla_safe=True)
    rfs = _ref_stages(fs, seed)
    assert fs.ref_cols == rfs.ref_cols and fs.host_out == rfs.host_out
    prog = F.compile_program(fs, F.MODE_CHAIN)
    hs = fs.host_noop_eq(chunk)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    mat = F.fused_chain(prog,
                        torch.from_numpy(F.encode_raw_chunk(chunk,
                                                            fs.ref_cols)),
                        torch.from_numpy(hs.astype(np.int8)), counts)
    cols, vis, ops = F.decode_chain_output(prog, fs, mat.numpy())
    rc = _ref_chunk(chunk)
    step = RF.build_chain_step(rfs)
    fv, fo, vis2, ops2, srows = step(
        tuple(np.asarray(rc.columns[i].values) for i in rfs.ref_cols),
        tuple(np.asarray(rc.columns[i].validity) for i in rfs.ref_cols),
        chunk.visibility, chunk.ops, hs)
    np.testing.assert_array_equal(vis, np.asarray(vis2))
    np.testing.assert_array_equal(ops, np.asarray(ops2))
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  np.asarray(srows))
    k = 0
    for c in cols:
        if c is None:
            continue
        ok = np.ones(len(vis), bool) if c.validity is None else c.validity
        np.testing.assert_array_equal(ok, np.asarray(fo[k]))
        assert _bits_equal(c.values, np.asarray(fv[k]))[ok].all(), k
        k += 1


def _raw_with_separators(fs, seed, n_chunks=3, n=64):
    """A raw batch as GroupedAggKernel.apply_raw builds it: chunks, each
    followed by an always-invisible separator row."""
    mats = []
    for c in range(n_chunks):
        _fs, chunk = FC.port_case(seed, n, False, xla_safe=True)
        vis, ops = FC.chunk_meta(n, seed * 10 + c)
        chunk = StreamChunk(chunk.schema, chunk.columns, vis, ops)
        mats.append(F.encode_raw_chunk(chunk, fs.ref_cols))
        mats.append(np.zeros((1, mats[-1].shape[1]), dtype=np.int64))
    return np.concatenate(mats)


@pytest.mark.parametrize("seed", SEEDS)
def test_agg_prelude_plain_matches_reference(seed):
    import jax

    from risingwave_tpu.ops import hash_agg as RH
    from risingwave_tpu.stream.executors.hash_agg import AggCall as RCall
    fs, _chunk = FC.port_case(seed, 64, False, xla_safe=True)
    rfs = _ref_stages(fs, seed)
    group, calls, specs = FC.agg_plan(fs, seed)
    prog = F.compile_program(fs, F.MODE_AGG, group_indices=group,
                             agg_calls=calls, specs=specs)
    raw = _raw_with_separators(fs, seed)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    got = F.agg_prelude(prog, torch.from_numpy(raw), counts).numpy()
    rcalls = [RCall(RH.AggKind(c.kind.value), c.input_idx) for c in calls]
    rspecs = [c.spec(rfs.out_schema) for c in rcalls]
    pre = RF.build_agg_prelude(rfs, group, rcalls, rspecs)
    key_lanes, signs, vis, call_inputs, stage_rows = jax.jit(pre)(raw)
    inputs = [(tuple(np.asarray(x) for x in lanes_),
               None if ok is None else np.asarray(ok))
              for lanes_, ok in call_inputs]
    want = H.pack_chunk(3 * len(group), specs, np.asarray(key_lanes),
                        np.asarray(signs), np.asarray(vis), inputs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  np.asarray(stage_rows))


@pytest.mark.parametrize("seed", SEEDS)
def test_join_prelude_plain_matches_reference(seed):
    import jax
    fs, chunk = FC.port_case(seed, 128, False, xla_safe=True)
    rfs = _ref_stages(fs, seed)
    keys, pays = FC.join_plan(fs, seed)
    prog = F.compile_program(fs, F.MODE_JOIN, key_indices=keys,
                             pay_indices=pays)
    raw = F.encode_raw_chunk(chunk, fs.ref_cols)
    got = F.join_prelude(prog, torch.from_numpy(raw)).numpy()
    want = np.asarray(jax.jit(RF.build_join_prelude(rfs, keys, pays))(raw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_matches_numpy_chain_body(seed):
    """The compiled program against the port's numpy chain_body, which
    evaluates the expression objects directly, on trees where the two
    reference paths agree (``numpy_safe``: no reciprocal products, no
    saturating casts, no DECIMAL overflow detection)."""
    fs, chunk = FC.port_case(seed, 128, False, separators=3,
                             numpy_safe=True)
    prog = F.compile_program(fs, F.MODE_CHAIN)
    hs = fs.host_noop_eq(chunk)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    mat = F.fused_chain(prog,
                        torch.from_numpy(F.encode_raw_chunk(chunk,
                                                            fs.ref_cols)),
                        torch.from_numpy(hs.astype(np.int8)), counts)
    cols, vis, ops = F.decode_chain_output(prog, fs, mat.numpy())
    with np.errstate(all="ignore"):
        want, vis2, ops2, rows = fs.chain_body(
            list(chunk.columns), chunk.visibility, chunk.ops,
            host_same=hs)
    np.testing.assert_array_equal(vis, vis2)
    np.testing.assert_array_equal(ops, ops2)
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()), rows)
    for c, w in zip(cols, want):
        assert (c is None) == (w is None)
        if c is None:
            continue
        ok = np.ones(len(vis), bool) if c.validity is None else c.validity
        wok = np.ones(len(vis), bool) if w.validity is None \
            else np.asarray(w.validity)
        np.testing.assert_array_equal(ok, wok)
        assert _bits_equal(c.values, np.asarray(w.values))[ok].all()


def _ref_edge_stages(name):
    return FC.edge_stages(FC.EDGE_CASES[name], RE, RD, RInterval,
                          RF.FusedStage, RF.FusedStages, RSchema, RField,
                          xla_safe=True)


@pytest.mark.parametrize("name", sorted(FC.EDGE_CASES))
def test_edge_case_agg_prelude_plain_matches_reference(name):
    """csrc/fused.cu's tile edges (``fused_cases.EDGE_CASES``: four
    predicates, 32 outputs, U-/U+ and noop pairs across every tile edge
    and ring wrap, hop copies across tiles, short and long ``seg`` rings,
    one row, a ragged row count): the plain agg prelude equals the
    reference's traced prelude, run ring by ring as each shard runs it on
    its own block, outputs and stage counts."""
    import jax

    from risingwave_tpu.ops import hash_agg as RH
    from risingwave_tpu.stream.executors.hash_agg import AggCall as RCall
    case = FC.EDGE_CASES[name]
    fs, _chunk, seg = FC.edge_case(name, False, False, xla_safe=True)
    chunk = _chunk
    rfs = _ref_edge_stages(name)
    assert fs.ref_cols == rfs.ref_cols
    raw = F.encode_raw_chunk(chunk, fs.ref_cols)
    group, calls, specs = FC.agg_plan(fs, case.seed)
    prog = F.compile_program(fs, F.MODE_AGG, group_indices=group,
                             agg_calls=calls, specs=specs)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    got = F.agg_prelude(prog, torch.from_numpy(raw), counts, seg=seg).numpy()
    rcalls = [RCall(RH.AggKind(c.kind.value), c.input_idx) for c in calls]
    rspecs = [c.spec(rfs.out_schema) for c in rcalls]
    pre = jax.jit(RF.build_agg_prelude(rfs, group, rcalls, rspecs))
    ring = seg or len(raw)
    want, rows = [], 0
    for rs in range(0, len(raw), ring):
        key_lanes, signs, vis, call_inputs, stage_rows = pre(
            raw[rs:rs + ring])
        inputs = [(tuple(np.asarray(x) for x in lanes_),
                   None if ok is None else np.asarray(ok))
                  for lanes_, ok in call_inputs]
        want.append(H.pack_chunk(3 * len(group), specs,
                                 np.asarray(key_lanes), np.asarray(signs),
                                 np.asarray(vis), inputs))
        rows = rows + np.asarray(stage_rows)
    np.testing.assert_array_equal(got, np.concatenate(want))
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()), rows)


@pytest.mark.parametrize("name", sorted(
    n for n, c in FC.EDGE_CASES.items() if not c.seg))
def test_edge_case_chain_and_join_plain_match_reference(name):
    """The same edge cases through the chain step (against the
    reference's traced ``build_chain_step``: values, validities, vis, ops
    and stage rows) and, without a hop window, the join prelude (against
    ``build_join_prelude``)."""
    import jax
    case = FC.EDGE_CASES[name]
    fs, chunk, _seg = FC.edge_case(name, False, False, xla_safe=True)
    rfs = _ref_edge_stages(name)
    raw = F.encode_raw_chunk(chunk, fs.ref_cols)
    hs = fs.host_noop_eq(chunk)
    prog = F.compile_program(fs, F.MODE_CHAIN)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    mat = F.fused_chain(prog, torch.from_numpy(raw),
                        torch.from_numpy(hs.astype(np.int8)), counts)
    cols, vis, ops = F.decode_chain_output(prog, fs, mat.numpy())
    rc = _ref_chunk(chunk)
    fv, fo, vis2, ops2, srows = RF.build_chain_step(rfs)(
        tuple(np.asarray(rc.columns[i].values) for i in rfs.ref_cols),
        tuple(np.asarray(rc.columns[i].validity) for i in rfs.ref_cols),
        chunk.visibility, chunk.ops, hs)
    np.testing.assert_array_equal(vis, np.asarray(vis2))
    np.testing.assert_array_equal(ops, np.asarray(ops2))
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  np.asarray(srows))
    k = 0
    for c in cols:
        if c is None:
            continue
        ok = np.ones(len(vis), bool) if c.validity is None else c.validity
        want_ok = np.asarray(fo[k])
        if case.hop and len(want_ok) != len(vis):
            # the reference's step sizes an always-valid column's mask by
            # the unexpanded rows
            assert want_ok.all()
            want_ok = np.ones(len(vis), bool)
        np.testing.assert_array_equal(ok, want_ok)
        assert _bits_equal(c.values, np.asarray(fv[k]))[ok].all(), k
        k += 1
    if case.hop:
        return                      # join preludes refuse hop expansion
    keys, pays = FC.join_plan(fs, case.seed)
    jp = F.compile_program(fs, F.MODE_JOIN, key_indices=keys,
                           pay_indices=pays)
    got = F.join_prelude(jp, torch.from_numpy(raw)).numpy()
    want = np.asarray(jax.jit(RF.build_join_prelude(rfs, keys, pays))(raw))
    np.testing.assert_array_equal(got, want)


# -- hop expansion and absorbed watermark filters -----------------------------


def _hop_chunk():
    S = Schema.of(ts=DataType.TIMESTAMP, v=DataType.INT64)
    rng = np.random.default_rng(11)
    cap = 32
    ts = rng.integers(-20_000_000, 40_000_000, size=cap).astype(np.int64)
    v = rng.integers(-10, 10, size=cap).astype(np.int64)
    ok = rng.random(cap) > 0.2                    # NULL timestamps
    vis = rng.random(cap) > 0.1
    ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
    ops[6], ops[7] = int(Op.UPDATE_DELETE), int(Op.UPDATE_INSERT)
    return S, StreamChunk(S, [Column(DataType.TIMESTAMP, ts, ok.copy()),
                              Column(DataType.INT64, v, None)], vis, ops)


def test_hop_expansion_matches_reference():
    """Mirror of test_fusion.py:1148 (a hop_window stage built directly;
    tests/test_torch_hop_window.py holds it to the HopWindowExecutor):
    the program's expansion and window columns against the reference's
    traced chain step and the port's numpy chain_body."""
    S, chunk = _hop_chunk()
    hop = dict(time_col=0, slide_usecs=10_000_000, size_usecs=30_000_000)
    fs = F.FusedStages(S, [
        F.FusedStage("hop_window", "HopWindowExecutor", **hop),
        F.FusedStage("filter", "FilterExecutor",
                     exprs=(InputRef(1, DataType.INT64) >= lit(0),))])
    assert fs.fusable_reason() is None and fs.hop.units == 3
    prog = F.compile_program(fs, F.MODE_CHAIN)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    mat = F.fused_chain(prog, torch.from_numpy(
        F.encode_raw_chunk(chunk, fs.ref_cols)), None, counts).numpy()
    cols, vis, ops = F.decode_chain_output(prog, fs, mat)
    assert len(vis) == 3 * chunk.capacity
    want, vis2, ops2, rows = fs.chain_body(list(chunk.columns),
                                           chunk.visibility, chunk.ops)
    np.testing.assert_array_equal(vis, vis2)
    np.testing.assert_array_equal(ops, ops2)
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()), rows)
    RS = RSchema([RField("ts", RD.TIMESTAMP), RField("v", RD.INT64)])
    rfs = RF.FusedStages(RS, [
        RF.FusedStage("hop_window", "HopWindowExecutor", **hop),
        RF.FusedStage("filter", "FilterExecutor",
                      exprs=(RE.InputRef(1, RD.INT64) >= RE.lit(0),))])
    step = RF.build_chain_step(rfs)
    fv, fo, rvis, rops, srows = step(
        tuple(np.asarray(chunk.columns[i].values) for i in rfs.ref_cols),
        tuple(np.ones(chunk.capacity, bool) if chunk.columns[i].validity
              is None else chunk.columns[i].validity
              for i in rfs.ref_cols),
        chunk.visibility, chunk.ops, np.ones(chunk.capacity, bool))
    np.testing.assert_array_equal(vis, np.asarray(rvis))
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  np.asarray(srows))
    for k, (c, w) in enumerate(zip(cols, want)):
        ok = np.ones(len(vis), bool) if c.validity is None else c.validity
        wok = np.ones(len(vis), bool) if w.validity is None \
            else np.asarray(w.validity)
        np.testing.assert_array_equal(ok, wok)
        np.testing.assert_array_equal(c.values[ok], np.asarray(fv[k])[ok])
        np.testing.assert_array_equal(c.values[ok],
                                      np.asarray(w.values)[ok])


def _barrier(n):
    from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
    from risingwave_tpu_torch.stream.message import Barrier, BarrierKind
    prev = Epoch.from_physical(n - 1) if n > 1 else Epoch.INVALID
    return Barrier(EpochPair(Epoch.from_physical(n), prev),
                   BarrierKind.CHECKPOINT)


def test_watermark_filter_absorbed_block_matches_sequential():
    """Mirror of test_fusion.py:890: a wm→filter→project run fused into
    one block (the late mask on the card, the runtime watermark on the
    host) equals the sequential executors, rows, watermarks and the
    persisted watermark — actually-late rows and the no-watermark-yet
    chunk included."""
    from risingwave_tpu_torch.frontend.opt.fusion import fuse_fragments
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.fused import (
        FusedFragmentExecutor,
    )
    from risingwave_tpu_torch.stream.executors.simple import (
        FilterExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import (
        MockSource, collect_until_n_barriers,
    )
    from risingwave_tpu_torch.stream.executors.watermark_filter import (
        WATERMARK_STATE_SCHEMA, WatermarkFilterExecutor,
    )
    from risingwave_tpu_torch.stream.message import Watermark, is_chunk

    S = Schema.of(ts=DataType.TIMESTAMP, v=DataType.INT64,
                  s=DataType.VARCHAR)
    data = [([10_000, 20_000, 15_000], [1, 2, 3]),
            ([5_000, 25_000, None], [4, 5, 6]),
            ([30_000, 2_000, 26_000], [7, -8, 9])]

    def arm(fused):
        msgs = [_barrier(1)]
        for bn, (ts, v) in enumerate(data, start=2):
            msgs.append(StreamChunk.from_pydict(S, {
                "ts": ts, "v": v, "s": [f"x{x}" for x in v]}))
            msgs.append(_barrier(bn))
        store = MemoryStateStore()
        wm_state = StateTable(191, WATERMARK_STATE_SCHEMA, [0], store)
        wm = WatermarkFilterExecutor(MockSource(S, msgs), 0,
                                     Interval(usecs=4_000), wm_state)
        filt = FilterExecutor(wm, InputRef(1, DataType.INT64) > lit(0))
        top = ProjectExecutor(
            filt, exprs=[InputRef(0, DataType.TIMESTAMP),
                         InputRef(1, DataType.INT64) * lit(3),
                         InputRef(2, DataType.VARCHAR)],
            names=["ts", "v3", "s"], watermark_derivations={0: 0})
        if fused:
            top, fired, _d = fuse_fragments(top, device="cpu")
            assert fired == 1 and isinstance(top, FusedFragmentExecutor)
            assert [st.kind for st in top.fused_stages.stages] == \
                ["watermark_filter", "filter", "project"]
        out = []
        for m in asyncio.run(collect_until_n_barriers(top, 4)):
            if is_chunk(m):
                out.extend(("row", r) for r in m.to_records())
            elif isinstance(m, Watermark):
                out.append(("wm", m.col_idx, m.value))
        row = wm_state.get_row((0,))
        return out, None if row is None else tuple(row)

    on, wm_on = arm(True)
    off, wm_off = arm(False)
    assert on == off
    assert wm_on == wm_off and wm_on is not None
    assert any(t[0] == "wm" for t in on)


def test_watermark_sentinel_narrow_int_time_col():
    """Mirror of test_fusion.py:1086: the no-watermark-yet sentinel is
    the time column's own dtype minimum, so no negative int32 timestamp
    is late before a watermark exists — on the numpy chain and in the
    program."""
    from risingwave_tpu_torch.stream.executors.test_utils import MockSource
    from risingwave_tpu_torch.stream.executors.watermark_filter import (
        WatermarkFilterExecutor,
    )
    S32 = Schema.of(t=DataType.INT32, v=DataType.INT64)
    rt = WatermarkFilterExecutor(MockSource(S32, []), 0, Interval(usecs=0))
    st = F.FusedStage("watermark_filter", "WatermarkFilterExecutor",
                      time_col=0, delay_usecs=0, runtime=rt)
    fs = F.FusedStages(S32, [st, F.FusedStage(
        "filter", "FilterExecutor",
        exprs=(InputRef(1, DataType.INT64) >= lit(0),))])
    assert fs.fusable_reason() is None
    chunk = StreamChunk.from_pydict(S32, {"t": [-5, -1, 3], "v": [1, 2, 3]})
    aug = fs.augment(chunk)
    thr = np.asarray(aug.columns[2].values)
    assert thr.dtype == np.int32 and (thr == np.iinfo(np.int32).min).all()
    _c, vis2, _o, _r = fs.chain_body(list(aug.columns), aug.visibility,
                                     aug.ops)
    assert (vis2 == aug.visibility).all()
    prog = F.compile_program(fs, F.MODE_CHAIN)
    mat = F.fused_chain(prog, torch.from_numpy(
        F.encode_raw_chunk(aug, fs.ref_cols))).numpy()
    _cols, vis, _ops = F.decode_chain_output(prog, fs, mat)
    np.testing.assert_array_equal(vis, aug.visibility)


def test_casts_to_decimal_stay_interpretive():
    """A cast to DECIMAL carries overflow detection on the host: the run
    stays interpretive, as the reference's walker decides."""
    fs = F.FusedStages(SCHEMA, [F.FusedStage(
        "project", "ProjectExecutor",
        exprs=(Cast(InputRef(0, DataType.INT64), DataType.DECIMAL),),
        names=("d",))])
    assert "DECIMAL" in fs.fusable_reason()


def test_random_cases_cover_every_opcode():
    """The seeds the card's checks use (chip_smoke.py phase 3,
    tests/test_torch_cuda_kernels.py) reach every opcode of the
    program format."""
    ops = set()
    for seed in range(12):
        fs, _chunk = FC.port_case(seed, 64, True, separators=8)
        ops |= F.compile_program(fs, F.MODE_CHAIN).opcodes()
    assert ops == set(range(F.OP_EXTRACT_EPOCH + 1))


def _edge_stages(seed):
    """Both packages' filter→project run over the case schema on edge
    values: every device column passed through (what the preludes'
    lane encoders see: NaN, ±inf, -0.0, INT64_MIN, the int16/int32
    limits, negative timestamps) beside a few computed columns."""
    cols = [("ref", i, t) for i, (_n, t) in enumerate(FC.COLS[:-1])]
    outs = cols + [("bin", "-", ("ref", 5, "FLOAT64"), ("ref", 5, "FLOAT64")),
                   ("func", "tumble_start", [("ref", 7, "TIMESTAMP"),
                                             ("interval", 10_000_000)],
                    "TIMESTAMP"),
                   ("cast", ("ref", 4, "FLOAT32"), "INT32")]
    pred = ("un", "is_not_null", ("ref", 0, "BOOLEAN"))
    names = tuple(f"o{j}" for j in range(len(outs)))
    ps = Schema([Field(nm, DataType[t]) for nm, t in FC.COLS])
    rs = RSchema([RField(nm, RD[t]) for nm, t in FC.COLS])
    fs = F.FusedStages(ps, [
        F.FusedStage("filter", "FilterExecutor",
                     exprs=(FC.build(pred, E, DataType, Interval),)),
        F.FusedStage("project", "ProjectExecutor", names=names,
                     exprs=tuple(FC.build(o, E, DataType, Interval)
                                 for o in outs))])
    rfs = RF.FusedStages(rs, [
        RF.FusedStage("filter", "FilterExecutor",
                      exprs=(FC.build(pred, RE, RD, RInterval),)),
        RF.FusedStage("project", "ProjectExecutor", names=names,
                      exprs=tuple(FC.build(o, RE, RD, RInterval)
                                  for o in outs))])
    cols_ = FC.column_values(256, seed, True)
    vis, ops = FC.chunk_meta(256, seed, separators=4)
    chunk = StreamChunk(ps, [Column(DataType[t], v, ok) for (_n, t), (v, ok)
                             in zip(FC.COLS, cols_)], vis, ops)
    return fs, rfs, chunk


@pytest.mark.parametrize("group", [3, 4, 5, 7])
def test_agg_prelude_encodes_edge_values_like_reference(group):
    """Group keys over int64, f32 and f64 (NaN, -0.0) and timestamps,
    SUM/MIN/MAX/COUNT inputs over every type, edge values in every
    column: the packed matrix equals the reference's prelude."""
    import jax

    from risingwave_tpu.ops import hash_agg as RH
    from risingwave_tpu.stream.executors.hash_agg import AggCall as RCall
    from risingwave_tpu_torch.stream.executors.hash_agg import AggCall
    fs, rfs, chunk = _edge_stages(group)
    K = H.AggKind
    calls = [AggCall(K.COUNT), AggCall(K.SUM, 1), AggCall(K.SUM, 3),
             AggCall(K.SUM, 4), AggCall(K.SUM, 5), AggCall(K.MAX, 2),
             AggCall(K.MIN, 5), AggCall(K.MAX, 4), AggCall(K.SUM, 6),
             AggCall(K.COUNT, 8), AggCall(K.MIN, 0)]
    specs = [c.spec(fs.out_schema) for c in calls]
    prog = F.compile_program(fs, F.MODE_AGG, group_indices=[group],
                             agg_calls=calls, specs=specs)
    raw = F.encode_raw_chunk(chunk, fs.ref_cols)
    counts = torch.zeros(prog.n_counts, dtype=torch.int64)
    got = F.agg_prelude(prog, torch.from_numpy(raw), counts).numpy()
    rcalls = [RCall(RH.AggKind(c.kind.value), c.input_idx) for c in calls]
    pre = RF.build_agg_prelude(rfs, [group], rcalls,
                               [c.spec(rfs.out_schema) for c in rcalls])
    key_lanes, signs, vis, call_inputs, stage_rows = jax.jit(pre)(raw)
    inputs = [(tuple(np.asarray(x) for x in lanes_),
               None if ok is None else np.asarray(ok))
              for lanes_, ok in call_inputs]
    want = H.pack_chunk(3, specs, np.asarray(key_lanes), np.asarray(signs),
                        np.asarray(vis), inputs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fs.stage_rows_of(counts.numpy()),
                                  np.asarray(stage_rows))


def test_join_prelude_encodes_edge_values_like_reference():
    """Key lanes (floats normalized: -0.0 joins 0.0) and bit-preserving
    payload lanes (-0.0 and NaN kept) of every type, on edge values."""
    import jax
    fs, rfs, chunk = _edge_stages(9)
    keys = [3, 4, 5, 0]
    pays = [j for j, f in enumerate(fs.out_schema) if f.data_type.is_device]
    prog = F.compile_program(fs, F.MODE_JOIN, key_indices=keys,
                             pay_indices=pays)
    raw = F.encode_raw_chunk(chunk, fs.ref_cols)
    got = F.join_prelude(prog, torch.from_numpy(raw)).numpy()
    want = np.asarray(jax.jit(RF.build_join_prelude(rfs, keys, pays))(raw))
    np.testing.assert_array_equal(got, want)
