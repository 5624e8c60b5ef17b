"""HopWindowExecutor on the PyTorch port, against the JAX reference.

The reference's executor tests run against both packages on the same
scripted chunks, and the two packages' outputs must be equal record for
record:

- ``tests/test_operators.py:118`` (each row expands into its windows)
  and :136 (a size the slide does not divide is refused);
- ``tests/test_fusion.py:1148`` (the hop + filter chain composed as a
  fused run equals the sequential HopWindowExecutor + FilterExecutor:
  NULL timestamps dropped, U-/U+ pairs kept per copy), here for the
  port's numpy ``chain_body`` and its compiled program's plain version;
  :1214 (a watermark on the time column re-derives to window_start);
  :1228 (bad shapes refused) and :1254 (power-of-two copy groups);
- q5-hot's own hop (slide 2 s, size 10 s: 5 copies, a chunk of 4 copies
  and one of 1) on a Nexmark bid chunk, with a watermark between chunks.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.connectors.nexmark as r_nexmark
import risingwave_tpu.expr.expr as r_expr
import risingwave_tpu.ops.fused as r_fused
import risingwave_tpu.stream.executors.hop_window as r_hop
import risingwave_tpu.stream.executors.simple as r_simple
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.connectors.nexmark as p_nexmark
import risingwave_tpu_torch.expr.expr as p_expr
import risingwave_tpu_torch.ops.fused as p_fused
import risingwave_tpu_torch.stream.executors.hop_window as p_hop
import risingwave_tpu_torch.stream.executors.simple as p_simple
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.message as p_msg

torch.set_num_threads(2)

PKGS = {
    "ref": SimpleNamespace(chunk=r_chunk, epoch=r_epoch, types=r_types,
                           nexmark=r_nexmark, expr=r_expr, fused=r_fused,
                           hop=r_hop, simple=r_simple, tu=r_tu, msg=r_msg),
    "port": SimpleNamespace(chunk=p_chunk, epoch=p_epoch, types=p_types,
                            nexmark=p_nexmark, expr=p_expr, fused=p_fused,
                            hop=p_hop, simple=p_simple, tu=p_tu, msg=p_msg),
}


def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def ts_schema(m):
    T = m.types
    return T.Schema.of(ts=T.DataType.TIMESTAMP, v=T.DataType.INT64)


def collect(m, ex, n_barriers):
    """(kind, payload) per message: chunks as their records with the
    capacity, watermarks as (col, value)."""
    msgs = asyncio.run(m.tu.collect_until_n_barriers(ex, n_barriers))
    out = []
    for x in msgs:
        if m.msg.is_chunk(x):
            out.append(("chunk", x.capacity,
                        [(int(op), r) for op, r in x.to_records()]))
        elif m.msg.is_watermark(x):
            out.append(("wm", x.col_idx, x.value))
        else:
            out.append(("barrier",))
    return out


def run_hop(pkg, script, slide, size, time_col=0, schema=None):
    m = PKGS[pkg]
    S = schema or ts_schema(m)
    src = m.tu.MockSource(S, script(m, S))
    Iv = m.types.Interval
    ex = m.hop.HopWindowExecutor(src, time_col, Iv(usecs=slide),
                                 Iv(usecs=size))
    return ex, collect(m, ex, sum(1 for x in script(m, S)
                                  if isinstance(x, m.msg.Barrier)))


def both(script, slide, size, **kw):
    (ex, port), (_rex, ref) = (run_hop("port", script, slide, size, **kw),
                               run_hop("ref", script, slide, size, **kw))
    assert port == ref
    return ex, port


def records(out):
    return [r for x in out if x[0] == "chunk" for r in x[2]]


# -- tests/test_operators.py:118, :136 ---------------------------------------

def test_hop_window_expands_each_row():
    def script(m, S):
        return [barrier(m, 1),
                m.chunk.StreamChunk.from_pydict(S, {"ts": [25_000_000],
                                                    "v": [7]}),
                barrier(m, 2)]
    ex, out = both(script, 10_000_000, 30_000_000)
    rows = records(out)
    assert sorted(r[2] for _op, r in rows) == [0, 10_000_000, 20_000_000]
    for _op, r in rows:
        assert r[3] == r[2] + 30_000_000          # window_end
        assert r[2] <= 25_000_000 < r[3]
    assert ex.units == 3 and [f.name for f in ex.schema] == \
        ["ts", "v", "window_start", "window_end"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_hop_window_rejects_non_divisible(pkg):
    m = PKGS[pkg]
    src = m.tu.MockSource(ts_schema(m), [])
    Iv = m.types.Interval
    with pytest.raises(ValueError):
        m.hop.HopWindowExecutor(src, 0, Iv(usecs=7_000_000),
                                Iv(usecs=30_000_000))
    with pytest.raises(ValueError):
        m.hop.HopWindowExecutor(src, 0, Iv(usecs=0), Iv(usecs=30_000_000))


# -- tests/test_fusion.py:1148-1254 -----------------------------------------------

def _random_chunk(m, S):
    rng = np.random.default_rng(11)
    cap = 32
    ts = rng.integers(0, 40_000_000, size=cap).astype(np.int64)
    v = rng.integers(-10, 10, size=cap).astype(np.int64)
    ok = rng.random(cap) > 0.2           # NULL timestamps
    vis = rng.random(cap) > 0.1
    ops = np.full(cap, 1, dtype=np.int8)
    ops[6], ops[7] = 3, 4                # a U-/U+ pair
    C = m.chunk.Column
    DT = m.types.DataType
    return m.chunk.StreamChunk(S, [C(DT.TIMESTAMP, ts, ok.copy()),
                                   C(DT.INT64, v, None)], vis, ops)


def _sequential(pkg):
    """HopWindowExecutor + FilterExecutor over the random chunk."""
    m = PKGS[pkg]
    S = ts_schema(m)
    pred = m.expr.InputRef(1, m.types.DataType.INT64) >= m.expr.lit(0)
    src = m.tu.MockSource(S, [barrier(m, 1), _random_chunk(m, S),
                              barrier(m, 2)])
    Iv = m.types.Interval
    hop = m.hop.HopWindowExecutor(src, 0, Iv(usecs=10_000_000),
                                  Iv(usecs=30_000_000))
    return records(collect(m, m.simple.FilterExecutor(hop, pred), 2))


def test_hop_chain_body_matches_sequential_executor():
    """The composed hop + filter run (numpy chain_body, and the compiled
    program's plain version decoded) equals the sequential executors in
    both packages, row for row in copy order."""
    want = _sequential("ref")
    assert _sequential("port") == want and want
    m = PKGS["port"]
    S = ts_schema(m)
    F = m.fused
    pred = m.expr.InputRef(1, m.types.DataType.INT64) >= m.expr.lit(0)
    fs = F.FusedStages(S, [
        F.FusedStage("hop_window", "HopWindowExecutor", time_col=0,
                     slide_usecs=10_000_000, size_usecs=30_000_000),
        F.FusedStage("filter", "FilterExecutor", exprs=(pred,))])
    assert fs.fusable_reason() is None
    chunk = _random_chunk(m, S)
    cols, vis, ops, _rows = fs.chain_body(list(chunk.columns),
                                          chunk.visibility, chunk.ops)
    got = m.chunk.StreamChunk(fs.out_schema, cols, np.asarray(vis),
                              np.asarray(ops))
    assert [(int(op), r) for op, r in got.to_records()] == want
    prog = F.compile_program(fs, F.MODE_CHAIN)
    mat = F.run_program_plain(prog, torch.from_numpy(
        F.encode_raw_chunk(chunk, fs.ref_cols))).numpy()
    cols, vis, ops = F.decode_chain_output(prog, fs, mat)
    got = m.chunk.StreamChunk(fs.out_schema, cols, vis, ops)
    assert [(int(op), r) for op, r in got.to_records()] == want


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_hop_watermark_rederivation_through_absorbed_stage(pkg):
    m = PKGS[pkg]
    S = ts_schema(m)
    fs = m.fused.FusedStages(S, [m.fused.FusedStage(
        "hop_window", "HopWindowExecutor", time_col=0,
        slide_usecs=10_000_000, size_usecs=30_000_000)])
    W = m.msg.Watermark
    DT = m.types.DataType
    out = fs.derive_watermarks(W(0, DT.TIMESTAMP, 25_000_000))
    assert [(w.col_idx, w.value) for w in out] == [(2, 0)]
    assert fs.derive_watermarks(W(1, DT.INT64, 5)) == []


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_hop_refuses_bad_shapes(pkg):
    m = PKGS[pkg]
    S = ts_schema(m)
    F = m.fused
    DT = m.types.DataType
    hop = F.FusedStage("hop_window", "HopWindowExecutor", time_col=0,
                       slide_usecs=10, size_usecs=30)
    with pytest.raises(ValueError):           # a hop that is not the head
        F.FusedStages(S, [F.FusedStage(
            "filter", "FilterExecutor",
            exprs=(m.expr.InputRef(1, DT.INT64) >= m.expr.lit(0),)), hop])
    SF = m.types.Schema.of(ts=DT.FLOAT64, v=DT.INT64)
    fsf = F.FusedStages(SF, [F.FusedStage(
        "hop_window", "HopWindowExecutor", time_col=0,
        slide_usecs=10, size_usecs=30)])
    assert "non-integer" in fsf.fusable_reason()
    fs = F.FusedStages(S, [hop])
    assert fs.input_positions([2]) is None
    assert fs.input_positions([1]) == [1]


def test_hop_executor_emits_pow2_copy_groups():
    """3 windows: a 2-copy chunk and a 1-copy chunk, each of a
    power-of-two capacity; the NULL timestamp's copies are dropped."""
    def script(m, S):
        return [barrier(m, 1),
                m.chunk.StreamChunk.from_pydict(
                    S, {"ts": [25_000_000, None], "v": [7, 8]}),
                barrier(m, 2)]
    _ex, out = both(script, 10_000_000, 30_000_000)
    chunks = [x for x in out if x[0] == "chunk"]
    assert len(chunks) == bin(3).count("1")
    for _k, cap, _r in chunks:
        assert cap & (cap - 1) == 0
    recs = records(out)
    assert sorted(r[2] for _op, r in recs) == [0, 10_000_000, 20_000_000]
    assert all(r[1] == 7 for _op, r in recs)


# -- q5-hot's hop on Nexmark bids ---------------------------------------------

def test_q5_hop_on_bids_with_watermarks():
    """q5-hot's hop (slide 2 s, size 10 s: a 4-copy chunk and a 1-copy
    chunk per input chunk) on two chunks of Nexmark bids with a watermark
    on date_time between them (re-derived to window_start); an unrelated
    column's watermark is consumed."""
    def script(m, S):
        cfg = m.nexmark.NexmarkConfig(event_num=20_000, max_chunk_size=64,
                                      generate_strings=False)
        rd = m.nexmark.NexmarkSplitReader(cfg)
        c1, c2 = rd.next_chunk(), rd.next_chunk()
        W = m.msg.Watermark
        DT = m.types.DataType
        t = S.index_of("date_time")
        wm = int(c1.columns[t].values[:64].max())
        return [barrier(m, 1), c1, W(t, DT.TIMESTAMP, wm),
                W(0, DT.INT64, 5), c2, barrier(m, 2)]

    def bid_schema(m):
        return m.nexmark.BID_SCHEMA
    outs = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        S = bid_schema(m)
        outs[pkg] = run_hop(pkg, script, 2_000_000, 10_000_000,
                            time_col=S.index_of("date_time"), schema=S)
    ex, out = outs["port"]
    assert out == outs["ref"][1]
    assert ex.units == 5
    chunks = [x for x in out if x[0] == "chunk"]
    assert [c[1] for c in chunks] == [256, 64, 256, 64]
    wms = [x for x in out if x[0] == "wm"]
    ws = len(PKGS["port"].nexmark.BID_SCHEMA)
    assert len(wms) == 1 and wms[0][1] == ws
    assert len(records(out)) == 5 * 128
