"""Chunk compaction, barrier-bounded coalescing, the merge executors and
exchange credit on the PyTorch port, against the JAX reference.

Twins of ``tests/test_coalesce.py`` (all but the cases of the wire path,
the hash dispatcher, the monitor and the SQL frontend, which belong to
later slices): each builds the same chunks in both packages and requires
the same output from the reference's and the port's ``compact``,
``merge_chunks``, ``ChunkCoalescer``, ``CoalesceExecutor`` and
``MergeExecutor`` (records with their ops, ``dense_rows``, capacities,
message order), plus the reference test's own expectation. Then:

- random chunks from a numpy seed (sparse visibility, update pairs split
  by it) through ``compact`` and the coalescer in both packages;
- exchange credit by ``dense_rows`` (the port's repair of
  ``Sender.send``);
- q7 through ``build_q7(coalesce_rows=...)``: the port's MV equals its
  uncoalesced MV and the reference's coalesced MV, its device-step count
  drops to at most 0.75x, and with ``fusion=True`` the agg absorbs the
  coalescer in both packages;
- ``device_dispatch`` on q8, q1 and the sharded q7 and q8, fused and
  not: the port counts the reference's device steps, site for site.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.stream.coalesce as r_co
import risingwave_tpu.stream.exchange as r_ex
import risingwave_tpu.stream.executor as r_executor
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.merge as r_merge
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.stream.coalesce as p_co
import risingwave_tpu_torch.stream.exchange as p_ex
import risingwave_tpu_torch.stream.executor as p_executor
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.merge as p_merge
import risingwave_tpu_torch.stream.message as p_msg

torch.set_num_threads(2)

PKGS = {
    "ref": SimpleNamespace(chunk=r_chunk, epoch=r_epoch, types=r_types,
                           co=r_co, ex=r_ex, executor=r_executor, tu=r_tu,
                           merge=r_merge, msg=r_msg),
    "port": SimpleNamespace(chunk=p_chunk, epoch=p_epoch, types=p_types,
                            co=p_co, ex=p_ex, executor=p_executor, tu=p_tu,
                            merge=p_merge, msg=p_msg),
}

INSERT, DELETE, U_DEL, U_INS = 1, 2, 3, 4


def run(coro):
    return asyncio.run(coro)


def schema(m):
    T = m.types
    return T.Schema.of(k=T.DataType.INT64, v=T.DataType.INT64)


def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def chunk(m, ks, vs, ops=None, capacity=None, vis=None):
    c = m.chunk.StreamChunk.from_pydict(schema(m), {"k": ks, "v": vs},
                                        ops=ops, capacity=capacity)
    if vis is not None:
        v = np.zeros(c.capacity, dtype=bool)
        v[:len(vis)] = vis
        c = c.with_visibility(v)
    return c


def wm(m, v):
    return m.msg.Watermark(0, m.types.DataType.INT64, v)


def recs(c):
    return [(int(op), r) for op, r in c.to_records()]


def desc(m, x):
    """A message in a package-free form (chunks with dense_rows and
    capacity)."""
    if x is None:
        return None
    if m.msg.is_chunk(x):
        return ("C", recs(x), x.dense_rows, x.capacity)
    if m.msg.is_barrier(x):
        return ("B", x.epoch.curr.value)
    return ("W", x.col_idx, x.value)


def both(fn):
    """fn(m) -> a package-free result; equal in both packages."""
    got = {pkg: fn(PKGS[pkg]) for pkg in ("ref", "port")}
    assert got["port"] == got["ref"], (got["port"], got["ref"])
    return got["port"]


def coalesced(m, msgs, target_rows=1 << 20, n=None):
    co = m.co.CoalesceExecutor(m.tu.MockSource(schema(m), msgs),
                               target_rows=target_rows)
    if n is None:
        async def go():
            return [x async for x in co.execute()]
        out = run(go())
    else:
        out = run(m.tu.collect_until_n_barriers(co, n))
    return [desc(m, x) for x in out]


# -- compact (tests/test_coalesce.py:57-100) ---------------------------------------

def test_compact_drops_invisible_rows_matches_reference():
    def f(m):
        vis = np.ones(6, dtype=bool)
        vis[[1, 3, 4]] = False
        return desc(m, m.co.compact(chunk(m, list(range(6)),
                                          [10 * i for i in range(6)],
                                          capacity=64, vis=vis)))
    _c, r, dense, cap = both(f)
    assert dense == 3 and cap == 8          # next pow2 bucket, not 64
    assert r == [(INSERT, (0, 0)), (INSERT, (2, 20)), (INSERT, (5, 50))]


def test_compact_empty_returns_none_matches_reference():
    assert both(lambda m: m.co.compact(
        chunk(m, [1, 2], [1, 2], vis=[False, False]))) is None


def test_compact_dense_prefix_is_identity_matches_reference():
    def f(m):
        c = chunk(m, [1, 2, 3], [1, 2, 3])
        d = m.co.compact(c)
        return d is c, d.dense_rows
    assert both(f) == (True, 3)


def test_compact_update_pair_atomicity_matches_reference():
    # pair A whole, pair B's U+ hidden, pair C's U- hidden
    def f(m):
        return recs(m.co.compact(chunk(
            m, [1, 1, 2, 2, 3, 3], [10, 11, 20, 21, 30, 31],
            ops=[U_DEL, U_INS] * 3,
            vis=[True, True, True, False, False, True])))
    assert both(f) == [(U_DEL, (1, 10)), (U_INS, (1, 11)),
                       (DELETE, (2, 20)), (INSERT, (3, 31))]


def test_compact_pair_straddling_dense_prefix_boundary_matches_reference():
    def f(m):
        return recs(m.co.compact(chunk(m, [1, 1], [10, 11],
                                       ops=[U_DEL, U_INS],
                                       vis=[True, False])))
    assert both(f) == [(DELETE, (1, 10))]


# -- merge_chunks (tests/test_coalesce.py:112, :123) --------------------------------

def test_merge_chunks_preserves_order_and_pairs_matches_reference():
    def f(m):
        a = m.co.compact(chunk(m, [1, 1], [10, 11], ops=[U_DEL, U_INS]))
        b = m.co.compact(chunk(m, [2], [20], ops=[DELETE]))
        return desc(m, m.co.merge_chunks([a, b]))
    _c, r, dense, _cap = both(f)
    assert dense == 3
    assert r == [(U_DEL, (1, 10)), (U_INS, (1, 11)), (DELETE, (2, 20))]


def test_merge_chunks_null_validity_matches_reference():
    def f(m):
        T = m.types
        sch = T.Schema.of(k=T.DataType.INT64, s=T.DataType.VARCHAR)
        SC = m.chunk.StreamChunk
        a = m.co.compact(SC.from_pydict(sch, {"k": [1], "s": [None]}))
        b = m.co.compact(SC.from_pydict(sch, {"k": [2], "s": ["x"]}))
        return recs(m.co.merge_chunks([a, b]))
    assert both(f) == [(INSERT, (1, None)), (INSERT, (2, "x"))]


# -- ChunkCoalescer (tests/test_coalesce.py:135-166) --------------------------------

def test_coalescer_merges_small_chunks_to_target_matches_reference():
    def f(m):
        co = m.co.ChunkCoalescer(target_rows=8)
        out = []
        for i in range(4):                  # 4 chunks x 3 rows
            out += co.push(chunk(m, [i] * 3, [i] * 3))
        return ([desc(m, c) for c in out], co.buffered_rows,
                desc(m, co.flush()))
    out, buffered, tail = both(f)
    # 3 + 3 < 8, 3 + 3 + 3 >= 8: one merged chunk after the third push
    assert len(out) == 1 and out[0][2] == 9
    assert buffered == 3 and tail[2] == 3


def test_coalescer_big_chunk_flushes_older_rows_first_matches_reference():
    def f(m):
        co = m.co.ChunkCoalescer(target_rows=100)
        first = co.push(chunk(m, [1], [1]))
        out = co.push(chunk(m, list(range(200)), list(range(200))))
        return first, [desc(m, c) for c in out]
    first, out = both(f)
    assert first == [] and len(out) == 2
    assert out[0][1] == [(INSERT, (1, 1))]          # older first
    assert out[1][2] == 200


def test_coalescer_linger_bound_matches_reference():
    def f(m):
        co = m.co.ChunkCoalescer(target_rows=1 << 20, max_chunks=4)
        out = []
        for i in range(4):
            out += co.push(chunk(m, [i], [i]))
        return [desc(m, c) for c in out]
    out = both(f)
    assert len(out) == 1 and out[0][2] == 4


def test_coalescer_drops_empty_chunks_matches_reference():
    def f(m):
        co = m.co.ChunkCoalescer(target_rows=8)
        return co.push(chunk(m, [1], [1], vis=[False])), co.flush()
    assert both(f) == ([], None)


# -- CoalesceExecutor (tests/test_coalesce.py:176-247, :578) ------------------------

def test_barrier_never_delayed_behind_lingering_batch_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1), chunk(m, [1], [10]), chunk(m, [2], [20]),
        barrier(m, 2), chunk(m, [3], [30]), barrier(m, 3)], n=3))
    assert [x[0] for x in out] == ["B", "C", "B", "C", "B"]
    assert out[1][2] == 2
    assert out[1][1] == [(INSERT, (1, 10)), (INSERT, (2, 20))]
    assert out[3][1] == [(INSERT, (3, 30))]


def test_watermark_resequences_to_flush_never_past_barrier_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1), chunk(m, [1], [10]), wm(m, 42),
        chunk(m, [2], [20]), barrier(m, 2)], n=2))
    assert [x[0] for x in out] == ["B", "C", "W", "B"]
    assert out[1][1] == [(INSERT, (1, 10)), (INSERT, (2, 20))]
    assert out[2][2] == 42


def test_watermark_passes_through_when_buffer_empty_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1), wm(m, 7), chunk(m, [1], [10]), barrier(m, 2)], n=2))
    assert [x[0] for x in out] == ["B", "W", "C", "B"]


def test_held_watermarks_keep_only_latest_per_column_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1), chunk(m, [1], [10]), wm(m, 5), chunk(m, [2], [20]),
        wm(m, 9), barrier(m, 2)], n=2))
    assert [x[2] for x in out if x[0] == "W"] == [9]


def test_coalescer_pair_atomicity_across_merges_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1),
        chunk(m, [1, 1], [10, 11], ops=[U_DEL, U_INS]),
        chunk(m, [2, 2], [20, 21], ops=[U_DEL, U_INS]),
        barrier(m, 2)], target_rows=4, n=2))
    chunks = [x for x in out if x[0] == "C"]
    assert [r for c in chunks for r in c[1]] == [
        (U_DEL, (1, 10)), (U_INS, (1, 11)),
        (U_DEL, (2, 20)), (U_INS, (2, 21))]
    for c in chunks:                         # each pair within one chunk
        ops = [op for op, _r in c[1]]
        for i, op in enumerate(ops):
            if op == U_DEL:
                assert ops[i + 1] == U_INS


def test_coalesce_executor_flushes_on_end_of_stream_matches_reference():
    out = both(lambda m: coalesced(m, [
        barrier(m, 1), chunk(m, [1], [10]), chunk(m, [2], [20])]))
    chunks = [x for x in out if x[0] == "C"]
    assert len(chunks) == 1 and chunks[0][2] == 2


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_compact_and_coalesce_random_chunks_match_reference(seed):
    """Random capacities, sparse visibility and update pairs split by it,
    watermarks between chunks: compact's output and the coalesced stream
    are equal in both packages, and no barrier trails a buffered row."""
    rng = np.random.default_rng(seed)
    plan = []
    epoch = 1
    plan.append(("b", epoch))
    for _ in range(40):
        n = int(rng.integers(1, 40))
        ops = []
        while len(ops) < n:
            if rng.random() < 0.3:
                ops += [U_DEL, U_INS]
            else:
                ops.append(int(rng.choice([INSERT, DELETE])))
        ks = rng.integers(0, 1000, len(ops)).tolist()
        vs = rng.integers(-50, 50, len(ops)).tolist()
        vis = (rng.random(len(ops)) < 0.6).tolist()
        cap = int(2 ** int(rng.integers(6, 8)))
        plan.append(("c", ks, vs, ops, cap, vis))
        r = rng.random()
        if r < 0.15:
            plan.append(("w", int(rng.integers(0, 100)) + epoch * 100))
        elif r < 0.3:
            epoch += 1
            plan.append(("b", epoch))
    epoch += 1
    plan.append(("b", epoch))

    def f(m):
        msgs = []
        for p in plan:
            if p[0] == "b":
                msgs.append(barrier(m, p[1]))
            elif p[0] == "w":
                msgs.append(wm(m, p[1]))
            else:
                msgs.append(chunk(m, p[1], p[2], ops=p[3], capacity=p[4],
                                  vis=p[5]))
        comp = [desc(m, m.co.compact(x)) for x in msgs if m.msg.is_chunk(x)]
        fresh = []
        for p in plan:     # compact stamps dense_rows: rebuild the chunks
            if p[0] == "b":
                fresh.append(barrier(m, p[1]))
            elif p[0] == "w":
                fresh.append(wm(m, p[1]))
            else:
                fresh.append(chunk(m, p[1], p[2], ops=p[3], capacity=p[4],
                                   vis=p[5]))
        return comp, coalesced(m, fresh, target_rows=64, n=epoch)
    comp, out = both(f)
    visible = sum(sum(p[5]) for p in plan if p[0] == "c")
    assert sum(x[2] or 0 for x in comp if x is not None) == visible
    assert sum(x[2] for x in out if x[0] == "C") == visible


# -- MergeExecutor / MergeExecutors (tests/test_coalesce.py:275, :520, :552) --------

def _merge(m, rows):
    tx1, rx1 = m.ex.channel_for_test()
    tx2, rx2 = m.ex.channel_for_test()
    merge = m.merge.MergeExecutor(
        m.executor.ExecutorInfo(schema(m), [], "Merge"), [rx1, rx2],
        coalesce_rows=rows)
    return (tx1, tx2), merge


def test_merge_executor_coalesces_between_barriers_matches_reference():
    def f(m):
        async def go():
            (tx1, tx2), merge = _merge(m, 1 << 20)

            async def feed():
                await tx1.send(chunk(m, [1], [1]))
                await tx2.send(chunk(m, [2], [2]))
                await tx1.send(barrier(m, 1))
                await tx2.send(barrier(m, 1))
                tx1.close()
                tx2.close()
            feeder = asyncio.ensure_future(feed())
            out = await m.tu.collect_until_n_barriers(merge, 1)
            await feeder
            return [desc(m, x) for x in out]
        out = run(go())
        # the two inputs' arrival order may differ: compare sorted rows
        return [(x[0], sorted(x[1]), x[2]) if x[0] == "C" else x
                for x in out]
    out = both(f)
    assert [x[0] for x in out] == ["C", "B"]      # both rows, one chunk
    assert out[0][2] == 2
    assert [r for _op, r in out[0][1]] == [(1, 1), (2, 2)]


def test_merge_executor_resequences_watermarks_matches_reference():
    def f(m):
        async def go():
            (tx1, tx2), merge = _merge(m, 1 << 20)

            async def feed():
                await tx1.send(chunk(m, [1], [1]))
                await tx1.send(wm(m, 50))
                await tx2.send(chunk(m, [2], [2]))
                await tx2.send(wm(m, 60))
                await tx1.send(barrier(m, 1))
                await tx2.send(barrier(m, 1))
                tx1.close()
                tx2.close()
            feeder = asyncio.ensure_future(feed())
            out = await m.tu.collect_until_n_barriers(merge, 1)
            await feeder
            return [desc(m, x) for x in out]
        return [(x[0], sorted(x[1]), x[2]) if x[0] == "C" else x
                for x in run(go())]
    out = both(f)
    # one merged chunk, the aligned (min) watermark, then the barrier
    assert [x[0] for x in out] == ["C", "W", "B"]
    assert out[0][2] == 2 and out[1][2] == 50


@pytest.mark.parametrize("rows", [None, 1 << 20])
def test_merge_never_leaks_pre_barrier_data_past_the_barrier_matches_reference(
        rows):
    def f(m):
        async def go():
            (tx1, tx2), merge = _merge(m, rows)
            # everything is sent before the consumer runs at all
            for k in range(5):
                await tx1.send(chunk(m, [k], [k]))
                await tx2.send(chunk(m, [10 + k], [k]))
            await tx1.send(barrier(m, 1))
            await tx2.send(barrier(m, 1))
            tx1.close()
            tx2.close()
            return await m.tu.collect_until_n_barriers(merge, 1)
        out = run(go())
        data = sorted(r for x in out if m.msg.is_chunk(x)
                      for _op, r in x.to_records())
        return m.msg.is_barrier(out[-1]), data
    last_is_barrier, data = both(f)
    assert last_is_barrier and len(data) == 10


def test_merge_executors_align_and_coalesce_executor_inputs_matches_reference():
    """MergeExecutors (executor inputs): rows of each epoch in dense
    chunks before its aligned barrier, the min watermark held to the
    flush."""
    def f(m):
        a = m.tu.MockSource(schema(m), [
            barrier(m, 1), chunk(m, [1], [1]), wm(m, 30),
            chunk(m, [2], [2]), barrier(m, 2), chunk(m, [3], [3]),
            barrier(m, 3)])
        b = m.tu.MockSource(schema(m), [
            barrier(m, 1), chunk(m, [10], [1]), wm(m, 20), barrier(m, 2),
            barrier(m, 3)])
        merge = m.merge.MergeExecutors(
            m.executor.ExecutorInfo(schema(m), [], "Merge"), [a, b],
            coalesce_rows=1 << 20)
        out = run(m.tu.collect_until_n_barriers(merge, 3))
        return [(x[0], sorted(x[1]), x[2]) if x[0] == "C" else x
                for x in (desc(m, y) for y in out)]
    out = both(f)
    assert [x[0] for x in out] == ["B", "C", "W", "B", "C", "B"]
    assert out[1][2] == 3 and out[2][2] == 20


# -- exchange credit (tests/test_coalesce.py:372) -----------------------------------

def test_exchange_credit_charges_true_cardinality_matches_reference():
    """A compacted 2-row chunk costs 2 permits, not its capacity: 8 fit a
    16-permit channel whose capacity-costed chunks (8 each) would block
    after 2."""
    def f(m):
        async def go():
            tx, rx = m.ex.channel(chunk_permits=16, barrier_permits=2,
                                  max_chunk_cost=8)
            dense = m.co.compact(chunk(m, [1, 2], [1, 2], capacity=64))
            assert dense.dense_rows == 2
            for _ in range(8):
                await asyncio.wait_for(tx.send(dense), 1.0)
            blocked = asyncio.ensure_future(tx.send(dense))
            await asyncio.sleep(0.01)
            was_blocked = not blocked.done()
            await rx.recv()
            await asyncio.wait_for(blocked, 1.0)
            return was_blocked
        return run(go())
    assert both(f) is True


def test_exchange_credit_without_dense_rows_still_charges_capacity():
    """A chunk whose visible rows are not established pays its capacity
    (capped): two fill the channel."""
    def f(m):
        async def go():
            tx, rx = m.ex.channel(chunk_permits=16, barrier_permits=2,
                                  max_chunk_cost=8)
            sparse = chunk(m, [1, 2], [1, 2], capacity=64)
            for _ in range(2):
                await asyncio.wait_for(tx.send(sparse), 1.0)
            blocked = asyncio.ensure_future(tx.send(sparse))
            await asyncio.sleep(0.01)
            was_blocked = not blocked.done()
            await rx.recv()
            await asyncio.wait_for(blocked, 1.0)
            return was_blocked
        return run(go())
    assert both(f) is True


# -- q7 with coalescing on vs off (tests/test_coalesce.py:436) ----------------------

def _run_q7(pkg, coalesce_rows, fusion=False):
    if pkg == "ref":
        from risingwave_tpu.common.types import Interval
        from risingwave_tpu.connectors.nexmark import NexmarkConfig
        from risingwave_tpu.models.nexmark import (
            build_q7, drive_to_completion,
        )
        from risingwave_tpu.state.store import MemoryStateStore
        from risingwave_tpu.utils.metrics import STREAMING
        kw = {}
    else:
        from risingwave_tpu_torch.common.types import Interval
        from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
        from risingwave_tpu_torch.models.nexmark import (
            build_q7, drive_to_completion,
        )
        from risingwave_tpu_torch.state.store import MemoryStateStore
        from risingwave_tpu_torch.utils.metrics import STREAMING
        kw = dict(device="cpu")

    def steps():
        return sum(v for _l, v in STREAMING.device_dispatch.series())
    cfg = NexmarkConfig(event_num=4000, max_chunk_size=128,
                        generate_strings=False)
    p = build_q7(MemoryStateStore(), cfg, rate_limit=8, min_chunks=8,
                 watermark_delay=Interval(usecs=0),
                 coalesce_rows=coalesce_rows, fusion=fusion, **kw)
    before = steps()
    asyncio.run(drive_to_completion(p, {1: 4000 * 46 // 50}, in_flight=1))
    rows = sorted(tuple(r) for _pk, r in p.mv_table.iter_rows())
    return rows, steps() - before, p


def _agg_of(p):
    """The agg under the materialize (the reference may wrap executors in
    monitors)."""
    node = p.actor.consumer
    while not type(node).__name__.startswith("HashAggExecutor"):
        node = getattr(node, "inner", None) or node.input
    return node


def test_q7_oracle_identical_with_coalescing_on_vs_off_matches_reference():
    rows_off, steps_off, _p = _run_q7("port", None)
    rows_on, steps_on, p = _run_q7("port", 2048)
    ref_on, ref_steps_on, _rp = _run_q7("ref", 2048)
    ref_off, ref_steps_off, _rp2 = _run_q7("ref", None)
    from risingwave_tpu_torch.stream.coalesce import CoalesceExecutor
    assert isinstance(p.actor.consumer.input.input, CoalesceExecutor)
    assert rows_on == rows_off == ref_on == ref_off
    assert rows_on
    # 128-row source chunks coalesce toward 2048-row batches: materially
    # fewer device steps, counted as the reference counts them
    assert steps_on <= steps_off * 0.75, (steps_on, steps_off)
    assert (steps_on, steps_off) == (ref_steps_on, ref_steps_off)


def test_q7_coalesced_and_fused_absorbs_the_coalescer_matches_reference():
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    set_strict_checker(True)
    try:
        rows, steps, p = _run_q7("port", 2048, fusion=True)
    finally:
        set_strict_checker(False)
    ref_rows, ref_steps, rp = _run_q7("ref", 2048, fusion=True)
    plain, _s, _p = _run_q7("port", None)
    agg, ref_agg = p.actor.consumer.input, _agg_of(rp)
    for a in (agg, ref_agg):
        assert a.fused_stages is not None
        assert a.fused_stages.describe() == "ProjectExecutor"
        assert "Coalesce" not in type(a.input).__name__
    assert rows == ref_rows == plain
    assert steps == ref_steps


# -- device_dispatch means in the port what it means in the reference --------------

def _dispatch_run(pkg, pipeline, eight_devices):
    """One small pipeline in one package: (MV rows, device_dispatch
    counted during the drive)."""
    if pkg == "ref":
        import risingwave_tpu.connectors.nexmark as nx
        import risingwave_tpu.models.nexmark as models
        from risingwave_tpu.common.types import Interval
        from risingwave_tpu.state.store import MemoryStateStore
        from risingwave_tpu.utils.metrics import STREAMING
        kw = {}
        if "mesh" in pipeline:
            from jax.sharding import Mesh
            kw["mesh"] = Mesh(np.asarray(eight_devices), ("d",))
    else:
        import risingwave_tpu_torch.connectors.nexmark as nx
        import risingwave_tpu_torch.models.nexmark as models
        from risingwave_tpu_torch.common.types import Interval
        from risingwave_tpu_torch.parallel import ShardMesh
        from risingwave_tpu_torch.state.store import MemoryStateStore
        from risingwave_tpu_torch.utils.metrics import STREAMING
        kw = dict(device="cpu")
        if "mesh" in pipeline:
            kw["mesh"] = ShardMesh(8, "cpu")
    fusion = "fused" in pipeline
    base = dict(event_num=4000, max_chunk_size=128, generate_strings=False)
    if pipeline.startswith("q8"):
        p = models.build_q8(
            MemoryStateStore(),
            nx.NexmarkConfig(**base, table_type="person"),
            nx.NexmarkConfig(**base, table_type="auction"),
            rate_limit=8, min_chunks=8, fusion=fusion, **kw)
        targets = {1: 4000 // 50, 2: 4000 * 3 // 50}
    elif pipeline.startswith("q1"):
        p = models.build_q1(MemoryStateStore(), nx.NexmarkConfig(**base),
                            rate_limit=8, min_chunks=8, fusion=fusion,
                            **kw)
        targets = {1: 4000 * 46 // 50}
    else:
        p = models.build_q7(MemoryStateStore(), nx.NexmarkConfig(**base),
                            rate_limit=8, min_chunks=8,
                            watermark_delay=Interval(usecs=0),
                            coalesce_rows=512, fusion=fusion, **kw)
        targets = {1: 4000 * 46 // 50}
    before = sum(v for _l, v in STREAMING.device_dispatch.series())
    asyncio.run(models.drive_to_completion(p, targets, in_flight=1))
    after = sum(v for _l, v in STREAMING.device_dispatch.series())
    # q1's last column is its generated _row_id, which carries the epoch
    # (the wall clock): the rows compare without it
    cut = -1 if pipeline.startswith("q1") else None
    rows = sorted(tuple(r)[:cut] for _pk, r in p.mv_table.iter_rows())
    return rows, after - before


@pytest.mark.parametrize("pipeline", [
    "q8", "q8 fused", "q1 fused", "q7 mesh coalesced",
    "q7 mesh fused coalesced", "q8 mesh"])
def test_device_dispatch_counts_match_reference(pipeline, eight_devices):
    """The counter's sites: the join's two steps a side-epoch, the fused
    agg's backlog steps, the fused chain's steps, the sharded kernels'
    routed steps and gathers, each counted as the reference counts it."""
    from risingwave_tpu_torch.frontend.opt import set_strict_checker
    set_strict_checker(True)
    try:
        rows, steps = _dispatch_run("port", pipeline, eight_devices)
    finally:
        set_strict_checker(False)
    ref_rows, ref_steps = _dispatch_run("ref", pipeline, eight_devices)
    assert rows == ref_rows and rows
    assert steps == ref_steps > 0, (steps, ref_steps)
