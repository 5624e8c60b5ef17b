"""Dispatchers, the actor's dispatch loop, and the source executor's
barrier protocol in the port, against the reference.

- Twins of ``tests/test_stream_spine.py:183`` and :205 (hash dispatch is
  exhaustive and consistent; an update pair split across outputs
  degrades to Delete/Insert) and ``tests/test_coalesce.py:332`` and :355
  (slices arrive compacted; empty slices are not sent). The port's row
  routing equals the reference's, and its vnodes are the ones K1's row
  hash (B1, ``hash_columns``) gives.
- The cases of ``tests/test_nexmark.py`` no port test twinned before:
  :141 (the barrier-select protocol), :181 (a restarted source resumes at
  its committed offset) and :227 (``BarrierLoop.run`` on the wall
  clock), each run through both packages.
- An actor with a broadcast dispatcher and zero, one and two outputs:
  every output receives every chunk, watermark and barrier, the barrier
  is collected after it left the dispatchers, an output attached between
  barriers sees the stream from there on, and the dispatchers close when
  the actor stops.
"""

import asyncio

import numpy as np
import pytest
import torch

from risingwave_tpu.stream.dispatch import HashDispatcher as RefHash
from risingwave_tpu.stream.dispatch import Output as RefOutput
from risingwave_tpu.stream.exchange import channel_for_test as ref_channel
from risingwave_tpu_torch.common.chunk import Op, StreamChunk
from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
from risingwave_tpu_torch.common.hash import VnodeMapping, vnodes_of
from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.stream.actor import Actor, LocalBarrierManager
from risingwave_tpu_torch.stream.dispatch import (
    BroadcastDispatcher, HashDispatcher, Output, RoundRobinDispatcher,
    SimpleDispatcher,
)
from risingwave_tpu_torch.stream.exchange import (
    ChannelClosed, channel_for_test,
)
from risingwave_tpu_torch.stream.executor import ExecutorInfo
from risingwave_tpu_torch.stream.executors import ReceiverExecutor
from risingwave_tpu_torch.stream.message import (
    Barrier, BarrierKind, StopMutation, Watermark, is_barrier, is_chunk,
    is_watermark,
)

SCHEMA = Schema.of(k=DataType.INT64, v=DataType.INT64)


def barrier(n, mutation=None):
    prev = Epoch.from_physical(n - 1) if n > 1 else Epoch.INVALID
    return Barrier(EpochPair(Epoch.from_physical(n), prev),
                   BarrierKind.CHECKPOINT, mutation)


def chunk(ks, vs, ops=None, capacity=None):
    return StreamChunk.from_pydict(SCHEMA, {"k": ks, "v": vs}, ops=ops,
                                   capacity=capacity)


def ref_chunk(ks, vs, ops=None, capacity=None):
    from risingwave_tpu.common.chunk import StreamChunk as RC
    from risingwave_tpu.common.types import DataType as RD
    from risingwave_tpu.common.types import Schema as RS
    return RC.from_pydict(RS.of(k=RD.INT64, v=RD.INT64),
                          {"k": ks, "v": vs}, ops=ops, capacity=capacity)


def _hash(n_out, key_lists):
    """Port and reference hash dispatchers over n_out fresh channels."""
    pc = [channel_for_test() for _ in range(n_out)]
    rc = [ref_channel() for _ in range(n_out)]
    port = HashDispatcher([Output(i, tx) for i, (tx, _) in enumerate(pc)],
                          dist_key_indices=[0])
    ref = RefHash([RefOutput(i, tx) for i, (tx, _) in enumerate(rc)],
                  dist_key_indices=[0])
    for ks in key_lists:
        owner = port._route(chunk(ks, [0] * len(ks)))
        assert owner.tolist() == \
            ref._route(ref_chunk(ks, [0] * len(ks))).tolist()
        # the vnode is K1's row hash (B1) masked to 256
        vn = vnodes_of([torch.tensor(ks, dtype=torch.int64)]).numpy()
        assert owner[:len(ks)].tolist() == \
            np.asarray(port.mapping.owners)[vn].tolist()
    return port, pc


def test_hash_dispatch_partition_is_exhaustive_and_consistent_twin():
    """tests/test_stream_spine.py:183"""
    async def go():
        ks = list(range(40)) * 2      # duplicate keys route identically
        disp, chans = _hash(3, [ks])
        await disp.dispatch_data(chunk(ks, [i * 10 for i in range(80)]))
        seen, total = {}, 0
        for i, (_, rx) in enumerate(chans):
            recs = (await rx.recv()).to_records()
            total += len(recs)
            for _, (k, _v) in recs:
                assert seen.setdefault(k, i) == i
        assert total == 80
    asyncio.run(go())


def test_hash_dispatch_update_pair_degraded_across_outputs_twin():
    """tests/test_stream_spine.py:205"""
    async def go():
        disp, chans = _hash(2, [list(range(16))])
        owner = disp._route(chunk(list(range(16)), [0] * 16))
        k_b = next(k for k in range(1, 16) if owner[k] != owner[0])
        await disp.dispatch_data(chunk(
            [0, k_b], [1, 2], ops=[Op.UPDATE_DELETE, Op.UPDATE_INSERT]))
        recs = []
        for _, rx in chans:
            recs += (await rx.recv()).to_records()
        assert sorted(op for op, _ in recs) == [Op.INSERT, Op.DELETE]
        # a pair that stays on one output stays a pair
        k_c = next(k for k in range(1, 16) if owner[k] == owner[0])
        await disp.dispatch_data(chunk(
            [0, k_c], [1, 2], ops=[Op.UPDATE_DELETE, Op.UPDATE_INSERT]))
        got = (await chans[int(owner[0])][1].recv()).to_records()
        assert [op for op, _ in got] == [Op.UPDATE_DELETE,
                                         Op.UPDATE_INSERT]
    asyncio.run(go())


def test_hash_dispatch_slices_arrive_compacted_twin():
    """tests/test_coalesce.py:332"""
    async def go():
        ks = list(range(64))
        disp, chans = _hash(4, [ks])
        await disp.dispatch_data(chunk(ks, [i * 10 for i in ks],
                                       capacity=1024))
        total, seen = 0, {}
        for i, (_tx, rx) in enumerate(chans):
            sub = await rx.recv()
            assert sub.dense_rows == sub.cardinality() > 0
            assert sub.capacity < 1024
            total += sub.dense_rows
            for _, (k, _v) in sub.to_records():
                assert seen.setdefault(k, i) == i
        assert total == 64
    asyncio.run(go())


def test_hash_dispatch_suppresses_empty_slices_twin():
    """tests/test_coalesce.py:355"""
    async def go():
        disp, chans = _hash(2, [list(range(32))])
        owner = disp._route(chunk(list(range(32)), [0] * 32))
        mine = [k for k in range(32) if owner[k] == 0][:4]
        await disp.dispatch_data(chunk(mine, [1] * len(mine)))
        assert (await chans[0][1].recv()).dense_rows == len(mine)
        assert chans[1][1].try_recv() is None
    asyncio.run(go())


def test_vnode_mapping_matches_reference():
    from risingwave_tpu.common.hash import VnodeMapping as RefMapping
    for n, m in [(1, 3), (3, 4), (4, 3), (7, 2), (5, 5)]:
        a = VnodeMapping.new_uniform(n).rebalance(m)
        b = RefMapping.new_uniform(n).rebalance(m)
        assert a.owners.tolist() == b.owners.tolist()
        assert a.num_owners() == m and a.bitmap_of(0).sum() > 0


def test_simple_and_round_robin_dispatchers():
    async def go():
        (tx, rx), (tx2, rx2) = channel_for_test(), channel_for_test()
        s = SimpleDispatcher(Output(1, tx))
        await s.dispatch_data(chunk([1], [1]).with_visibility(
            np.zeros(8, bool)))                     # empty: not sent
        await s.dispatch_data(chunk([2], [2]))
        assert (await rx.recv()).to_records()[0][1] == (2, 2)
        rr = RoundRobinDispatcher([Output(1, tx), Output(2, tx2)])
        for k in range(4):
            await rr.dispatch_data(chunk([k], [k]))
        await rr.dispatch_barrier(barrier(1))
        a = [(await rx.recv()).to_records()[0][1][0] for _ in range(2)]
        b = [(await rx2.recv()).to_records()[0][1][0] for _ in range(2)]
        assert (a, b) == ([0, 2], [1, 3])
        assert is_barrier(await rx.recv()) and is_barrier(await rx2.recv())
    asyncio.run(go())


# -- an actor with a broadcast dispatcher ---------------------------------


@pytest.mark.parametrize("n_out", [0, 1, 2])
def test_actor_with_broadcast_dispatcher(n_out):
    async def go():
        mgr = LocalBarrierManager()
        tx, rx = channel_for_test()
        src = ReceiverExecutor(ExecutorInfo(SCHEMA, [], "Recv"), rx,
                               actor_id=7)
        chans = [channel_for_test() for _ in range(n_out)]
        disp = BroadcastDispatcher([Output(100 + i, c[0])
                                    for i, c in enumerate(chans)])
        actor = Actor(7, src, [disp], barrier_manager=mgr)
        mgr.register_sender(7, tx)
        mgr.set_expected_actors([7])
        task = actor.spawn()
        wm = Watermark(0, DataType.INT64, 5)
        for m in (barrier(1), chunk([1, 2], [10, 20]), wm, barrier(2)):
            await tx.send(m)
        await mgr.await_epoch_complete(Epoch.from_physical(2).value)
        # attach an output between barriers: it sees the stream from
        # the next message on
        late_tx, late_rx = channel_for_test()
        disp.update_outputs(disp.outputs() + [Output(200, late_tx)])
        await tx.send(chunk([3], [30]))
        await tx.send(barrier(3, StopMutation(frozenset({7}))))
        await asyncio.wait_for(task, 5)
        assert actor.failure is None
        for _tx, orx in chans:
            kinds = []
            while True:
                try:
                    m = await orx.recv()
                except ChannelClosed:
                    break
                kinds.append("B" if is_barrier(m) else
                             "W" if is_watermark(m) else "C")
                if is_chunk(m):
                    assert m.cardinality() in (1, 2)
            assert kinds == ["B", "C", "W", "B", "C", "B"]
        late = []
        while True:
            try:
                late.append(await late_rx.recv())
            except ChannelClosed:
                break
        assert is_chunk(late[0]) and late[0].to_records()[0][1] == (3, 30)
        assert is_barrier(late[1]) and len(late) == 2
    asyncio.run(go())


# -- tests/test_nexmark.py twins ------------------------------------------


def _pkg(pkg):
    """The modules of one package the source tests drive."""
    import importlib
    base = {"ref": "risingwave_tpu", "port": "risingwave_tpu_torch"}[pkg]
    mods = {}
    for name in ("common.types", "connectors.nexmark", "meta.barrier",
                 "state.state_table", "state.store", "stream.actor",
                 "stream.exchange", "stream.executors.source",
                 "stream.message"):
        mods[name.rsplit(".", 1)[-1]] = importlib.import_module(
            f"{base}.{name}")
    return mods


def _source_setup(m, store, event_num=50 * 1000, max_chunk=512):
    T = m["types"]
    cfg = m["nexmark"].NexmarkConfig(event_num=event_num,
                                     max_chunk_size=max_chunk)
    reader = m["nexmark"].NexmarkSplitReader(cfg)
    barrier_tx, barrier_rx = m["exchange"].channel_for_test()
    split_state = m["state_table"].StateTable(
        77, T.Schema([T.Field("split_id", T.DataType.VARCHAR),
                      T.Field("offset", T.DataType.INT64)]), [0], store)
    src = m["source"].SourceExecutor(reader, barrier_rx, split_state,
                                     actor_id=1)
    return src, barrier_tx, reader


async def _drive(m, store, n_barriers, max_chunk, rows=None):
    src, barrier_tx, reader = _source_setup(m, store, max_chunk=max_chunk)
    local = m["actor"].LocalBarrierManager()
    local.register_sender(1, barrier_tx)
    local.set_expected_actors([1])
    loop = m["barrier"].BarrierLoop(local, store)
    kinds = []

    async def drain():
        seen = 0
        async for msg in src.execute():
            if m["message"].is_chunk(msg):
                kinds.append("C")
                if rows is not None:
                    rows.extend(msg.to_pylist())
            elif m["message"].is_barrier(msg):
                kinds.append("B")
                local.collect(1, msg)
                seen += 1
                if seen >= n_barriers:
                    return

    task = asyncio.ensure_future(drain())
    for _ in range(n_barriers):
        await loop.inject_and_collect()
    await task
    return kinds, reader.offset, store.committed_epoch()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_source_barrier_protocol_twin(pkg):
    """tests/test_nexmark.py:141"""
    m = _pkg(pkg)
    kinds, offset, committed = asyncio.run(
        _drive(m, m["store"].MemoryStateStore(), 4, 512))
    assert kinds[0] == "B" and kinds.count("B") == 4 and "C" in kinds
    assert offset > 0 and committed > 0


def test_source_recovery_resumes_from_committed_offset_twin():
    """tests/test_nexmark.py:181 — run through both packages: a second
    executor over the same store resumes at the committed offset, and the
    rows of both phases are the generator's straight-through rows."""
    for pkg in ("ref", "port"):
        m = _pkg(pkg)

        async def main():
            store = m["store"].MemoryStateStore()
            rows1, rows2 = [], []
            await _drive(m, store, 3, 128, rows1)
            await _drive(m, store, 3, 128, rows2)
            return rows1 + rows2
        all_rows = asyncio.run(main())
        ref = m["nexmark"].NexmarkSplitReader(
            m["nexmark"].NexmarkConfig(max_chunk_size=128))
        expect = []
        while len(expect) < len(all_rows):
            expect.extend(ref.next_chunk().to_pylist())
        assert all_rows and all_rows == expect[:len(all_rows)]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_barrier_loop_run_background_twin(pkg):
    """tests/test_nexmark.py:227 — six barriers on a 1 ms tick, one
    checkpoint every second barrier."""
    m = _pkg(pkg)

    async def main():
        store = m["store"].MemoryStateStore()
        src, barrier_tx, _ = _source_setup(m, store, max_chunk=64)
        local = m["actor"].LocalBarrierManager()
        local.register_sender(1, barrier_tx)
        local.set_expected_actors([1])
        loop = m["barrier"].BarrierLoop(local, store, interval_ms=1,
                                        checkpoint_frequency=2)

        async def drain():
            async for msg in src.execute():
                if m["message"].is_barrier(msg):
                    local.collect(1, msg)
                    if msg.is_stop(1):
                        return

        drain_task = asyncio.ensure_future(drain())
        await loop.run(stop_after=6)
        drain_task.cancel()
        assert len(loop.stats.completed_epochs) == 6
        assert store.committed_epoch() > 0
        assert loop.stats.p99_latency_s() >= 0
    asyncio.run(main())
