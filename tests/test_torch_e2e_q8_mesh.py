"""The vnode-sharded join end to end on the PyTorch port, against the JAX
reference's mesh join and oracles, on the CPU (every kernel's plain
version).

``HashJoinExecutor(mesh=ShardMesh(n, "cpu"))`` runs both sides on the
sharded matcher (``parallel/join.ShardedJoinKernel``); the reference runs
``mesh=Mesh(devices)`` on the CPU mesh that tests/conftest.py sets up.
The emitted message streams must equal the reference's record for record
and the oracle's view:

- the INNER cases of ``tests/test_multichip_join_exec.py`` (:84 random
  oracle, :233 growth past the initial capacity, and an inner version of
  :125's kill-and-rebuild);
- the INNER case of ``tests/test_sharded_epoch.py:144``: the epoch arm
  equals the per-chunk arm (``epoch_batch=False``, one apply_and_probe
  per chunk) epoch by epoch, and both equal the oracle;
- ``build_q8(mesh=ShardMesh(8, "cpu"))``, unfused and fused, against the
  reference's ``build_q8(mesh=Mesh(...))``, the single-device port and
  the oracle: MV rows and both join state tables;
- a fused join side over 4 shards fed U-/U+ pairs, one across a
  shard-block edge: the reference's records, state rows and per-shard
  state, and the join prelude's output is the same with or without
  block segments (it is per row);
- the INNER cases of ``tests/test_join_payload.py:119`` and :128
  (``device_payload`` on vs off on one device: bit-identical emits);
- the fusion rule, its adopt guard and the checker refuse a per-chunk
  join.
"""

import asyncio
from collections import Counter

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from risingwave_tpu.common import chunk as ref_chunk
from risingwave_tpu.common import epoch as ref_epoch
from risingwave_tpu.common import types as ref_types
from risingwave_tpu.connectors.nexmark import NexmarkConfig as RefConfig
from risingwave_tpu.expr import expr as ref_expr
from risingwave_tpu.frontend.opt import rewrite_stream_plan as ref_rewrite
from risingwave_tpu.models import nexmark as ref_models
from risingwave_tpu.parallel.join import ShardedJoinKernel as RefKernel
from risingwave_tpu.state.state_table import StateTable as RefStateTable
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream import message as ref_msg
from risingwave_tpu.stream.executors import hash_join as ref_hj
from risingwave_tpu.stream.executors import simple as ref_simple
from risingwave_tpu.stream.executors import test_utils as ref_utils
from risingwave_tpu_torch.common import chunk as port_chunk
from risingwave_tpu_torch.common import epoch as port_epoch
from risingwave_tpu_torch.common import types as port_types
from risingwave_tpu_torch.connectors.nexmark import NexmarkConfig
from risingwave_tpu_torch.expr import expr as port_expr
from risingwave_tpu_torch.frontend.opt import (
    rewrite_stream_plan, set_strict_checker,
)
from risingwave_tpu_torch.frontend.opt import checker as port_checker
from risingwave_tpu_torch.frontend.opt.fusion import (
    join_side_ineligible_reason,
)
from risingwave_tpu_torch.models.nexmark import build_q8, drive_to_completion
from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
from risingwave_tpu_torch.state.state_table import StateTable
from risingwave_tpu_torch.state.store import MemoryStateStore
from risingwave_tpu_torch.stream import message as port_msg
from risingwave_tpu_torch.stream.executors import hash_join as port_hj
from risingwave_tpu_torch.stream.executors import simple as port_simple
from risingwave_tpu_torch.stream.executors import test_utils as port_utils
from tests.test_torch_e2e_q8 import q8_oracle

torch.set_num_threads(2)

PKG = {
    "port": dict(types=port_types, epoch=port_epoch, msg=port_msg,
                 chunk=port_chunk, expr=port_expr, simple=port_simple,
                 hj=port_hj, utils=port_utils, Table=StateTable,
                 Store=MemoryStateStore),
    "ref": dict(types=ref_types, epoch=ref_epoch, msg=ref_msg,
                chunk=ref_chunk, expr=ref_expr, simple=ref_simple,
                hj=ref_hj, utils=ref_utils, Table=RefStateTable,
                Store=RefStore),
}
LR = ({"lk": "INT64", "lv": "INT64"}, {"rk": "INT64", "rv": "VARCHAR"})
# test_join_payload.py's schemas: a varchar and a float64 payload column
PAY = ({"lk": "INT64", "lv": "INT64", "ls": "VARCHAR", "lf": "FLOAT64"},
       {"rk": "INT64", "rv": "INT64", "rs": "VARCHAR"})


@pytest.fixture(autouse=True)
def _strict_port_checker():
    set_strict_checker(True)
    yield
    set_strict_checker(False)


def _mesh(pkg, devs, n):
    if n is None:
        return None
    return ShardMesh(n, "cpu") if pkg == "port" else \
        Mesh(np.asarray(devs[:n]), ("d",))


def _schema(m, spec):
    dt = m["types"].DataType
    return m["types"].Schema.of(**{k: getattr(dt, v)
                                   for k, v in spec.items()})


def _messages(m, schema, events):
    """('b', n) | (column dict, ops) → the package's messages."""
    out = []
    for e in events:
        if e[0] == "b":
            ep = m["epoch"]
            prev = ep.Epoch.from_physical(e[1] - 1) if e[1] > 1 \
                else ep.Epoch.INVALID
            out.append(m["msg"].Barrier(
                ep.EpochPair(ep.Epoch.from_physical(e[1]), prev),
                m["msg"].BarrierKind.CHECKPOINT))
        else:
            out.append(m["chunk"].StreamChunk.from_pydict(schema, e[0],
                                                          ops=e[1]))
    return out


def run_join(pkg, events_l, events_r, n_barriers, devs=None, n_shards=8,
             store=None, schemas=LR, pks=([1], [1]), **kw):
    """One package's join over the scripted streams: (records, executor,
    state rows). Records keep the message stream's shape: one list of
    (op, row) per chunk, and "b" per barrier."""
    m = PKG[pkg]
    store = store or m["Store"]()
    ls, rs = _schema(m, schemas[0]), _schema(m, schemas[1])
    lt = m["Table"](21, ls, pks[0], store, dist_key_indices=[])
    rt = m["Table"](22, rs, pks[1], store, dist_key_indices=[])
    if pkg == "port":
        kw["device"] = "cpu"
    if "mesh" not in kw:
        kw["mesh"] = _mesh(pkg, devs, n_shards)
    ex = m["hj"].HashJoinExecutor(
        m["utils"].MockSource(ls, _messages(m, ls, events_l)),
        m["utils"].MockSource(rs, _messages(m, rs, events_r)),
        left_keys=[0], right_keys=[0], left_table=lt, right_table=rt, **kw)
    msgs = asyncio.run(m["utils"].collect_until_n_barriers(ex, n_barriers))
    records = []
    for msg in msgs:
        if hasattr(msg, "to_records"):
            records.append([(int(op), tuple(row))
                            for op, row in msg.to_records()])
        elif m["msg"].is_barrier(msg):
            records.append("b")
    return records, ex, (list(lt.iter_rows()), list(rt.iter_rows()))


def materialize(records) -> Counter:
    view = Counter()
    for rec in records:
        if rec == "b":
            continue
        for op, row in rec:
            view[row] += 1 if op in (1, 4) else -1    # Insert, U+
            assert view[row] >= 0, f"negative count for {row}"
    return +view


def per_epoch(records) -> list:
    """One Counter of (op sign, row) per epoch: what the epoch arm must
    keep (chunk boundaries inside an epoch may differ)."""
    out, cur = [], Counter()
    for rec in records:
        if rec == "b":
            out.append(cur)
            cur = Counter()
            continue
        for op, row in rec:
            cur[(op in (1, 4), row)] += 1
    return out


def oracle_view(live_l, live_r) -> Counter:
    out = Counter()
    for lk, lv in live_l:
        for rk, rv in live_r:
            if lk is not None and lk == rk:
                out[(lk, lv, rk, rv)] += 1
    return out


def _lc(ks, vs, ops):
    return ({"lk": ks, "lv": vs}, ops)


def _rc(ks, vs, ops):
    return ({"rk": ks, "rv": vs}, ops)


def _random_scripts(seed):
    """``test_multichip_join_exec.py:53``: inserts and deletes of live
    rows on both sides, 5 epochs."""
    rng = np.random.default_rng(seed)
    live_l, live_r = [], []
    sl, sr = [("b", 1)], [("b", 1)]
    lpk = rpk = 0
    b = 2
    for _ in range(5):
        for side, live, n, mk in ((0, live_l, 24, _lc), (1, live_r, 16, _rc)):
            ks, vs, ops = [], [], []
            for _ in range(n):
                if live and rng.random() < 0.3:
                    k_, v_ = live.pop(int(rng.integers(0, len(live))))
                    ks.append(k_)
                    vs.append(v_)
                    ops.append(2)                          # Delete
                else:
                    k_ = int(rng.integers(0, 8))
                    if side == 0:
                        v_, lpk = lpk, lpk + 1
                    else:
                        v_, rpk = f"r{rpk}", rpk + 1
                    live.append((k_, v_))
                    ks.append(k_)
                    vs.append(v_)
                    ops.append(1)                          # Insert
            (sl if side == 0 else sr).append(mk(ks, vs, ops))
        sl.append(("b", b))
        sr.append(("b", b))
        b += 1
    return sl, sr, b - 1, oracle_view(live_l, live_r)


def _epoch_scripts(seed, epochs=4, per_chunk=12, chunks_per_epoch=3):
    """``test_sharded_epoch.py:84``: several chunks per epoch, NULL keys,
    deletes of live rows and same-pk update pairs."""
    rng = np.random.default_rng(seed)
    sl, sr = [("b", 1)], [("b", 1)]
    live_l, live_r = [], []
    lpk = rpk = 0
    b = 2
    for _e in range(epochs):
        for _c in range(chunks_per_epoch):
            ks, vs, ops = [], [], []
            for _ in range(per_chunk):
                r = rng.random()
                if live_l and r < 0.2:
                    k_, v_ = live_l.pop(int(rng.integers(0, len(live_l))))
                    ks.append(k_)
                    vs.append(v_)
                    ops.append(2)
                elif live_l and r < 0.35:
                    k_, v_ = live_l.pop(int(rng.integers(0, len(live_l))))
                    k2 = int(rng.integers(0, 7))
                    ks.extend([k_, k2])
                    vs.extend([v_, v_])
                    ops.extend([3, 4])                     # U-, U+
                    live_l.append((k2, v_))
                else:
                    k_ = None if r > 0.9 else int(rng.integers(0, 7))
                    live_l.append((k_, lpk))
                    ks.append(k_)
                    vs.append(lpk)
                    ops.append(1)
                    lpk += 1
            sl.append(_lc(ks, vs, ops))
            ks, vs, ops = [], [], []
            for _ in range(per_chunk // 2):
                r = rng.random()
                if live_r and r < 0.25:
                    k_, v_ = live_r.pop(int(rng.integers(0, len(live_r))))
                    ks.append(k_)
                    vs.append(v_)
                    ops.append(2)
                else:
                    k_ = None if r > 0.9 else int(rng.integers(0, 7))
                    v_ = f"r{rpk}"
                    live_r.append((k_, v_))
                    ks.append(k_)
                    vs.append(v_)
                    ops.append(1)
                    rpk += 1
            sr.append(_rc(ks, vs, ops))
        sl.append(("b", b))
        sr.append(("b", b))
        b += 1
    return sl, sr, b - 1, oracle_view(live_l, live_r)


# -- the executor over the mesh -----------------------------------------------

def test_mesh_join_random_oracle(eight_devices):
    """``test_multichip_join_exec.py:84``."""
    sl, sr, nb, want = _random_scripts(23)
    rec, ex, state = run_join("port", sl, sr, nb)
    ref_rec, _rx, ref_state = run_join("ref", sl, sr, nb, eight_devices)
    assert isinstance(ex.sides[0].kernel, ShardedJoinKernel)
    assert rec == ref_rec and state == ref_state
    assert materialize(rec) == want and len(want) > 10


def test_mesh_join_grows_past_initial_capacity(eight_devices):
    """``test_multichip_join_exec.py:233``: 10x the initial key capacity
    of 128; the tables grow, the results stay the oracle's."""
    sl, sr = [("b", 1)], [("b", 1)]
    left, right = [], []
    for r in range(10):
        ks = list(range(r * 128, (r + 1) * 128))
        left += list(zip(ks, ks))
        sl += [_lc(ks, ks, None), ("b", r + 2)]
        rk = ks[:4]
        rv = [f"r{x}" for x in rk]
        right += list(zip(rk, rv))
        sr += [_rc(rk, rv, None), ("b", r + 2)]
    opts = dict(shard_opts=dict(key_capacity=128, row_capacity=1 << 12,
                                probe_capacity=256))
    rec, ex, state = run_join("port", sl, sr, 11, **opts)
    ref_rec, rx, ref_state = run_join("ref", sl, sr, 11, eight_devices,
                                      **opts)
    assert ex.sides[0].kernel.key_capacity > 128
    assert ex.sides[0].kernel.key_capacity == rx.sides[0].kernel.key_capacity
    assert rec == ref_rec and state == ref_state
    assert materialize(rec) == oracle_view(left, right)


def test_mesh_join_compaction_matches_reference(eight_devices, monkeypatch):
    """Compaction forced at every barrier (the dead-ref thresholds
    lowered in both packages): each side rebuilds its sharded kernel from
    the live rows (one routed insert at seq 0), and the streams stay the
    reference's and the oracle's."""
    for mod in (port_hj, ref_hj):
        monkeypatch.setattr(mod._JoinSide, "COMPACT_MIN_REFS", 16)
        monkeypatch.setattr(mod._JoinSide, "COMPACT_DEAD_RATIO", 0.0)
    sl, sr, nb, want = _random_scripts(7)
    rec, ex, state = run_join("port", sl, sr, nb)
    ref_rec, rx, ref_state = run_join("ref", sl, sr, nb, eight_devices)
    assert rec == ref_rec and state == ref_state
    assert materialize(rec) == want
    side, ref_side = ex.sides[0], rx.sides[0]
    assert side.next_ref == ref_side.next_ref == len(side.pk_to_ref)
    np.testing.assert_array_equal(side.kernel.chains.next.numpy(),
                                  np.asarray(ref_side.kernel.chains.next))


def test_mesh_join_recovery_resumes(eight_devices):
    """An inner version of ``test_multichip_join_exec.py:125``: kill the
    executor, rebuild both sides from the state tables onto fresh sharded
    kernels (a routed insert), and the new rows match the recovered
    ones."""
    views = {}
    for pkg in ("port", "ref"):
        store = PKG[pkg]["Store"]()
        r1, _e, _s = run_join(pkg, [("b", 1), _lc([1, 2], [10, 20], None),
                                    ("b", 2)],
                              [("b", 1), _rc([1], ["a"], None), ("b", 2)], 2,
                              eight_devices, store=store)
        r2, ex, state = run_join(pkg, [("b", 3), _lc([2], [21], None),
                                       ("b", 4)],
                                 [("b", 3), _rc([2, 1], ["b", "c"], None),
                                  ("b", 4)], 2, eight_devices, store=store)
        views[pkg] = (r1 + r2, state)
        if pkg == "port":     # the recovered rows went through the kernel
            assert ex.sides[0].kernel.dispatches > 0
    assert views["port"] == views["ref"]
    assert materialize(views["port"][0]) == Counter({
        (1, 10, 1, "a"): 1, (1, 10, 1, "c"): 1, (2, 20, 2, "b"): 1,
        (2, 21, 2, "b"): 1})


def test_mesh_join_epoch_arm_equals_per_chunk_arm(eight_devices):
    """``test_sharded_epoch.py:144`` (INNER, 4 shards): the epoch arm and
    the per-chunk arm emit the same records epoch by epoch, both equal
    the oracle, and the epoch arm equals the reference's; the per-chunk
    arm runs one routed apply_and_probe per chunk."""
    sl, sr, nb, want = _epoch_scripts(33)
    on, ex_on, st_on = run_join("port", sl, sr, nb, n_shards=4)
    off, ex_off, st_off = run_join("port", sl, sr, nb, n_shards=4,
                                   epoch_batch=False)
    ref_on, _r, ref_st = run_join("ref", sl, sr, nb, eight_devices,
                                  n_shards=4)
    # chunk for chunk the same records; one probe row's matches may come
    # in another order (the arms link a key's rows in another order)
    assert [sorted(r) if r != "b" else r for r in on] == \
        [sorted(r) if r != "b" else r for r in off]
    assert per_epoch(on) == per_epoch(off)
    assert materialize(on) == materialize(off) == want
    assert on == ref_on and st_on == ref_st == st_off
    chunks = sum(1 for e in sl + sr if e[0] != "b")
    # per chunk: one routed step (no probe re-dispatch at this size)
    assert sum(s.kernel.dispatches for s in ex_off.sides) == chunks
    # per epoch: each side one routed apply and one routed probe
    assert sum(s.kernel.dispatches for s in ex_on.sides) == 4 * (nb - 1)


def test_mesh_join_refuses_what_is_not_ported():
    """Over 8 shards every join type builds, on both arms; the cold tier
    is refused there (ValueError, as the reference refuses it), as are a
    mesh that is not a ShardMesh, the per-chunk arm without a mesh and a
    mesh on another device."""
    for jt in port_hj.JoinType:
        for arm in (None, False):
            _r, ex, _s = run_join("port", [("b", 1)], [("b", 1)], 1,
                                  join_type=jt, epoch_batch=arm)
            assert all(isinstance(s.kernel, ShardedJoinKernel)
                       for s in ex.sides)
    for kw in (dict(state_cap=1 << 10),
               dict(state_cap=1 << 10,
                    join_type=port_hj.JoinType.FULL_OUTER)):
        with pytest.raises(ValueError):
            run_join("port", [], [], 0, **kw)
    with pytest.raises(TypeError):
        run_join("port", [], [], 0, mesh=object())
    with pytest.raises(ValueError):
        run_join("port", [], [], 0, n_shards=None, epoch_batch=False)
    with pytest.raises(ValueError):       # the mesh is on another device
        run_join("port", [], [], 0, mesh=ShardMesh(8, "meta"))


# -- device_payload on vs off (one device) ------------------------------------

def _payload_scripted():
    """``test_join_payload.py:85``'s streams."""
    inf = float("inf")
    sl = [("b", 1),
          ({"lk": [1, 2, None], "lv": [10, 20, 30], "ls": ["a", None, "c"],
            "lf": [-0.0, 1.5, inf]}, None), ("b", 2),
          ({"lk": [1, 1], "lv": [10, 11], "ls": ["a", "a2"],
            "lf": [-0.0, 2.5]}, [3, 4]), ("b", 3),
          ({"lk": [2], "lv": [20], "ls": [None], "lf": [1.5]}, [2]),
          ("b", 4)]
    sr = [("b", 1),
          ({"rk": [3, None], "rv": [90, 91], "rs": [None, "x"]}, None),
          ("b", 2), ({"rk": [1, 1], "rv": [70, 71], "rs": ["r70", "r71"]},
                     None), ("b", 3),
          ({"rk": [1], "rv": [70], "rs": ["r70"]}, [2]), ("b", 4)]
    return sl, sr, 4


def _payload_random():
    """``test_join_payload.py:128``'s stream shape: 5 epochs of 20 rows a
    side, inserts, deletes of live rows, NULL keys."""
    rng = np.random.default_rng(1001)
    rows = [[], []]
    sl, sr = [("b", 1)], [("b", 1)]
    pk = [0, 0]
    for b in range(2, 7):
        for side, script in ((0, sl), (1, sr)):
            ks, vs, ops = [], [], []
            for _ in range(20):
                if rows[side] and rng.random() < 0.3:
                    k_, v_ = rows[side].pop(int(rng.integers(
                        0, len(rows[side]))))
                    ops.append(2)
                else:
                    k_ = int(rng.integers(0, 6))
                    if rng.random() < 0.1:
                        k_ = None
                    v_ = pk[side]
                    pk[side] += 1
                    rows[side].append((k_, v_))
                    ops.append(1)
                ks.append(k_)
                vs.append(v_)
            if side == 0:
                script.append(({"lk": ks, "lv": vs,
                                "ls": [f"s{v}" for v in vs],
                                "lf": [float(v) for v in vs]}, ops))
            else:
                script.append(({"rk": ks, "rv": vs,
                                "rs": [f"r{v}" for v in vs]}, ops))
            script.append(("b", b))
    return sl, sr, 6


@pytest.mark.parametrize("streams", [_payload_scripted, _payload_random],
                         ids=["scripted", "random"])
def test_device_payload_off_emits_bit_identical(streams):
    """``test_join_payload.py:119`` and :128, INNER: the device-payload
    emit and the host-gather emit (``device_payload=False``) give the
    same message stream, and the reference's."""
    sl, sr, nb = streams()
    kw = dict(n_shards=None, schemas=PAY, pks=([0, 1], [0, 1]))
    on, ex_on, st_on = run_join("port", sl, sr, nb, **kw)
    off, ex_off, st_off = run_join("port", sl, sr, nb, device_payload=False,
                                   **kw)
    ref, _rx, ref_st = run_join("ref", sl, sr, nb, device_payload=False,
                                **kw)
    assert ex_on.sides[0].pay_indices and not ex_off.sides[0].pay_indices
    assert ex_off.sides[0].kernel.payload_width == 0
    assert sum(len(c) for c in on if c != "b") > 0
    assert on == off == ref and st_on == st_off == ref_st


# -- q8 over 8 shards ---------------------------------------------------------

def _q8_cfg(config):
    """tests/test_torch_e2e_q8.py's configuration at 20K events."""
    base = dict(event_num=20_000, max_chunk_size=256,
                min_event_gap_in_ns=50_000_000, active_people=40,
                hot_seller_ratio=2)
    return (config(**{**base, "table_type": "person"}),
            config(**{**base, "table_type": "auction"}),
            NexmarkConfig(**base))


def _q8(pkg, devs, fusion, mesh=True):
    build, drive, store, config = (
        (build_q8, drive_to_completion, MemoryStateStore(), NexmarkConfig)
        if pkg == "port" else
        (ref_models.build_q8, ref_models.drive_to_completion, RefStore(),
         RefConfig))
    cfg_p, cfg_a, _c = _q8_cfg(config)
    kw = dict(device="cpu") if pkg == "port" else {}
    if mesh:
        kw["mesh"] = _mesh(pkg, devs, 8)
    p = build(store, cfg_p, cfg_a, rate_limit=16, min_chunks=16,
              fusion=fusion, **kw)
    asyncio.run(drive(p, {1: 400, 2: 1200}, max_epochs=400))
    join = p.actor.consumer.input.input        # materialize ← project ← join
    return (sorted(tuple(r) for _pk, r in p.mv_table.iter_rows()),
            [list(s.table.iter_rows()) for s in join.sides], join)


@pytest.mark.parametrize("fusion", [False, True], ids=["unfused", "fused"])
def test_q8_mesh_matches_reference_single_device_and_oracle(eight_devices,
                                                           fusion):
    mv, state, join = _q8("port", eight_devices, fusion)
    ref_mv, ref_state, ref_join = _q8("ref", eight_devices, fusion)
    one_mv, one_state, _j = _q8("port", eight_devices, fusion, mesh=False)
    _p, _a, cfg = _q8_cfg(NexmarkConfig)
    want = q8_oracle(cfg, 400, 1200)
    assert len(want) > 10
    assert set(mv) == want and len(mv) == len(want)
    assert mv == ref_mv == one_mv
    assert state == ref_state == one_state
    assert all(isinstance(s.kernel, ShardedJoinKernel) for s in join.sides)
    assert all(s.kernel.n_dev == 8 for s in join.sides)
    assert [s.fused_input is not None for s in join.sides] == [fusion] * 2
    assert [s.fused_input is not None for s in ref_join.sides] == \
        [fusion] * 2
    for side, ref_side in zip(join.sides, ref_join.sides):
        k, rk = side.kernel, ref_side.kernel
        assert (k.key_capacity, k.row_capacity) == \
            (rk.key_capacity, rk.row_capacity) == (1 << 15, 1 << 17)
        np.testing.assert_array_equal(k.table.keys.numpy(),
                                      np.asarray(rk.table.keys))
        for a, b in zip(k.chains, rk.chains):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- a fused side over the shards -------------------------------------------

N_SHARDS = 4


def _fused_events():
    """Left chunks of (k, v) rows with U-/U+ pairs that move an earlier
    epoch's row: one across the shard-block edge 7 | 8 of a 32-row epoch
    in 4 blocks, to another key; the right side stores every key."""
    rng = np.random.default_rng(9)
    sl, sr = [("b", 1)], [("b", 1)]
    prev = None
    for b in range(2, 5):
        ks = rng.integers(0, 7, 32).tolist()
        vs = list(range((b - 2) * 32, (b - 1) * 32))
        ops = [1] * 32
        if prev is not None:
            for d, u, src in ((7, 8, 10), (2, 3, 12), (20, 21, 14)):
                old_k, old_v = prev[0][src], prev[1][src]
                ks[d], vs[d], vs[u] = old_k, old_v, old_v
                ks[u] = (old_k + 1) % 7 if d == 7 else old_k
                ops[d], ops[u] = 3, 4
        prev = (ks, vs)
        sl.append(_lc(ks, vs, ops))
        sr.append(_rc(list(range(7)), [f"r{b}{i}" for i in range(7)],
                      None))
        sl.append(("b", b))
        sr.append(("b", b))
    return sl, sr


def _fused_join(pkg, devs):
    """The join over a projection of the left input (k % 7, v * 10 + k),
    fused by the package's rewrite over N_SHARDS shards."""
    m = PKG[pkg]
    ls, rs = _schema(m, LR[0]), _schema(m, LR[1])
    sl, sr = _fused_events()
    dt = m["types"].DataType
    e = m["expr"]
    k, v = e.InputRef(0, dt.INT64), e.InputRef(1, dt.INT64)
    src = m["utils"].MockSource(ls, _messages(m, ls, sl))
    proj = m["simple"].ProjectExecutor(
        src, [k % e.lit(7, dt.INT64), v * e.lit(10, dt.INT64) + k],
        ["lk", "lv"])
    store = m["Store"]()
    lt = m["Table"](21, ls, [1], store, dist_key_indices=[])
    rt = m["Table"](22, rs, [1], store, dist_key_indices=[])
    kw = dict(device="cpu") if pkg == "port" else {}
    join = m["hj"].HashJoinExecutor(
        proj, m["utils"].MockSource(rs, _messages(m, rs, sr)),
        left_keys=[0], right_keys=[0], left_table=lt, right_table=rt,
        mesh=_mesh(pkg, devs, N_SHARDS), **kw)
    if pkg == "port":
        root, _r = rewrite_stream_plan(join, "none", fusion=True,
                                       device="cpu")
    else:
        root, _r = ref_rewrite(join, "none", record=False, fusion=True)
    msgs = asyncio.run(m["utils"].collect_until_n_barriers(root, 4))
    records = [[(int(op), tuple(r)) for op, r in x.to_records()]
               for x in msgs if hasattr(x, "to_records")]
    return root, records, (list(lt.iter_rows()), list(rt.iter_rows()))


def test_fused_mesh_join_side_needs_no_segment(eight_devices):
    port, records, state = _fused_join("port", eight_devices)
    ref, ref_records, ref_state = _fused_join("ref", eight_devices)
    assert port.sides[0].fused_input is not None
    assert ref.sides[0].fused_input is not None
    assert records == ref_records and state == ref_state
    assert len(records) > 0
    k, rk = port.sides[0].kernel, ref.sides[0].kernel
    assert isinstance(rk, RefKernel)
    np.testing.assert_array_equal(k.table.keys.numpy(),
                                  np.asarray(rk.table.keys))
    for a, b in zip(k.chains, rk.chains):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the prelude is per row: over the whole epoch or block by block, the
    # U-/U+ pair across the block edge gets the same lanes
    sl, _sr = _fused_events()
    ls = _schema(PKG["port"], LR[0])
    chunk = _messages(PKG["port"], ls, [sl[3]])[0]     # the second epoch
    side = port.sides[0]
    raw = torch.from_numpy(F.encode_raw_chunk(chunk,
                                              side.fused_input.ref_cols))
    whole = F.join_prelude(side.prelude, raw)
    blocks = torch.cat([F.join_prelude(side.prelude, raw[i:i + 8])
                        for i in range(0, 32, 8)])
    assert torch.equal(whole, blocks)
    assert not torch.equal(whole[7], whole[8])      # the key moved


def test_fusion_refuses_a_per_chunk_join():
    """The per-chunk arm has no epoch dispatch to carry a prelude: the
    rule leaves its sides alone, the adopt guard raises, and the checker
    rejects a fused side on it."""
    m = PKG["port"]
    ls, rs = _schema(m, LR[0]), _schema(m, LR[1])
    dt = port_types.DataType

    def build(epoch_batch):
        src = port_utils.MockSource(ls, [])
        proj = port_simple.ProjectExecutor(
            src, [port_expr.InputRef(0, dt.INT64),
                  port_expr.InputRef(1, dt.INT64)], ["lk", "lv"])
        store = MemoryStateStore()
        return port_hj.HashJoinExecutor(
            proj, port_utils.MockSource(rs, []), [0], [0],
            StateTable(21, ls, [1], store), StateTable(22, rs, [1], store),
            mesh=ShardMesh(4, "cpu"), epoch_batch=epoch_batch,
            device="cpu"), src, proj
    join, _src, _proj = build(False)
    assert "per-chunk" in join_side_ineligible_reason(join, 0)
    root, _r = rewrite_stream_plan(join, "none", fusion=True, device="cpu")
    assert root is join and root.sides[0].fused_input is None
    fused, _src, _proj = build(True)
    root, _r = rewrite_stream_plan(fused, "none", fusion=True, device="cpu")
    fs = root.sides[0].fused_input
    assert fs is not None
    with pytest.raises(ValueError, match="per-chunk"):
        join.adopt_fused_input(0, fs, root.left_in)
    root._epoch_batch = False
    with pytest.raises(port_checker.CheckError, match="per-chunk"):
        port_checker.check(root, port_checker.snapshot(root))
