"""The vnode-sharded aggregation of the PyTorch port against the JAX
reference's, on the CPU (every kernel's plain version).

- the routing helpers (``vnodes_from_lanes``, ``owners_host``,
  ``skew_bucket``, the contiguous owner map) on random lanes;
- ``route_plain`` against the reference's ``bucketize_by_owner`` +
  ``exchange`` under ``shard_map`` on the 8-device CPU mesh, bit for bit,
  with a forced overflow, over 8 and 3 shards (3 pads the owner map);
- ``ShardedAggKernel`` against the reference kernel, shard by shard, bit
  for bit through ``to_numpy_sharded_state``: a random stream of the
  mixed plan (SUM int, SUM float, MIN, COUNT) with growth past the
  initial capacity, each barrier's flush, watermark retirement,
  recovery, a reshard to a rotated owner map and one that overfills;
  a batch that does not divide by the shard count; a forced bucket
  overflow (the survivors applied, then the flush raises). These
  mirror tests/test_multichip_agg.py:42, :177, :197, :206 and :247;
- the epoch arm against the per-chunk arm (``epoch_batch=False``) with
  mid-epoch growth, and against the single-device port, with one routed
  step and one gather per epoch (tests/test_sharded_epoch.py:209, :248).

Float SUM's (hi, lo) f32 pair is compared bit for bit too: both packages
add each shard's received rows in the same order on the CPU. Inputs are
made from seeds with numpy and handed to both packages.
"""

import collections

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from risingwave_tpu.ops import hash_agg as R
from risingwave_tpu.parallel import exchange as RX
from risingwave_tpu.parallel.agg import ShardedAggKernel as RefKernel
from risingwave_tpu.utils import jaxtools
from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.ops import lanes
from risingwave_tpu_torch.parallel import exchange as X
from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh, contiguous_owner_map

torch.set_num_threads(2)

KW = 3                         # one int64 group column: (hi, lo, valid)
MIXED = [("sum", np.int64), ("sum", np.float64), ("min", np.int64),
         ("count", None)]


def _specs(mod, pairs):
    return tuple(mod.AggSpec(mod.AggKind(k), None if d is None
                             else np.dtype(d)) for k, d in pairs)


def _mesh(devs, n):
    return Mesh(np.asarray(devs[:n]), ("d",))


def _key_lanes(g: np.ndarray) -> np.ndarray:
    hi, lo = lanes.split_i64(g.astype(np.int64))
    return np.stack([hi, lo, np.ones(len(g), np.int32)], axis=1)


# -- routing helpers -------------------------------------------------------

@pytest.mark.parametrize("n", [8, 3])
def test_owner_map_and_routing_helpers_match_reference(eight_devices, n):
    ref = RefKernel(_mesh(eight_devices, n), key_width=KW,
                    specs=_specs(R, [("count", None)]), capacity=1 << 8)
    omap = contiguous_owner_map(n)
    assert np.array_equal(omap, ref._owner_map_host)
    assert np.array_equal(ShardMesh(n, "cpu").owner_map(), omap)
    rng = np.random.default_rng(n)
    kl = rng.integers(-2**31, 2**31, (4096, KW)).astype(np.int32)
    assert np.array_equal(
        X.vnodes_from_lanes(torch.from_numpy(kl)).numpy(),
        np.asarray(RX.vnodes_from_lanes(jax.numpy.asarray(kl))))
    own = X.owners_host(kl, omap)
    assert np.array_equal(own, RX.owners_host(kl, omap))
    local = 4096 // n
    own = own[:n * local]
    for mask in (rng.random(n * local) < 0.8, np.zeros(n * local, bool)):
        assert X.skew_bucket(own, mask, n, local) == \
            RX.skew_bucket(own, mask, n, local)
    skewed = np.where(rng.random(n * local) < 0.9, n - 1, own)
    assert X.skew_bucket(skewed, mask | True, n, local) == \
        RX.skew_bucket(skewed, mask | True, n, local)


def _ref_route(mesh, rows, valid, omap, bucket, kw):
    n_dev = mesh.devices.size
    m = n_dev * bucket

    def local(rows_b, valid_b, owner_map):
        owner = owner_map[RX.vnodes_from_lanes(rows_b[:, :kw])]
        buckets, bvalid, ovf = RX.bucketize_by_owner(
            owner, valid_b, [rows_b], n_dev, bucket)
        recv, rvalid = RX.exchange(buckets, bvalid, "d")
        return (recv[0].reshape(1, m, rows_b.shape[1]), rvalid.reshape(1, m),
                ovf[None])

    f = jax.jit(jaxtools.shard_map(
        local, mesh=mesh, in_specs=(P("d"), P("d"), P()),
        out_specs=(P("d"), P("d"), P("d")), check_vma=False))
    return [np.asarray(x) for x in f(rows, valid, omap)]


@pytest.mark.parametrize("n,small,one_owner", [
    pytest.param(8, False, False, id="8-False"),
    pytest.param(8, True, False, id="8-True"),
    pytest.param(3, False, False, id="3-False"),
    pytest.param(3, True, False, id="3-True"),
    pytest.param(8, False, True, id="8-one-owner")])
def test_route_plain_matches_bucketize_and_exchange(eight_devices, n, small,
                                                    one_owner):
    """The receive buffer, its flags and the per-sender overflow flags,
    bit for bit; a small bucket must overflow in both. With
    ``one_owner`` every row has one key, so one shard takes the batch
    (q7's step: one window)."""
    rng = np.random.default_rng(10 + n)
    local = 96
    w = 7
    g = rng.integers(0, 40, n * local) if not one_owner \
        else np.full(n * local, 7)
    keys = _key_lanes(g * 1_000_003)
    rows = np.concatenate(
        [keys, rng.integers(-2**31, 2**31, (n * local, w - KW))],
        axis=1).astype(np.int32)
    valid = rng.random(n * local) < 0.85
    omap = contiguous_owner_map(n)
    bucket = 4 if small else local
    recv, rvalid, ovf = X.route_plain(
        torch.from_numpy(rows), torch.from_numpy(valid),
        torch.from_numpy(omap), n, bucket, KW)
    want = _ref_route(_mesh(eight_devices, n), rows, valid, omap, bucket, KW)
    assert np.array_equal(recv.numpy(), want[0])
    assert np.array_equal(rvalid.numpy() != 0, want[1])
    assert np.array_equal(ovf.numpy() != 0, want[2])
    assert bool(want[2].any()) == small
    assert int(rvalid.sum()) == (int(valid.sum()) if not small
                                 else int(want[1].sum()))


# -- the sharded kernel, shard by shard --------------------------------------

def _chunk(rng, specs, n, n_keys):
    """One host chunk of the mixed plan: invisible rows and NULL inputs,
    inserts only (a flush decodes net row counts, which a retraction of
    an absent row would drive below zero; the epoch tests below
    retract)."""
    g = rng.integers(0, n_keys, n).astype(np.int64) * 7_001
    signs = np.ones(n, dtype=np.int32)
    vis = rng.random(n) > 0.1
    ints = rng.integers(-10**12, 10**12, n)
    floats = rng.standard_normal(n) * 1e3
    inputs = []
    for s in specs:
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        ok = rng.random(n) < 0.9
        vals = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(vals), ok))
    return _key_lanes(g), signs, vis, inputs


def _same_state(port: ShardedAggKernel, ref: RefKernel) -> None:
    got = H.to_numpy_sharded_state(port.state, port.specs)
    want = jax.device_get(ref.state)
    assert port.capacity == ref.capacity
    assert np.array_equal(got.table.keys, np.asarray(want.table.keys))
    assert np.array_equal(got.table.occ, np.asarray(want.table.occ))
    for name in ("group_rows", "dirty", "emitted_valid", "emitted_rows"):
        assert np.array_equal(getattr(got, name),
                              np.asarray(getattr(want, name))), name
    for a, b in zip(got.accs + got.emitted_accs,
                    tuple(want.accs) + tuple(want.emitted_accs)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.int32), b.view(np.int32))


def _same_flush(a, b) -> None:
    assert a.n == b.n
    for f in ("keys", "group_rows", "was_emitted", "prev_rows"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("outs", "nulls", "nns", "prev_outs", "prev_nulls",
              "prev_nns"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert (x is None and y is None) or np.array_equal(x, y), f


def _acc_cols(rng, specs, n):
    """Host-layout accumulator columns (``acc_dtypes``) for recovery."""
    cols = []
    for s in specs:
        if s.kind.value == "count":
            cols.append(rng.integers(1, 50, n).astype(np.int64))
            continue
        nn = rng.integers(0, 4, n).astype(np.int64)
        if np.issubdtype(s.in_dtype, np.floating):
            v = rng.standard_normal(n) * 1e3
        else:
            v = rng.integers(-10**12, 10**12, n)
        cols += [np.where(nn > 0, v, 0).astype(s.out_dtype), nn]
    return cols


@pytest.fixture(scope="module")
def mixed_run(eight_devices):
    """Both kernels, 8 shards of 256 slots, fed the same stream; state
    compared after each stage. Returns {stage: (port, ref, extra)}."""
    mesh = _mesh(eight_devices, 8)
    port_specs, ref_specs = _specs(H, MIXED), _specs(R, MIXED)
    port = ShardedAggKernel(ShardMesh(8, "cpu"), KW, port_specs,
                            capacity=256)
    ref = RefKernel(mesh, KW, ref_specs, capacity=256)
    rng = np.random.default_rng(42)
    seen = {}
    flushes = []
    for epoch in range(3):
        for _c in range(3):
            kl, signs, vis, inputs = _chunk(rng, port_specs, 300, 1500)
            port.apply(kl, signs, vis, inputs)
            ref.apply(kl, signs, vis, inputs)
        flushes.append((port.flush(), ref.flush()))
        port.advance()
        ref.advance()
        if epoch == 0:
            _same_state(port, ref)
            seen["apply"] = True
    _same_state(port, ref)
    seen["growth"] = port.capacity
    for a, b in flushes:
        _same_flush(a, b)
    seen["flush"] = sum(a.n for a, _b in flushes)
    wm = 700 * 7_001
    port.retire_below(0, wm)
    ref.retire_below(0, wm)
    _same_state(port, ref)
    seen["retire"] = port.snapshot()
    assert seen["retire"] == ref.snapshot()
    new_map = np.roll(contiguous_owner_map(8), 37)
    port.reshard(new_map)
    ref.reshard(new_map)
    _same_state(port, ref)
    kl, signs, vis, inputs = _chunk(rng, port_specs, 300, 1500)
    port.apply(kl, signs, vis, inputs)
    ref.apply(kl, signs, vis, inputs)
    _same_flush(port.flush(), ref.flush())
    _same_state(port, ref)
    seen["reshard"] = port.snapshot()
    assert seen["reshard"] == ref.snapshot()
    n = 700
    keys = _key_lanes(rng.permutation(5000)[:n].astype(np.int64) * 13)
    rows = rng.integers(1, 9, n).astype(np.int64)
    accs = _acc_cols(rng, port_specs, n)
    port.rebuild(keys, rows, accs)
    ref.rebuild(keys, rows, accs)
    _same_state(port, ref)
    seen["rebuild"] = port.capacity
    return seen


@pytest.mark.parametrize("stage", ["apply", "growth", "flush", "retire",
                                   "reshard", "rebuild"])
def test_sharded_kernel_matches_reference(mixed_run, stage):
    """Each stage's per-shard state equals the reference's bit for bit
    (checked inside the fixture); here what each stage must show."""
    got = mixed_run[stage]
    if stage == "growth":
        assert got > 256                 # grew mid-stream, on both
    elif stage == "flush":
        assert got > 1000
    elif stage == "retire":
        keys = {int(lanes.merge_i64(np.asarray([k[0]]),
                                    np.asarray([k[1]]))[0]) for k in got}
        assert keys and min(keys) >= 700 * 7_001
    elif stage == "rebuild":
        assert got >= 256                # 700 groups over 8 shards fit
    else:
        assert got


def test_reshard_that_overfills_raises_and_keeps_state(eight_devices):
    """Every vnode onto one shard of 256 slots with 400 live groups:
    both kernels raise, and the port's state is left as it was."""
    mesh = _mesh(eight_devices, 8)
    specs_p, specs_r = _specs(H, [("count", None)]), \
        _specs(R, [("count", None)])
    # per-chunk dispatch keeps the pessimistic growth bound at one chunk
    port = ShardedAggKernel(ShardMesh(8, "cpu"), KW, specs_p, capacity=256,
                            epoch_batch=False)
    ref = RefKernel(mesh, KW, specs_r, capacity=256, epoch_batch=False)
    for c in range(4):
        g = np.arange(c * 100, (c + 1) * 100, dtype=np.int64) * 31
        args = (_key_lanes(g), np.ones(100, np.int32), np.ones(100, bool),
                [((), None)])
        port.apply(*args)
        ref.apply(*args)
    assert port.capacity == ref.capacity == 256
    before = port.snapshot()
    assert before == ref.snapshot()
    to_zero = np.zeros(256, np.int32)
    with pytest.raises(RuntimeError, match="overfills"):
        ref.reshard(to_zero)
    with pytest.raises(RuntimeError, match="overfills"):
        port.reshard(to_zero)
    # the reference donated its state to the failed step; the port's
    # stays as it was
    assert port.snapshot() == before


def test_non_divisible_batch_pads(eight_devices):
    """3 shards never divide a pow2 batch: pad rows route nowhere and the
    state equals the reference's (test_multichip_agg.py:177)."""
    port = ShardedAggKernel(ShardMesh(3, "cpu"), KW,
                            _specs(H, [("count", None)]), capacity=1 << 10)
    ref = RefKernel(_mesh(eight_devices, 3), KW,
                    _specs(R, [("count", None)]), capacity=1 << 10)
    rng = np.random.default_rng(9)
    gk = rng.integers(0, 5, 64).astype(np.int64)
    args = (_key_lanes(gk), np.ones(64, np.int32), np.ones(64, bool),
            [((), np.ones(64, bool))])
    port.apply(*args)
    ref.apply(*args)
    snap = port.snapshot()
    ref.snapshot()
    _same_state(port, ref)
    got = {int(lanes.merge_i64(np.asarray([k[0]]), np.asarray([k[1]]))[0]):
           v[0] for k, v in snap.items()}
    assert got == dict(collections.Counter(gk.tolist()))


def test_small_bucket_overflows_like_the_reference(eight_devices):
    """An explicit bucket too small for the batch: the rows that fit are
    applied on both, then draining the counters raises."""
    specs_p, specs_r = _specs(H, [("count", None)]), \
        _specs(R, [("count", None)])
    port = ShardedAggKernel(ShardMesh(8, "cpu"), KW, specs_p,
                            capacity=1 << 10, bucket=2)
    ref = RefKernel(_mesh(eight_devices, 8), KW, specs_r, capacity=1 << 10,
                    bucket=2)
    g = np.full(256, 5, dtype=np.int64)          # one hot key
    args = (_key_lanes(g), np.ones(256, np.int32), np.ones(256, bool),
            [((), None)])
    port.apply(*args)
    ref.apply(*args)
    with pytest.raises(RuntimeError, match="bucket overflow"):
        ref.snapshot()
    with pytest.raises(RuntimeError, match="bucket overflow"):
        port.snapshot()
    _same_state(port, ref)
    assert port.snapshot() == ref.snapshot()
    assert sum(v[0] for v in port.snapshot().values()) == 2 * 8


# -- epoch batching ------------------------------------------------------------

def _agg_stream(seed: int, epochs: int, rows: int, n_keys: int):
    """tests/test_sharded_epoch.py's stream: retractions, invisible rows
    and NULL values, three chunks per epoch."""
    rng = np.random.default_rng(seed)
    out = []
    for _e in range(epochs):
        chunks = []
        for _c in range(3):
            gk = rng.integers(0, n_keys, rows).astype(np.int64) * 7_001
            vals = rng.integers(-(10**6), 10**6, rows)
            signs = np.where(rng.random(rows) < 0.15, -1, 1) \
                .astype(np.int32)
            vis = rng.random(rows) > 0.1
            valid = rng.random(rows) > 0.05
            chunks.append((gk, vals, signs, vis, valid))
        out.append(chunks)
    return out


def _drive(kernel, stream, specs, flush=False):
    views = []
    for chunks in stream:
        for gk, vals, signs, vis, valid in chunks:
            kernel.apply(_key_lanes(gk), signs, vis,
                         [(specs[0].encode_input(vals), valid), ((), None)])
        if flush:
            kernel.flush()
            kernel.advance()
        views.append(dict(kernel.snapshot()))
    return views


def test_epoch_batch_matches_per_chunk_and_single_device():
    """Epoch-buffered vs per-chunk dispatch, equal after every epoch with
    mid-epoch growth (256 slots ≪ 2000 keys), and equal to the
    single-device port (tests/test_sharded_epoch.py:209)."""
    specs = _specs(H, [("sum", np.int64), ("count", None)])
    stream = _agg_stream(seed=11, epochs=4, rows=512, n_keys=2000)
    on = ShardedAggKernel(ShardMesh(4, "cpu"), KW, specs, capacity=256)
    off = ShardedAggKernel(ShardMesh(4, "cpu"), KW, specs, capacity=256,
                           epoch_batch=False)
    v_on = _drive(on, stream, specs)
    assert v_on == _drive(off, stream, specs)
    assert on.capacity > 256
    single = H.GroupedAggKernel(KW, specs, device="cpu")
    for chunks in stream:
        for gk, vals, signs, vis, valid in chunks:
            single.apply(_key_lanes(gk), signs, vis,
                         [(specs[0].encode_input(vals), valid), ((), None)])
    single._dispatch_backlog()
    st = H.to_numpy_state(single.state, specs)
    idx = np.flatnonzero(st.table.occ & (st.group_rows > 0))
    outs, nulls = H.decode_outputs(specs, [a[idx] for a in st.accs])
    want = {tuple(k): tuple(None if nulls[c][i] else outs[c][i].item()
                            for c in range(2))
            for i, k in enumerate(st.table.keys[idx].tolist())}
    assert v_on[-1] == want


def test_epoch_batch_one_routed_step_and_one_gather_per_epoch():
    """The kernel's own step counter (plain versions add nothing to
    LAUNCHES): one routed step + one gather per epoch on the epoch arm,
    one step per chunk more on the per-chunk arm
    (tests/test_sharded_epoch.py:248)."""
    specs = _specs(H, [("sum", np.int64), ("count", None)])
    stream = _agg_stream(seed=3, epochs=3, rows=256, n_keys=64)
    counts = {}
    for epoch_batch in (True, False):
        k = ShardedAggKernel(ShardMesh(4, "cpu"), KW, specs,
                             capacity=1 << 10, epoch_batch=epoch_batch)
        _drive(k, stream, specs, flush=True)
        counts[epoch_batch] = k.dispatches
    assert counts[True] == 3 * 2
    assert counts[False] == 3 * (3 + 1)


def test_reshard_resets_occupancy_to_the_moved_groups(eight_devices):
    """Declared deviation (ROADMAP.md queue C): after a reshard the port's
    per-shard occupancy is the groups each shard received, exact; the
    reference keeps its pre-reshard counts, which undercount a shard that
    gained groups. The state itself is the reference's."""
    specs_p, specs_r = _specs(H, [("count", None)]), \
        _specs(R, [("count", None)])
    port = ShardedAggKernel(ShardMesh(8, "cpu"), KW, specs_p, capacity=1 << 10)
    ref = RefKernel(_mesh(eight_devices, 8), KW, specs_r, capacity=1 << 10)
    g = np.arange(300, dtype=np.int64) * 17
    args = (_key_lanes(g), np.ones(300, np.int32), np.ones(300, bool),
            [((), None)])
    port.apply(*args)
    ref.apply(*args)
    port.snapshot()
    ref.snapshot()
    to_two = np.arange(256, dtype=np.int32) % 2
    port.reshard(to_two)
    ref.reshard(to_two)
    _same_state(port, ref)
    occ = H.to_numpy_sharded_state(port.state, specs_p).table.occ.sum(axis=1)
    assert occ[2:].sum() == 0 and occ.sum() == 300
    assert port._counters.worst_exact() == occ.max()
    assert ref._counters.worst_exact() < occ.max()
