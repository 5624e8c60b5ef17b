"""The rebuild with its fresh table cleared in K4's mask launch, and the
patch carried in K3's advance launch, against the JAX reference on the
CPU (the kernels' plain versions):

- the patched advance (``advance(state, flushed, patch=cols)``, column i
  for the flush list's row i) against the reference's ``build_patch`` at
  the flushed slots (padded with ``cap``) then ``advance_state``: a
  corrected retractable MIN and MAX beside an integer SUM whose limbs and
  a float SUM whose (hi, lo) bits pass through, on one device and over
  3 shards;
- a pending patch that meets any other state operation (a step, a flush,
  retirement, eviction, growth, a reload, recovery, a read of the state)
  is written first, so the kernel's state equals the reference kernel's
  after ``patch_accs`` and the same operation;
- retirement, growth and eviction through ``live_and_table`` (the mask
  and a zeroed fresh table) against the reference's ``retire_state``,
  growth rehash and ``evict_state``, and the sharded rebuild
  (``rebuild_sharded``: retirement, and growth keeping every occupied
  slot) against the reference's per-shard rebuild.

Every state is compared exactly: integer and float rows by their bits,
the rebuilt ones key-sorted (slot numbers are a by-product of K1's slot
rule; on the CPU they match too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.ops import hash_agg as R
from risingwave_tpu_torch.ops import hash_agg as P

from tests import test_torch_agg_cold as AC

torch.set_num_threads(2)

CPU = torch.device("cpu")
KW = 3


def _corrected(specs, n, rng, calls=("min", "max")):
    """decoded columns for a patch: new (value, nn) for the given kinds,
    None (raw passthrough) for the rest."""
    out = []
    for s in specs:
        if s.kind.value in calls:
            out.append((rng.integers(-10**9, 10**9, n),
                        rng.integers(0, 3, n).astype(np.int64)))
        else:
            out.append(None)
    return out


def _patch_both(specs, pspecs, ref, port, fc, rng, pad_of, calls):
    """The reference's build_patch + advance_state and the port's flush
    matrix and patch columns for the same corrections: (want, flushed,
    patch int32[n_acc, pad])."""
    mat = np.asarray(R.gather_packed(ref, fc))
    flushed = P.flush_gather_plain(port, fc)
    np.testing.assert_array_equal(flushed.numpy(), mat)
    n = int(mat[0, 0])
    assert 0 < n <= fc
    data = mat[1:1 + n]
    decoded = _corrected(specs, n, rng, calls)
    rcols = R.encode_patch_cols(specs, decoded,
                                R.decode_flush_data(specs, KW, data).raw_accs)
    pcols = P.encode_patch_cols(pspecs, decoded,
                                P.decode_flush_data(pspecs, KW,
                                                    data).raw_accs)
    pad = pad_of(n)
    idx_p = np.full(pad, ref.table.capacity, np.int32)
    idx_p[:n] = data[:, 0]
    padded = tuple(np.concatenate([c, np.zeros(pad - n, c.dtype)])
                   for c in rcols)
    want = R.advance_state(R.build_patch(specs)(ref, jnp.asarray(idx_p),
                                                padded))
    src = np.zeros((len(pcols), pad), np.int32)
    src[:, :n] = np.stack(P.as_i32_cols(pcols))
    return want, flushed, torch.from_numpy(src)


PADS = {"pow2": lambda n: 1 << max(0, n - 1).bit_length(),
        "twice": lambda n: 2 * n}


@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("calls", [("min", "max"), ()],
                         ids=["minmax_corrected", "passthrough_only"])
def test_patched_advance_matches_reference(pad, calls):
    """One launch's worth: the list's slots take the patch columns (the
    untouched SUM limbs, float (hi, lo) bits and COUNT pass through) and
    advance; the columns past n_dirty (the reference's idx == cap
    padding) write nothing."""
    specs, pspecs, ref, rng = AC._state()
    port = P.from_jax_state(ref, CPU)
    want, flushed, patch = _patch_both(specs, pspecs, ref, port, 1024, rng,
                                       PADS[pad], calls)
    P.advance(port, flushed, patch=patch)
    AC._same(port, want, pspecs)
    assert not np.asarray(want.dirty).any()


def test_patched_advance_sharded_matches_reference():
    """The sharded form: 3 shards with different dirty counts, each
    shard's column i for its own list's row i, one patch block padded to
    the fullest shard."""
    shards = [AC._state(groups=g, seed=s) for g, s in
              ((600, 3), (90, 5), (350, 8))]
    specs, pspecs = shards[0][0], shards[0][1]
    fc = 1024
    ports = [P.from_jax_state(ref, CPU) for _s, _p, ref, _r in shards]
    state = P.ShardedAggState(
        P.ht.TableState(torch.stack([p.table.keys for p in ports]),
                        torch.stack([p.table.occ for p in ports])),
        torch.stack([p.st for p in ports]))
    ns = [int(np.asarray(R.gather_packed(ref, fc))[0, 0])
          for _s, _p, ref, _r in shards]
    assert len(set(ns)) == 3
    pad = 1 << (max(ns) - 1).bit_length()
    wants, mats, cols = [], [], []
    for (_s, _p, ref, rng), port in zip(shards, ports):
        w, f, c = _patch_both(specs, pspecs, ref, port, fc, rng,
                              lambda n: pad, ("min", "max"))
        wants.append(w)
        mats.append(f)
        cols.append(c)
    P.advance_sharded(state, torch.stack(mats), patch=torch.stack(cols))
    for d, want in enumerate(wants):
        AC._same(state.shard(d), want, pspecs)


def test_a_truncated_list_cannot_carry_a_patch():
    specs, pspecs, ref, rng = AC._state()
    port = P.from_jax_state(ref, CPU)
    flushed = P.flush_gather_plain(port, 16)
    assert int(flushed[0, 0]) > 16
    patch = torch.zeros((port.n_acc, 1 << 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot carry a patch"):
        P.advance(port, flushed, patch=patch)
    with pytest.raises(ValueError, match="rides on a flush list"):
        P.advance(port, None, patch=patch)
    short = P.flush_gather_plain(port, 1024)
    with pytest.raises(ValueError, match="cannot carry a patch"):
        P.advance(port, short, patch=patch[:, :4].contiguous())


# -- a pending patch that meets another state operation --------------------

def _kernels(groups=300):
    """The reference's and the port's GroupedAggKernel on the same state,
    each flushed and holding the same patch (``patch_accs``)."""
    specs, pspecs, ref, rng = AC._state(groups=groups)
    rk = R.GroupedAggKernel(KW, specs, capacity=2048)
    rk.state = ref
    pk = P.GroupedAggKernel(KW, pspecs, capacity=2048, device="cpu")
    pk.state = P.from_jax_state(ref, CPU)
    rfr, pfr = rk.flush(), pk.flush()
    assert rfr.n == pfr.n > 0
    decoded = _corrected(specs, rfr.n, rng)
    rk.patch_accs(decoded, raw_accs=rfr.raw_accs)
    pk.patch_accs(decoded, raw_accs=pfr.raw_accs)
    assert pk._patch is not None
    return specs, pspecs, rk, pk, rng


def _reload_rows(pspecs, rng, n):
    keys = AC._keys(rng.permutation(10**5)[:n].astype(np.int64) * 7_919
                    + 5)
    rows = rng.integers(1, 9, n).astype(np.int64)
    accs = []
    for s in pspecs:
        if s.kind.value == "count":
            accs.append(rng.integers(1, 50, n).astype(np.int64))
            continue
        nn = rng.integers(0, 4, n).astype(np.int64)
        v = rng.standard_normal(n) * 1e3 if s.is_float_sum else \
            rng.integers(-10**12, 10**12, n)
        accs += [np.where(nn > 0, v, 0).astype(s.out_dtype), nn]
    return keys, rows, accs


def _batch(rng, specs, n=256, groups=300):
    """One chunk's (key lanes, signs, vis, per-call inputs), as both
    packages' ``apply`` take them: appends and some retractions."""
    g = rng.integers(0, groups, n).astype(np.int64) * 7_919 - 3
    signs = np.where(rng.random(n) < 0.2, -1, 1).astype(np.int32)
    vis = rng.random(n) < 0.95
    ints = rng.integers(-10**12, 10**12, n)
    floats = rng.standard_normal(n) * 1e3
    inputs = []
    for s in specs:
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        vals = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(vals), rng.random(n) < 0.9))
    return AC._keys(g), signs, vis, tuple(inputs)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _op(name, k, specs, rng):
    """One state operation on a kernel of either package."""
    if name == "step":
        k.apply(*_batch(rng, specs))
        k._dispatch_backlog()
    elif name == "flush":
        k.flush()
    elif name == "retire":
        k.retire_below(0, 40 * 7_919)
    elif name == "evict":
        occ = np.flatnonzero(_host(k.state.table.occ))
        keys = _host(k.state.table.keys)
        k.evict_keys(np.ascontiguousarray(keys[occ[::3]]))
    elif name == "grow":
        k._grow()
    elif name in ("load", "rebuild"):
        keys, rows, accs = _reload_rows(k.specs, rng, 40)
        getattr(k, "load_groups" if name == "load" else "rebuild")(
            keys, rows, accs)


@pytest.mark.parametrize("op", ["step", "flush", "retire", "evict", "grow",
                                "load", "rebuild", "read"])
def test_pending_patch_goes_out_before_another_operation(op):
    """patch_accs, then an operation other than advance: the port writes
    its pending patch first (the standalone K9 at the flushed slots), so
    its state equals the reference's, whose patch was written at
    once."""
    specs, pspecs, rk, pk, rng = _kernels()
    seed = int(rng.integers(1 << 30))
    if op != "read":
        _op(op, rk, specs, np.random.default_rng(seed))
        _op(op, pk, pspecs, np.random.default_rng(seed))
    AC._same(pk.state, rk.state, pspecs)
    assert pk._patch is None
    if op in ("read", "flush"):
        # a read or a flush does not step the state: advance follows
        rk.advance()
        pk.advance()
        AC._same(pk.state, rk.state, pspecs)


def test_patch_rides_in_the_advance():
    """patch_accs then advance: one advance with the patch, no K9 (the
    patch never goes out alone), the reference's state after its patch
    and advance."""
    specs, pspecs, rk, pk, _rng = _kernels()
    calls = []
    orig = P.patch_state
    P.patch_state = lambda *a: calls.append(1) or orig(*a)
    try:
        rk.advance()
        pk.advance()
    finally:
        P.patch_state = orig
    assert calls == [] and pk._patch is None
    AC._same(pk.state, rk.state, pspecs)


# -- the rebuild with its fresh table from the mask's launch ------------------

def _fills(specs):
    return tuple(f for _dt, f in R.dev_layout(specs))


def _sorted(host) -> tuple:
    """(keys, every state row's bits) of the occupied slots, key-sorted,
    from a port state (``to_numpy_state``) or a reference one."""
    occ = np.asarray(host.table.occ).astype(bool)
    keys = np.asarray(host.table.keys)[occ]
    rows = [np.asarray(getattr(host, f))[occ].astype(np.int64)
            for f in ("group_rows", "dirty", "emitted_valid",
                      "emitted_rows")]
    rows += [np.ascontiguousarray(np.asarray(a)[occ]).view(np.int32)
             for a in tuple(host.accs) + tuple(host.emitted_accs)]
    order = np.lexsort(keys.T[::-1])
    return keys[order], np.stack(rows, axis=1)[order]


def _same_sorted(port_state, ref_state, pspecs):
    for a, b in zip(_sorted(P.to_numpy_state(port_state, pspecs)),
                    _sorted(ref_state)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["retire", "grow", "evict"])
def test_rebuild_with_a_cleared_table_matches_reference(kind):
    specs, pspecs, ref, rng = AC._state()
    port = P.from_jax_state(ref, CPU)
    fill = torch.tensor(P.state_fills(pspecs), dtype=torch.int32)
    fills = _fills(specs)
    cap = ref.table.capacity
    if kind == "retire":
        hi, lo = AC.ref_lanes.split_i64(np.asarray([300 * 7_919],
                                                   dtype=np.int64))
        want, n_live = R.retire_state(ref, jnp.int32(hi[0]),
                                      jnp.int32(lo[0]), 0, fills)
        got, stats = P.retire_state(port, int(hi[0]), int(lo[0]), 0, fill)
    elif kind == "grow":
        live = ref.table.occ & ((ref.group_rows != 0) | ref.dirty
                                | ref.emitted_valid)
        want, n_live = R._rebuild_live(ref, live, 2 * cap, fills)
        got, stats = P.grow_state(port, 2 * cap, fill)
    else:
        q, valid = AC._queries(rng, ref)
        want, n_live = jax.jit(R.evict_state, static_argnums=(3,))(
            ref, jnp.asarray(q), jnp.asarray(valid), fills)
        got, stats, _l = P.evict_state(port, torch.from_numpy(q),
                                       torch.from_numpy(valid), fill)
    assert got.capacity == want.table.capacity
    assert int(stats[0]) == int(n_live) and int(stats[1]) == 0
    assert 0 < int(n_live) <= int(np.asarray(ref.table.occ).sum())
    _same_sorted(got, want, pspecs)


@pytest.mark.parametrize("mode", [P.LIVE_GROW, P.LIVE_RETIRE, P.LIVE_EVICT,
                                  P.LIVE_OCCUPIED])
@pytest.mark.parametrize("grow", [False, True])
def test_live_and_table_gives_the_mask_and_a_zeroed_table(mode, grow):
    specs, pspecs, ref, rng = AC._state()
    port = P.from_jax_state(ref, CPU)
    cap = port.capacity
    dropped = torch.from_numpy((rng.random(cap) < 0.3).astype(np.int32))
    args = (0, 1, 7) if mode == P.LIVE_RETIRE else (0, 0, 0)
    live, table = P.live_and_table(
        port, mode, 2 * cap if grow else cap, *args,
        dropped=dropped if mode == P.LIVE_EVICT else None)
    np.testing.assert_array_equal(
        live.numpy(), P.live_mask_plain(port, mode, *args, dropped).numpy())
    occ = np.asarray(ref.table.occ)
    if mode == P.LIVE_OCCUPIED:
        np.testing.assert_array_equal(live.numpy() != 0, occ)
    else:
        rule = occ & ((np.asarray(ref.group_rows) != 0)
                      | np.asarray(ref.dirty)
                      | np.asarray(ref.emitted_valid))
        assert not (live.numpy().astype(bool) & ~rule).any()
    n = 2 * cap if grow else cap
    assert table.keys.shape == (n, KW) and table.occ.shape == (n,)
    assert not table.keys.any() and not table.occ.any()
    assert P.live_and_table(port, mode, 0, *args, dropped=dropped)[1] is None


@pytest.mark.parametrize("mode", ["retire", "grow"])
def test_sharded_rebuild_matches_reference(mode):
    """``rebuild_sharded`` (one mask-and-table launch, K1, remap a rebuild
    of every shard) against the reference's per-shard rebuild:
    ``retire_below``'s rule, and growth keeping every occupied slot
    (``parallel/agg.py:603``) into 2 x cap."""
    shards = [AC._state(groups=g, seed=s) for g, s in
              ((600, 3), (90, 5), (350, 8))]
    specs, pspecs = shards[0][0], shards[0][1]
    fills = _fills(specs)
    ports = [P.from_jax_state(ref, CPU) for _s, _p, ref, _r in shards]
    state = P.ShardedAggState(
        P.ht.TableState(torch.stack([p.table.keys for p in ports]),
                        torch.stack([p.table.occ for p in ports])),
        torch.stack([p.st for p in ports]))
    fill = torch.tensor(P.state_fills(pspecs), dtype=torch.int32)
    cap = state.capacity
    hi, lo = AC.ref_lanes.split_i64(np.asarray([300 * 7_919],
                                               dtype=np.int64))
    if mode == "retire":
        got, stats = P.rebuild_sharded(state, P.LIVE_RETIRE, cap, fill, 0,
                                       int(hi[0]), int(lo[0]))
    else:
        got, stats = P.rebuild_sharded(state, P.LIVE_OCCUPIED, 2 * cap,
                                       fill)
    for d, (_s, _p, ref, _r) in enumerate(shards):
        if mode == "retire":
            want, n_live = R.retire_state(ref, jnp.int32(hi[0]),
                                          jnp.int32(lo[0]), 0, fills)
        else:
            want, n_live = R._rebuild_live(ref, ref.table.occ, 2 * cap,
                                           fills)
        assert int(stats[d, 0]) == int(n_live)
        _same_sorted(got.shard(d), want, pspecs)
