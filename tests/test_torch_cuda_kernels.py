"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a card every test here skips. On a CUDA
machine (which need not have JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Integers must match exactly; K1 (probe_insert) is held to the table
invariants, since its slot rule differs from the plain version's; float
SUM's hi and lo rows are each held to rel 1e-6 of the group's summed
magnitudes in that row (atomic order). The join kernels (K5, K6, K7) are
held exactly to their plain versions: row-indexed arrays (next, ins/del
sequences, payload, degrees) and probe matrices bit for bit, and the
slot-indexed head per key (K1 numbers slots its own way). The fused
preludes (fused_chain, agg_prelude, join_prelude) are held bit for bit to
the plain program on random expression trees over every device type,
with edge values; a NaN compares equal to a NaN whatever its bits. The
cold tier's and the patch's kernels: K8 (lookup) and K4's evict mode
exactly, B9 (evict_state) key-sorted against its plain twin, K9
(scatter_rows) exactly with and without its shard axis, K2's kNone lane
exactly, and a GroupedAggKernel's patch, eviction and reload on the card
against the same kernel on the CPU. K4's mask launch, which also zeroes
the rebuild's fresh table, in every mode (the table full of garbage
before it), the three-launch rebuilds (retire, grow, evict; the sharded
retire and growth) key-sorted against their plain twins with their
launches counted, and the patched advance (one launch, no K9) exactly
against K9's plain version then the listed advance's. K5 and K7 drop a
negative ref, as the plain versions do (a declared deviation from the
reference, which wraps it). K7's scatter and gather-carry, with and
without a visibility array, on dense, misaligned and strided operands,
and a rebuild (K1 + K5, the payload in K5's launch, with K7's carry)
exactly against the plain versions, with their launches counted. K2, route, K1, K6, K3 (its gather
and its advance on the flush's own list) and K5 are also held to their
plain versions on ``ops/kernel_cases.py``'s batches, the shapes at the
edges of their designs: K1 by the table invariants and exact stats (with
K8 exact on the tables it built), K6, K3 and K5 exactly (K5 in one launch
a call, twice on one scratch);
the fused kernel on ``ops/fused_cases.py``'s edge cases, bit for bit,
and agg_prelude on q5-hot's hop program and q3's DECIMAL revenue program
at their path shapes.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.models import prelude_cases as PC
from risingwave_tpu_torch.ops import fused_cases as FC
from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.ops import hash_join as J
from risingwave_tpu_torch.ops import hash_table as ht
from risingwave_tpu_torch.ops import kernel_cases as KC
from risingwave_tpu_torch.ops import lanes

pytestmark = pytest.mark.cuda

KW = 3
CAP = 1 << 14
N = 1 << 12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lanes(g):
    hi, lo = lanes.split_i64(g.astype(np.int64))
    return np.stack([hi, lo, np.ones(len(g), np.int32)], axis=1)


def _specs():
    return tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                 for k, d in [("sum", np.int64), ("sum", np.float64),
                              ("max", np.int64), ("count", None)])


def _batch(seed=0, groups=2000):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, N).astype(np.int64) * 31 - 5
    signs = np.where(rng.random(N) < 0.2, -1, 1).astype(np.int32)
    vis = rng.random(N) < 0.95
    ints = rng.integers(-10**12, 10**12, N)
    floats = rng.standard_normal(N) * 100
    inputs = []
    for s in _specs():
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        ok = rng.random(N) < 0.9
        if s.kind == H.AggKind.MAX:
            ok &= signs > 0
        v = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(v), ok))
    return H.pack_chunk(KW, _specs(), _lanes(g), signs, vis, inputs)


def _applied(dev, seed=0):
    packed = torch.from_numpy(_batch(seed)).to(dev)
    st = H.make_agg_state(CAP, KW, _specs(), dev)
    _t, slots, stats = ht.probe_insert(st.table, packed[:, :KW],
                                       packed[:, KW + 1])
    assert int(stats[1]) == 0
    return st, slots, packed


def test_probe_insert_invariants(dev):
    rng = np.random.default_rng(1)
    keys = _lanes(rng.integers(0, 3000, N))
    valid = (rng.random(N) < 0.9).astype(np.int32)
    tk, tp = ht.make_state(CAP, KW, dev), ht.make_state(CAP, KW, dev)
    bk, bv = torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)
    _t, slots, stats = ht.probe_insert(tk, bk, bv)
    _ps, pstats = ht.probe_insert_plain(tp, bk, bv)
    assert stats.tolist() == pstats.tolist()
    s, k = slots.cpu().numpy(), tk.keys.cpu().numpy()
    v = valid != 0
    assert (s[~v] == -1).all() and (s[v] >= 0).all()
    assert (k[s[v]] == keys[v]).all()
    _u, inv = np.unique(keys[v], axis=0, return_inverse=True)
    for u in range(inv.max() + 1):
        assert len(set(s[v][inv == u].tolist())) == 1

    def keyset(t):
        x = t.keys.cpu().numpy()[t.occ.cpu().numpy() != 0]
        return x[np.lexsort(x.T[::-1])]
    np.testing.assert_array_equal(keyset(tk), keyset(tp))


def _k1_checked(dev, cap, batches, s=None):
    """Each batch through K1 and through its plain version, on tables of
    cap slots (s shards, or one table), every batch held to the table
    invariants (``kernel_cases.k1_invariants``); returns the kernel's
    table."""
    k = batches[0][0].shape[-1]
    lead = () if s is None else (s,)
    tk, tp = (ht.TableState(
        torch.zeros(lead + (cap, k), dtype=torch.int32, device=dev),
        torch.zeros(lead + (cap,), dtype=torch.int32, device=dev))
        for _ in range(2))
    for keys, valid in batches:
        bk = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
        bv = torch.from_numpy(valid).to(dev)
        before = [(tk.keys[d].cpu().numpy(), tk.occ[d].cpu().numpy())
                  for d in range(s)] if s else \
            [(tk.keys.cpu().numpy(), tk.occ.cpu().numpy())]
        if s is None:
            _t, slots, stats = ht.probe_insert(tk, bk, bv)
            _p, pstats = ht.probe_insert_plain(tp, bk, bv)
            slots, stats, pstats = slots[None], stats[None], pstats[None]
            views = [(tk, tp, keys, valid)]
        else:
            slots, stats = ht.probe_insert_sharded(tk, bk, bv)
            _p, pstats = ht.probe_insert_sharded_plain(tp, bk, bv)
            views = [(ht.TableState(tk.keys[d], tk.occ[d]),
                      ht.TableState(tp.keys[d], tp.occ[d]), keys[d],
                      valid[d]) for d in range(s)]
        for d, (a, b, kk, vv) in enumerate(views):
            KC.k1_invariants(
                before[d], (a.keys.cpu().numpy(), a.occ.cpu().numpy()),
                (b.keys.cpu().numpy(), b.occ.cpu().numpy()), kk, vv,
                slots[d].cpu().numpy(), stats[d].cpu().numpy(),
                pstats[d].cpu().numpy())
    return tk


@pytest.mark.parametrize("case", KC.K1_CASES)
def test_probe_insert_edge_cases_hold_invariants(dev, case):
    """K1 on its edge cases (ops/kernel_cases.py): one key raced by 32K
    rows, every row new, duplicates across warps and blocks, a table just
    under MAX_LOAD, wrapping probes, interleaved invalid rows and all-zero
    keys, 1 and 6 lanes, no rows, rows that fill no block. Each batch by
    the table invariants with exact stats; then K8 (lookup) on the table
    K1 built, for every batch key and as many absent ones, exact against
    its plain version."""
    cap, batches = KC.k1_cases()[case]
    table = _k1_checked(dev, cap, batches)
    keys = np.concatenate([b[0] for b in batches])
    rng = np.random.default_rng(17)
    q = np.concatenate([keys, rng.integers(-2**31, 2**31, keys.shape)
                        .astype(np.int32)])
    qd = torch.from_numpy(q).to(dev)
    v = torch.from_numpy(rng.random(len(q)) < 0.9).to(dev)
    got, want = ht.lookup(table, qd, v), ht.lookup_plain(table, qd, v)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n_shards", KC.K1_SHARDS)
def test_sharded_probe_insert_edge_cases_hold_invariants(dev, n_shards):
    """K1's shard axis on kernel_cases' sharded batches (8 shards, and 3
    shards of rows that fill no block), shard by shard."""
    cap, batches = KC.k1_sharded_case(n_shards)
    _k1_checked(dev, cap, batches, n_shards)


def test_agg_apply_matches_plain(dev):
    st, slots, packed = _applied(dev)
    plan = H.ApplyPlan(KW, _specs(), dev)
    a = H.AggState(st.table, st.st.clone())
    b = H.AggState(st.table, st.st.clone())
    H.agg_apply(a, packed, slots, plan)
    H.agg_apply_plain(b, packed, slots, plan)
    x, y = a.st.cpu().numpy(), b.st.cpu().numpy()
    f = [H.ROW_ACC0 + 5, H.ROW_ACC0 + 6]
    ints = [r for r in range(x.shape[0]) if r not in f]
    np.testing.assert_array_equal(x[ints], y[ints])
    # hi and lo rows each on their own, against the group's Σ|terms| of
    # that lane: a kernel that drops either lane misses by the lane
    p = packed.cpu().numpy()
    s = slots.cpu().numpy()
    cols, vc = H.packed_layout(KW, _specs())[1]
    live = (p[:, KW + 1] != 0) & (p[:, vc] != 0)
    for row, col in zip(f, cols):
        mag = np.zeros(CAP)
        np.add.at(mag, s[live],
                  np.abs(p[live, col].view(np.float32).astype(np.float64)))
        err = np.abs(x[row].view(np.float32).astype(np.float64)
                     - y[row].view(np.float32).astype(np.float64))
        assert (err <= 1e-6 * mag).all(), (row, float(err.max()))


@pytest.mark.parametrize("case", KC.AGG_CASES)
def test_agg_apply_warp_cases_match_plain(dev, case):
    """K2's warp aggregation at its edges (ops/kernel_cases.py): one slot
    a batch, one slot a lane, two or three slots a warp with invisible
    rows and NULLs, MAX/MIN ties on hi with retractions, integer SUM at
    the limb extremes over whole 8192-row slices, the kNone lane. The
    batch is applied twice, so the second pass meets settled extremes.
    Integers exact, float SUM within rel 1e-6 of Σ|terms| per lane."""
    specs, packed_np = KC.agg_cases()[case]
    packed = torch.from_numpy(packed_np).to(dev)
    st = H.make_agg_state(CAP, KW, specs, dev)
    _t, slots, stats = ht.probe_insert(st.table, packed[:, :KW],
                                       packed[:, KW + 1])
    assert int(stats[1]) == 0
    plan = H.ApplyPlan(KW, specs, dev)
    a = H.AggState(st.table, st.st.clone())
    b = H.AggState(st.table, st.st.clone())
    for _ in range(2):
        H.agg_apply(a, packed, slots, plan)
        H.agg_apply_plain(b, packed, slots, plan)
        KC.agg_state_err(specs, a.st.cpu().numpy(), b.st.cpu().numpy(),
                         packed_np, slots.cpu().numpy())


@pytest.mark.parametrize("n_shards", [8, 3])
def test_sharded_agg_apply_warp_cases_match_plain(dev, n_shards):
    """K2's shard axis (grid.y) at S = 8 and S = 3, each shard with a hot
    slot, warm slots and singletons: shard by shard as the plain
    version."""
    specs, packed_np = KC.sharded_agg_batch(n_shards)
    packed = torch.from_numpy(packed_np).to(dev)
    st = H.make_sharded_agg_state(n_shards, CAP, KW, specs, dev)
    slots, stats = ht.probe_insert_sharded(st.table, packed[:, :, :KW],
                                           packed[:, :, KW + 1])
    assert not bool(stats[:, 1].any())
    plan = H.ApplyPlan(KW, specs, dev)
    a = H.ShardedAggState(st.table, st.st.clone())
    b = H.ShardedAggState(st.table, st.st.clone())
    H.agg_apply_sharded(a, packed, slots, plan)
    H.agg_apply_sharded_plain(b, packed, slots, plan)
    x, y, sl = a.st.cpu().numpy(), b.st.cpu().numpy(), slots.cpu().numpy()
    for s in range(n_shards):
        KC.agg_state_err(specs, x[s], y[s], packed_np[s], sl[s])


def test_flush_gather_and_advance_match_plain(dev):
    st, slots, packed = _applied(dev)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, _specs(), dev))
    for flush_cap in (1 << 12, 64):
        np.testing.assert_array_equal(
            H.flush_gather(st, flush_cap).cpu().numpy(),
            H.flush_gather_plain(st, flush_cap).cpu().numpy())
    a = H.AggState(st.table, st.st.clone())
    H.advance(a)
    H.advance_plain(st)
    np.testing.assert_array_equal(a.st.cpu().numpy(), st.st.cpu().numpy())


def _k3_state(dev, st, keys, occ):
    return H.ShardedAggState(
        ht.TableState(torch.from_numpy(keys).to(dev),
                      torch.from_numpy(occ).to(dev)),
        torch.from_numpy(st).to(dev))


@pytest.mark.parametrize("case", KC.K3_CASES + tuple(
    f"shards_{s}" for s in KC.K3_SHARDS))
def test_flush_gather_edge_cases_match_plain(dev, case):
    """K3 on ``kernel_cases``' edge cases (and its shard axis at 1, 3 and
    8 shards; at maxbids' sizes a block takes several tiles), three calls
    in a row so that each launch runs on the scan words the one before it
    zeroed: every matrix bit for bit, the true n_dirty in each header."""
    if case.startswith("shards_"):
        fc, st, keys, occ = KC.k3_sharded_case(int(case[len("shards_"):]))
    else:
        fc, st, keys, occ = KC.k3_case(case)
    state = _k3_state(dev, st, keys, occ)
    want = H.flush_gather_sharded_plain(state, fc).cpu().numpy()
    for _ in range(3):
        np.testing.assert_array_equal(
            H.flush_gather_sharded(state, fc).cpu().numpy(), want)
    np.testing.assert_array_equal(want[:, 0, 0],
                                  (st[:, H.ROW_DIRTY] != 0).sum(axis=1))
    if st.shape[0] == 1:
        np.testing.assert_array_equal(
            H.flush_gather(state.shard(0), fc).cpu().numpy(), want[0])


@pytest.mark.parametrize("case", KC.ADVANCE_CASES)
def test_advance_edge_cases_match_plain(dev, case):
    """K3's advance on the flush's own list (``kernel_cases.advance_case``:
    nothing dirty, slot 0 dirty, every slot dirty, a truncated matrix,
    which sweeps, 2^20 slots, 8 shards with uneven counts, one past
    flush_cap), reading the state's rows and (``current``) the matrix's
    own values, against the plain version of the sweep: the whole state
    exact; and the sweep with no matrix too."""
    fc, st, keys, occ = KC.advance_case(case)
    a = _k3_state(dev, st, keys, occ)
    b = _k3_state(dev, st, keys, occ)
    c = _k3_state(dev, st, keys, occ)
    d = _k3_state(dev, st, keys, occ)
    H.advance_sharded(a, H.flush_gather_sharded(a, fc))
    H.advance_sharded(d, H.flush_gather_sharded(d, fc), current=True)
    H.advance_sharded(c)
    for s in range(st.shape[0]):
        H.advance_plain(b.shard(s))
    for x in (a, c, d):
        np.testing.assert_array_equal(x.st.cpu().numpy(),
                                      b.st.cpu().numpy())


def test_grouped_kernel_advance_takes_the_flush_list(dev):
    """GroupedAggKernel.advance launches K3's advance once on its flush's
    list, and none after a flush that found nothing dirty."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    specs = (H.AggSpec(H.AggKind("count"), None),)
    k = H.GroupedAggKernel(KW, specs, capacity=1 << 12, device=dev)
    g = np.arange(500).astype(np.int64)
    args = (_lanes(g), np.ones(500, np.int32), np.ones(500, bool),
            [((), None)])
    k.apply(*args)
    LAUNCHES.reset()
    assert k.flush().n == 500
    k.advance()
    assert LAUNCHES.snapshot().get("advance") == 1
    assert int((k.state.st[H.ROW_DIRTY] != 0).sum()) == 0
    LAUNCHES.reset()
    assert k.flush().n == 0
    k.advance()
    assert "advance" not in LAUNCHES.snapshot()


@pytest.mark.parametrize("case", KC.K5_CASES)
def test_join_apply_edge_cases_match_plain(dev, case):
    """K5 on ``kernel_cases.k5_case``'s batches (one slot over many warps
    and blocks, the 400-row hot key, an insert and a delete of one ref,
    slot -1 rows, refs past row_cap, P = 0 and an odd P, link only,
    tombstone only, 8 shards of mostly empty received rows, a batch past
    one wave of resident blocks), one launch a call, twice on one scratch
    (the second launch's generation makes the first's words stale): every
    chain array and the payload exact against the plain version."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    c = KC.k5_case(case)
    chains, pay, parts = KC.k5_tensors(c, dev)
    want_c, want_p, _p = KC.k5_tensors(c, dev)
    scratch = J.link_scratch(chains.head)
    for _ in range(2):
        LAUNCHES.reset()
        KC.k5_launch(chains, pay, parts, scratch)
        assert LAUNCHES.snapshot() == {"join_apply": 1}
        KC.k5_plain(want_c, want_p, parts)
        for x, y in zip(KC.k5_result(chains, pay),
                        KC.k5_result(want_c, want_p)):
            np.testing.assert_array_equal(x, y)


def test_live_mask_and_remap_match_plain(dev):
    st, slots, packed = _applied(dev)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, _specs(), dev))
    H.advance(st)
    hi, lo = lanes.split_i64(np.asarray([1000 * 31], dtype=np.int64))
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE):
        live = H.live_mask(st, mode, 0, int(hi[0]), int(lo[0]))
        np.testing.assert_array_equal(
            live.cpu().numpy(),
            H.live_mask_plain(st, mode, 0, int(hi[0]),
                              int(lo[0])).cpu().numpy())
    fill = torch.tensor(H.state_fills(_specs()), dtype=torch.int32,
                        device=dev)
    table = ht.make_state(2 * CAP, KW, dev)
    _t, o2n, _s = ht.probe_insert(table, st.table.keys, live)
    np.testing.assert_array_equal(
        H.remap(st.st, o2n, table.occ, fill, 2 * CAP).cpu().numpy(),
        H.remap_plain(st.st, o2n, table.occ, fill, 2 * CAP).cpu().numpy())


# -- the agg's cold tier and patch: K8, K4's evict mode, K9, K2's kNone -------

def test_lookup_matches_plain(dev):
    """K8 on a table K1 filled: resident, absent, duplicate and padding
    rows; the same slots and the same dropped mask as the plain
    version."""
    st, _slots, packed = _applied(dev)
    rng = np.random.default_rng(8)
    occ = np.flatnonzero(st.table.occ.cpu().numpy())
    res = st.table.keys.cpu().numpy()[rng.choice(occ, 3000)]
    q = np.concatenate([res, _lanes(rng.integers(10**6, 10**7, 1000))])
    valid = (rng.random(len(q)) < 0.9).astype(np.int32)
    qd, vd = torch.from_numpy(q).to(dev), torch.from_numpy(valid).to(dev)
    da = torch.zeros(CAP, dtype=torch.int32, device=dev)
    db = torch.zeros_like(da)
    got, stats = ht.lookup(st.table, qd, vd, da)
    want, pstats = ht.lookup_plain(st.table, qd, vd, db)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(da.cpu().numpy(), db.cpu().numpy())
    assert stats.tolist() == pstats.tolist() == [0, 0]
    assert (got.cpu().numpy() >= 0).sum() > 2000


def test_evict_state_matches_plain(dev):
    """B9 on the card against its plain twin: K8 + K4 (evict) + K1 + K4
    (remap); compared as key-sorted state, K1 numbering slots its own
    way."""
    st, slots, packed = _applied(dev)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, _specs(), dev))
    H.advance(st)
    rng = np.random.default_rng(9)
    occ = np.flatnonzero(st.table.occ.cpu().numpy())
    q = st.table.keys.cpu().numpy()[rng.choice(occ, 700)]
    q = np.concatenate([q, q[:50], _lanes(rng.integers(10**6, 10**7, 50))])
    qd = torch.from_numpy(q).to(dev)
    vd = torch.ones(len(q), dtype=torch.int32, device=dev)
    fill = torch.tensor(H.state_fills(_specs()), dtype=torch.int32,
                        device=dev)
    dropped = torch.zeros(CAP, dtype=torch.int32, device=dev)
    ht.lookup_plain(st.table, qd, vd, dropped)
    np.testing.assert_array_equal(
        H.live_mask(st, H.LIVE_EVICT, dropped=dropped).cpu().numpy(),
        H.live_mask_plain(st, H.LIVE_EVICT, dropped=dropped).cpu().numpy())
    a, stats, lstats = H.evict_state(
        H.AggState(ht.TableState(st.table.keys.clone(),
                                 st.table.occ.clone()), st.st.clone()),
        qd, vd, fill)
    table = ht.make_state(CAP, KW, dev)
    live = H.live_mask_plain(st, H.LIVE_EVICT, dropped=dropped)
    o2n, pstats = ht.probe_insert_plain(table, st.table.keys, live)
    b = H.AggState(table, H.remap_plain(st.st, o2n, table.occ, fill, CAP))
    assert stats.tolist() == pstats.tolist() and lstats.tolist() == [0, 0]
    assert _groups(a) == _groups(b)
    assert len(_groups(a)) < len(occ)


def _groups(state):
    """key lanes → the slot's state column, for every occupied slot."""
    occ = state.table.occ.cpu().numpy() != 0
    keys = state.table.keys.cpu().numpy()[occ]
    cols = state.st.cpu().numpy()[:, occ].T
    return {tuple(k): tuple(c) for k, c in zip(keys.tolist(), cols.tolist())}


@pytest.mark.parametrize("n_shards", [1, 8])
def test_scatter_rows_matches_plain(dev, n_shards):
    """K9 with its shard axis: named rows at distinct slots, each shard's
    padding (idx == cap) and an unplaced row (-1) dropped."""
    rng = np.random.default_rng(n_shards)
    r, cap, n = 4 + 2 * 7, 1 << 12, 1000
    st = torch.from_numpy(rng.integers(-2**31, 2**31, (n_shards, r, cap))
                          .astype(np.int32)).to(dev)
    idx = np.stack([rng.permutation(cap)[:n] for _ in range(n_shards)])
    idx[:, -100:] = cap
    idx[:, 0] = -1
    rows = np.asarray([0, 2, 3, *range(4, r)], np.int32)
    src = rng.integers(-2**31, 2**31, (n_shards, len(rows), n)) \
        .astype(np.int32)
    a, b = st.clone(), st.clone()
    args = (torch.from_numpy(idx.astype(np.int32)).to(dev),
            torch.from_numpy(rows).to(dev), torch.from_numpy(src).to(dev))
    H.scatter_rows_sharded(a, *args)
    H.scatter_rows_plain(b, *args)
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert not np.array_equal(a.cpu().numpy(), st.cpu().numpy())


def test_agg_apply_none_kind_matches_plain(dev):
    """K2 with approx_count_distinct and string_agg dummy lanes beside
    COUNT and MAX: the dummy lanes stay at their fill, group_rows and
    dirty move as for any call."""
    specs = tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                  for k, d in [("approx_count_distinct", np.int64),
                               ("count", None), ("string_agg", object),
                               ("max", np.int64)])
    rng = np.random.default_rng(12)
    g = rng.integers(0, 500, N).astype(np.int64)
    v = rng.integers(-10**9, 10**9, N)
    inputs = [((), rng.random(N) < 0.9), ((), None),
              ((), rng.random(N) < 0.9),
              (specs[3].encode_input(v), np.ones(N, bool))]
    packed = H.pack_chunk(KW, specs, _lanes(g), np.ones(N, np.int32),
                          rng.random(N) < 0.95, inputs)
    pd = torch.from_numpy(packed).to(dev)
    st = H.make_agg_state(CAP, KW, specs, dev)
    _t, slots, _s = ht.probe_insert(st.table, pd[:, :KW], pd[:, KW + 1])
    plan = H.ApplyPlan(KW, specs, dev)
    assert plan.desc[[0, 2], 0].tolist() == [H._K_NONE] * 2
    a = H.AggState(st.table, st.st.clone())
    H.agg_apply(a, pd, slots, plan)
    H.agg_apply_plain(st, pd, slots, plan)
    np.testing.assert_array_equal(a.st.cpu().numpy(), st.st.cpu().numpy())
    assert not a.st[H.ROW_ACC0].any() and not a.st[H.ROW_ACC0 + 2].any()


def test_grouped_kernel_cold_path_on_the_card_matches_the_cpu(dev):
    """GroupedAggKernel end to end, card against CPU: flushes, a
    retractable-MIN/MAX patch, an eviction and a reload give the same
    decoded groups (compared key-sorted)."""
    specs = tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                  for k, d in [("max", np.int64), ("sum", np.float64),
                               ("sum", np.int64), ("count", None)])
    rng = np.random.default_rng(13)
    ks = {d: H.GroupedAggKernel(KW, specs, capacity=1 << 12, device=d)
          for d in ("cuda", "cpu")}
    g = rng.integers(0, 900, 4096).astype(np.int64)
    v = rng.integers(-10**6, 10**6, 4096)
    args = (_lanes(g), np.ones(4096, np.int32), np.ones(4096, bool),
            [(s.encode_input(v.astype(np.float64) if s.is_float_sum else v),
              np.ones(4096, bool)) if s.in_dtype is not None else ((), None)
             for s in specs])

    def flushed(k):
        fr = k.flush()
        order = np.lexsort(fr.keys.T[::-1])
        return fr, order

    out = {}
    for d, k in ks.items():
        k.apply(*args)
        fr, order = flushed(k)
        decoded = [(np.full(fr.n, 7), fr.nns[0])] + [None] * 3
        k.patch_accs(decoded, fr.raw_accs)
        k.advance()
        k.evict_keys(_lanes(np.arange(0, 900, 3)))
        k.load_groups(_lanes(np.arange(0, 300, 3)),
                      np.full(100, 2), [np.full(100, 9), np.full(100, 1),
                                        np.full(100, 1.5), np.full(100, 1),
                                        np.full(100, 4), np.full(100, 1),
                                        np.full(100, 2)])
        k.apply(*args)
        fr2, order2 = flushed(k)
        out[d] = (fr.keys[order], [o[order] for o in fr.outs[::2]],
                  fr2.keys[order2], [o[order2] for o in fr2.outs],
                  fr2.was_emitted[order2])
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[4], b[4])
    for x, y in zip(a[1] + a[3][::2] + a[3][3:], b[1] + b[3][::2] + b[3][3:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(a[3][1], b[3][1], rtol=1e-6)


# -- join kernels (K5, K6, K7) -------------------------------------------------

JKW = 6           # two int64 keys: (hi, lo, valid) each
JP = 6            # two payload columns
ROWS = 1 << 14


def _join_epoch(rng, n, next_ref, live, key_range):
    """[key lanes | payload] and aux of one epoch: inserts (with many
    same-key rows), deletes of live refs, probe and negative rows."""
    g = rng.integers(0, key_range, n)
    keys = np.concatenate([_lanes(g), _lanes(g % 7)], axis=1)
    up = np.concatenate(
        [keys, rng.integers(-2**31, 2**31, (n, JP)).astype(np.int32)], 1)
    aux = np.zeros((n, 4), np.int32)
    ins = rng.random(n) < 0.6
    cand = np.asarray(sorted(live), np.int32)
    rng.shuffle(cand)
    dels = np.zeros(n, bool)
    drows = np.flatnonzero(~ins & (rng.random(n) < 0.5))[:len(cand)]
    dels[drows] = True
    aux[drows, J.AUX_DEL_REF] = cand[:len(drows)]
    irows = np.flatnonzero(ins)
    aux[irows, J.AUX_INS_REF] = np.arange(next_ref, next_ref + len(irows))
    probe = rng.random(n) < 0.9
    neg = dels | (rng.random(n) < 0.1)
    aux[:, J.AUX_FLAGS] = (probe * J.FLAG_PROBE + ins * J.FLAG_INS
                           + dels * J.FLAG_DEL + neg * J.FLAG_NEG)
    aux[:, J.AUX_SEQ] = np.sort(rng.integers(1, 10**6, n)).astype(np.int32)
    live = (live - set(cand[:len(drows)].tolist())) | set(
        aux[irows, J.AUX_INS_REF].tolist())
    return up, aux, next_ref + len(irows), live


def _join_states(dev, epochs=3, n=N, key_range=1500, seed=0):
    """The same epochs applied by the kernels (K1 + K5) and by the plain
    versions, on the card. Returns both (table, chains, pay)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        out.append([ht.make_state(CAP, JKW, dev),
                    J.make_chains(CAP, ROWS, dev),
                    torch.zeros((ROWS, JP), dtype=torch.int32, device=dev)])
    next_ref, live = 0, set()
    for _ in range(epochs):
        up, aux, next_ref, live = _join_epoch(rng, n, next_ref, live,
                                              key_range)
        u, a = torch.from_numpy(up).to(dev), torch.from_numpy(aux).to(dev)
        k, p = out
        k[0], k[1], k[2], ks = J.epoch_apply(*k, u, a, JKW)
        p[0], p[1], p[2], ps = J.epoch_apply_plain(*p, u, a, JKW)
        assert ks.tolist() == ps.tolist()
    return out


def _head_by_key(table, chains):
    occ = table.occ.cpu().numpy() != 0
    keys = table.keys.cpu().numpy()[occ]
    head = chains.head.cpu().numpy()[occ]
    order = np.lexsort(keys.T[::-1])
    return keys[order], head[order]


def test_join_apply_builds_the_plain_chains_per_key(dev):
    k, p = _join_states(dev)
    for a, b in zip(_head_by_key(k[0], k[1]), _head_by_key(p[0], p[1])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(k[1][1:], p[1][1:]):           # next, ins/del seqs
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(k[2].cpu().numpy(), p[2].cpu().numpy())
    assert int((k[1].head >= 0).sum()) > 0


def test_join_apply_hot_key_chain_order(dev):
    """Every row of the batch on one key: the chain must list them in
    batch order, then the old chain."""
    k, p = _join_states(dev, epochs=2, key_range=1)
    for a, b in zip(_head_by_key(k[0], k[1]), _head_by_key(p[0], p[1])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(k[1].next.cpu().numpy(),
                                  p[1].next.cpu().numpy())


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("out_cap", [1 << 6, 1 << 16])
def test_join_probe_matches_plain(dev, with_degrees, out_cap):
    k, p = _join_states(dev)
    rng = np.random.default_rng(5)
    up, aux, _n, _l = _join_epoch(rng, N, ROWS - N, set(), 1500)
    u, a = torch.from_numpy(up).to(dev), torch.from_numpy(aux).to(dev)
    ds0 = torch.from_numpy(rng.integers(0, 9, ROWS).astype(np.int32)).to(dev)
    dk0 = torch.from_numpy(rng.integers(0, 9, ROWS).astype(np.int32)).to(dev)
    km = J.epoch_probe(*k, ds0, dk0, u, a, JKW, out_cap, with_degrees)
    pm = J.epoch_probe_plain(*p, ds0, dk0, u, a, JKW, out_cap,
                             with_degrees)
    for x, y in zip(km, pm):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    total = int(km[0][0, 0])
    assert total > 0 and (total > out_cap) == (out_cap == 1 << 6)


def test_probe_pairs_matches_plain(dev):
    k, p = _join_states(dev)
    rng = np.random.default_rng(6)
    g = rng.integers(0, 3000, N)
    q = torch.from_numpy(np.concatenate([_lanes(g), _lanes(g % 7)],
                                        1)).to(dev)
    vis = torch.from_numpy((rng.random(N) < 0.9).astype(np.int32)).to(dev)
    for with_degrees in (False, True):
        km, ks = J.probe_pairs(k[0], k[1], q, vis, 500_000, 1 << 14,
                               with_degrees)
        pm, ps = J.probe_pairs_plain(p[0], p[1], q, vis, 500_000, 1 << 14,
                                     with_degrees)
        np.testing.assert_array_equal(km.cpu().numpy(), pm.cpu().numpy())
        assert ks.tolist() == ps.tolist() == [0, 0]


@pytest.mark.parametrize("case", KC.K6_CASES)
def test_join_probe_edge_cases_match_plain(dev, case):
    """K6 on its edge cases (ops/kernel_cases.py), on a side the plain
    versions built on the card: chains of 0, 1 and 60 refs, refs
    invisible at the row's seq on either side, a pair buffer the pairs
    fill exactly or overflow by one, rows that fill no 256-row tile, no
    rows, the degree branch, absent keys whose probe wraps. Matrix,
    degree arrays and stats exact."""
    c = KC.k6_cases()[case]
    t = ht.make_state(c["cap"], KC.J_KW, dev)
    ch = J.make_chains(c["cap"], c["rows"], dev)
    pay = torch.zeros((c["rows"], KC.J_P), dtype=torch.int32, device=dev)
    for up, aux in c["stored"]:
        t, ch, pay, _s = J.epoch_apply_plain(
            t, ch, pay, torch.from_numpy(up).to(dev),
            torch.from_numpy(aux).to(dev), KC.J_KW)
    rng = np.random.default_rng(18)
    ds, dk = (torch.from_numpy(rng.integers(0, 5, c["rows"])
                               .astype(np.int32)).to(dev) for _ in range(2))
    u, a = (torch.from_numpy(x).to(dev) for x in c["probe"])
    total = int(J.epoch_probe_plain(t, ch, pay, ds, dk, u, a, KC.J_KW,
                                    1 << 14, False)[0][0, 0])
    out_cap = KC.resolve_out_cap(c["out_cap"], total)
    wd = c["with_degrees"]
    got = J.epoch_probe(t, ch, pay, ds, dk, u, a, KC.J_KW, out_cap, wd)
    want = J.epoch_probe_plain(t, ch, pay, ds, dk, u, a, KC.J_KW, out_cap,
                               wd)
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert int(got[0][0, 0]) == total


@pytest.mark.parametrize("n_shards", KC.K1_SHARDS)
def test_sharded_join_probe_edge_cases_match_plain(dev, n_shards):
    """Sharded K6 with the row-id map on receive blocks that are mostly
    empty (one row in ten routed), rows that fill no tile (1,000 a
    shard), a hot key's chain, with and without degree rows, at a scalar
    and at per-row sequences, and with a pair buffer too small."""
    rng = np.random.default_rng(34 + n_shards)
    n = 1000
    table, chains, _k, _v, _r = _sharded_join_state(dev, rng, s=n_shards,
                                                    n=n)
    keys, valid = _recv_block(rng, n_shards, n)
    valid &= rng.random(valid.shape) < 0.15
    keys[~valid] = 0
    vis = torch.from_numpy(valid.astype(np.int32)).to(dev)
    kd = torch.from_numpy(keys).to(dev)
    rid = torch.from_numpy(rng.permutation(n_shards * n)
                           .reshape(n_shards, n).astype(np.int32)).to(dev)
    rseq = torch.from_numpy(rng.integers(0, 3, (n_shards, n))
                            .astype(np.int32)).to(dev)
    for seq, out_cap, deg in ((2, 1 << 10, True), (rseq, 1 << 10, False),
                              (J.I32_MAX, 8, True)):
        got = J.join_probe_sharded(table, chains, kd, vis, -1, seq, out_cap,
                                   deg, rid=rid, rvalid=vis)
        want = J.join_probe_sharded_plain(table, chains, kd, vis, -1, seq,
                                          out_cap, deg, rid=rid, rvalid=vis)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


def test_join_maint_matches_plain(dev):
    rng = np.random.default_rng(7)
    for shape in ((ROWS,), (ROWS, JP)):
        arr = torch.from_numpy(rng.integers(-9, 9, shape)
                               .astype(np.int32)).to(dev)
        refs = torch.from_numpy(rng.permutation(ROWS)[:N]
                                .astype(np.int32)).to(dev)
        vis = torch.from_numpy((rng.random(N) < 0.8)
                               .astype(np.int32)).to(dev)
        vals = torch.from_numpy(rng.integers(-2**31, 2**31, (N,) + shape[1:])
                                .astype(np.int32)).to(dev)
        a = J._masked_scatter(arr.clone(), refs, vis, vals)
        b = J._masked_scatter_plain(arr.clone(), refs, vis, vals)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    k, _p = _join_states(dev)
    c1 = J.ChainState(*(t.clone() for t in k[1]))
    c2 = J.ChainState(*(t.clone() for t in k[1]))
    J._rebase(c1)
    J._rebase_plain(c2)
    for x, y in zip(c1, c2):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    # head remap on growth (K4 remap): per key, the same head
    new = ht.make_state(2 * CAP, JKW, dev)
    _t, o2n, _s = ht.probe_insert(new, k[0].keys, k[0].occ)
    head2 = J._remap_head(k[1].head, o2n, 2 * CAP, new.occ)
    np.testing.assert_array_equal(
        head2.cpu().numpy(),
        J._remap_head_plain(k[1].head, o2n, 2 * CAP).cpu().numpy())
    for a, b in zip(_head_by_key(new, k[1]._replace(head=head2)),
                    _head_by_key(k[0], k[1])):
        np.testing.assert_array_equal(a, b)


# -- the fused preludes (csrc/fused.cu) ----------------------------------------


def _k7_operand(dev, host: np.ndarray, layout: str, rng) -> torch.Tensor:
    """``host`` on the card as K7 meets it: dense, as a view that starts
    one int past an allocation (off every 16-byte boundary), or as a
    column (lanes) of a wider matrix, rows 3 + lanes ints apart."""
    t = torch.from_numpy(host).to(dev)
    if layout == "dense":
        return t
    lanes_ = 1 if host.ndim == 1 else host.shape[1]
    if layout == "offset":
        buf = torch.from_numpy(rng.integers(-9, 9, host.size + 1)
                               .astype(np.int32)).to(dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(host.shape)
    wide = torch.from_numpy(rng.integers(-9, 9, (host.shape[0], lanes_ + 3))
                            .astype(np.int32)).to(dev)
    wide[:, 1:1 + lanes_] = t.reshape(host.shape[0], lanes_)
    return wide[:, 1] if host.ndim == 1 else wide[:, 1:1 + lanes_]


@pytest.mark.parametrize("layout", ["dense", "offset", "strided"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [1, JP])
@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_masked_scatter_modes_match_plain(dev, mode, width, masked,
                                          layout):
    """K7's scatter by ref and its gather-carry, with no visibility array
    and with a mask, against their plain versions on the same inputs: refs,
    vis and values dense, off a 16-byte boundary, or strided columns (an
    aux column, K6's degree column, payload lanes inside wider rows), at
    the paths' 1,536, 6,931 and 40,000 rows and at counts that are not a
    multiple of 4; negative and out-of-range refs dropped; one launch a
    call."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    rng = np.random.default_rng(31 + width)
    rows = 1 << 16
    shape = (rows,) if width == 1 else (rows, width)
    for n in (1, 3, 1536, 6931, 40_000, 40_001):
        idx = rng.permutation(rows)[:n].astype(np.int32)
        bad = np.flatnonzero(rng.random(n) < 0.05)
        idx[bad] = np.where(rng.random(len(bad)) < 0.5, -1 - bad,
                            rows + bad).astype(np.int32)
        vis = (rng.random(n) < 0.8).astype(np.int32) if masked else None
        arr = torch.from_numpy(rng.integers(-2**31, 2**31, shape)
                               .astype(np.int32)).to(dev)
        src_rows = n if mode == "scatter" else rows
        src = _k7_operand(dev, rng.integers(-2**31, 2**31, (src_rows,)
                                            + shape[1:]).astype(np.int32),
                          layout, rng)
        i_t = _k7_operand(dev, idx, layout, rng)
        v_t = None if vis is None else _k7_operand(dev, vis, layout, rng)
        LAUNCHES.reset()
        if mode == "scatter":
            got = J._masked_scatter(arr.clone(), i_t, v_t, src)
            want = J._masked_scatter_plain(arr.clone(), i_t, v_t, src)
        else:
            got = J._gather_carry(arr.clone(), src, i_t, v_t)
            want = J._gather_carry_plain(arr.clone(), src, i_t, v_t)
        assert LAUNCHES.snapshot().get("masked_scatter", 0) == 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        assert n < 4 or not torch.equal(got, arr)


def test_rebuild_payload_rides_in_join_apply(dev):
    """JoinSideKernel.rebuild on the card against the same rebuild on the
    CPU (the plain versions): a recovery's rebuild (refs in any order)
    launches K1 + K5 once each, its payload lanes written in K5's launch,
    and no K7; a compaction's rebuild adds one K7 gather that carries the
    live rows' degrees on the card. Heads per key, next, sequences,
    payload and degrees equal; K6's degree column (probe_degrees, no pair
    buffer) equals the CPU's too."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    rng = np.random.default_rng(33)
    n0, n1 = 6000, 2500
    keys0 = np.concatenate([_lanes(rng.integers(0, 900, n0)),
                            _lanes(rng.integers(0, 3, n0))], axis=1)
    refs0 = rng.permutation(3 * n0)[:n0].astype(np.int32)
    pay0 = rng.integers(-2**31, 2**31, (n0, JP)).astype(np.int32)
    degv = rng.integers(0, 50, n0).astype(np.int32)
    live = np.sort(rng.choice(refs0, n1, replace=False)).astype(np.int32)
    pos = {int(r): i for i, r in enumerate(refs0)}
    at = np.asarray([pos[int(r)] for r in live])
    probe_keys = np.concatenate([keys0[:500], keys0[:500] + 7])
    probe_vis = (rng.random(1000) < 0.8).astype(np.int32)
    sides, counts = {}, []
    for d in (dev, torch.device("cpu")):
        k = J.JoinSideKernel(JKW, key_capacity=1 << 12,
                             row_capacity=1 << 12, payload_width=JP,
                             device=d)
        LAUNCHES.reset()
        k.rebuild(keys0, refs0, pay0)
        counts.append(LAUNCHES.snapshot())
        k.write_degrees(torch.from_numpy(refs0).to(d),
                        torch.from_numpy(degv).to(d))
        LAUNCHES.reset()
        k.rebuild(keys0[at], np.arange(n1, dtype=np.int32), pay0[at],
                  carry=live)
        counts.append(LAUNCHES.snapshot())
        sides[d.type] = (k, k.probe_degrees(probe_keys, probe_vis).cpu())
    (kc, dc), (kp, dp) = sides["cuda"], sides["cpu"]
    for a, b in zip(_head_by_key(kc.table.state, kc.chains),
                    _head_by_key(kp.table.state, kp.chains)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((*kc.chains[1:], kc.pay, kc.deg),
                    (*kp.chains[1:], kp.pay, kp.deg)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(kc.deg[:n1].cpu().numpy(), degv[at])
    np.testing.assert_array_equal(dc.numpy(), dp.numpy())
    assert dc.numpy().any() and not dc.numpy()[probe_vis == 0].any()
    for c, k7 in zip(counts[:2], (0, 1)):
        assert c.get("join_apply", 0) == 1 and c.get("probe_insert", 0) == 1
        assert c.get("masked_scatter", 0) == k7


def _fused_case(dev, seed, edges, n=1 << 12):
    fs, chunk = FC.port_case(seed, n, edges, separators=8)
    raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols))
    hs = fs.host_noop_eq(chunk)
    hs = None if hs is None else torch.from_numpy(hs.astype(np.int8))
    return fs, chunk, raw, hs


@pytest.mark.parametrize("edges", [False, True])
def test_fused_chain_matches_plain(dev, edges):
    for seed in range(12):
        fs, chunk, raw, hs = _fused_case(dev, seed, edges)
        prog = F.compile_program(fs, F.MODE_CHAIN)
        ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
        cp = torch.zeros(prog.n_counts, dtype=torch.int64)
        got = F.fused_chain(prog, raw.to(dev), None if hs is None
                            else hs.to(dev), ck)
        want = F.run_program_plain(prog, raw, hs, cp)
        assert FC.mismatch(prog, got.cpu().numpy(), want.numpy(),
                           None) == 0, seed
        np.testing.assert_array_equal(ck.cpu().numpy(), cp.numpy())


def test_agg_and_join_preludes_match_plain(dev):
    for seed in range(12):
        fs, chunk, raw, _hs = _fused_case(dev, seed, edges=True)
        nan_rows = FC.nan_rows_of(fs, chunk)
        g, calls, specs = FC.agg_plan(fs, seed)
        prog = F.compile_program(fs, F.MODE_AGG, group_indices=g,
                                 agg_calls=calls, specs=specs)
        ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
        cp = torch.zeros(prog.n_counts, dtype=torch.int64)
        got = F.agg_prelude(prog, raw.to(dev), ck)
        want = F.run_program_plain(prog, raw, None, cp)
        assert FC.mismatch(prog, got.cpu().numpy(), want.numpy(),
                           nan_rows) == 0, seed
        np.testing.assert_array_equal(ck.cpu().numpy(), cp.numpy())
        keys, pays = FC.join_plan(fs, seed)
        jp = F.compile_program(fs, F.MODE_JOIN, key_indices=keys,
                               pay_indices=pays)
        got = F.join_prelude(jp, raw.to(dev))
        want = F.run_program_plain(jp, raw)
        assert FC.mismatch(jp, got.cpu().numpy(), want.numpy(),
                           nan_rows) == 0, seed


@pytest.mark.parametrize("name", sorted(FC.EDGE_CASES))
def test_fused_edge_cases_match_plain(dev, name):
    """The fused kernel at its tile edges (``fused_cases.EDGE_CASES`` at
    their card sizes, which reach the 64- and 128-row tiles, with edge
    and subnormal values): every entry point the case allows against the
    plain program on the same card tensors, bit for bit (a NaN equal to a
    NaN), the stage counts exact."""
    fs, chunk, seg = FC.edge_case(name, True, True, subnormals=True)
    raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols)).to(dev)
    nan_rows = FC.nan_rows_of(fs, chunk)
    hs = torch.from_numpy(fs.host_noop_eq(chunk).astype(np.int8)).to(dev)
    for entry, prog in FC.edge_programs(name, fs).items():
        (got, ck), (want, cp) = FC.run_both(entry, prog, raw, hs, seg)
        assert FC.mismatch(prog, got.cpu().numpy(), want.cpu().numpy(),
                           nan_rows) == 0, entry
        if ck is not None:
            np.testing.assert_array_equal(ck.cpu().numpy(),
                                          cp.cpu().numpy())


def _q3_tpch_cols(n):
    from risingwave_tpu_torch.connectors import tpch
    cfg = tpch.TpchConfig(customers=150_000, orders=1_500_000)
    li = tpch.gen_lineitem(np.arange(n, dtype=np.int64) + 3_000_000, cfg)
    od = tpch.gen_orders(li["l_orderkey"] - 1, cfg)
    cols = {k: li[k] for k in ("l_orderkey", "l_extendedprice",
                               "l_discount")}
    cols.update(o_orderdate=od["o_orderdate"],
                o_shippriority=od["o_shippriority"])
    return cols


@pytest.mark.parametrize("case", ["q5_hot", "q3_tpch", "q3_signed"])
def test_pipeline_agg_preludes_match_plain(dev, case):
    """agg_prelude on two pipelines' own programs at their path shapes,
    bit for bit against the plain program, stage counts exact: q5-hot's
    hop of 5 copies (7 bid chunks of 4,096 rows, separators, a 2^15-row
    batch: 163,840 expanded rows) and q3's DECIMAL revenue (OP_DECMUL)
    on TPC-H SF1 lineitems and on signed, wide DECIMALs (truncation
    toward zero)."""
    if case == "q5_hot":
        prog, raw, _fs = PC.q5_hot_agg_case(first=4_600_000)
        assert prog.units == 5
    else:
        cols = _q3_tpch_cols(30_000) if case == "q3_tpch" \
            else PC.signed_revenue_cols(30_000, seed=5)
        prog, raw, _fs = PC.q3_revenue_agg_case(cols)
        assert F.OP_DECMUL in prog.opcodes()
    raw = torch.from_numpy(raw)
    ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
    cp = torch.zeros(prog.n_counts, dtype=torch.int64)
    got = F.agg_prelude(prog, raw.to(dev), ck)
    want = F.run_program_plain(prog, raw, None, cp)
    assert got.shape == want.shape == (prog.units * raw.shape[0],
                                       prog.out_width)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(ck.cpu().numpy(), cp.numpy())


# -- the sharded path: route and the shard axis of K1-K4 -------------------------

S = 8


@pytest.mark.parametrize("n_shards,bucket", [(8, None), (8, 16), (3, None)])
def test_route_matches_plain(dev, n_shards, bucket):
    """The receive buffer, its flags and the overflow flags bit for bit
    (input order inside each bucket, zeros in the unused rows)."""
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    local = 2500
    packed = np.ascontiguousarray(np.tile(_batch(7), (n_shards, 1))[
        :n_shards * local])
    rows = torch.from_numpy(packed).to(dev)
    omap = torch.from_numpy(contiguous_owner_map(n_shards)).to(dev)
    valid = rows[:, KW + 1]
    b = bucket or local
    got = X.route(rows, valid, omap, n_shards, b, KW)
    want = X.route_plain(rows, valid, omap, n_shards, b, KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert bool(got[2].any()) == (bucket is not None)


@pytest.mark.parametrize("case", KC.ROUTE_CASES)
def test_route_edge_cases_match_plain(dev, case):
    """route at the edges of its tiling (ops/kernel_cases.py): every row
    to one owner, uniform owners, 3 shards, a block that is not a whole
    number of 256-row chunks, tiles of several chunks, an overflowing
    bucket, bucket 0 and empty blocks. All three outputs bit for bit."""
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    rows_np, valid_np, n_shards, bucket = KC.route_cases()[case]
    rows = torch.from_numpy(rows_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    omap = torch.from_numpy(contiguous_owner_map(n_shards)).to(dev)
    got = X.route(rows, valid, omap, n_shards, bucket, KW)
    want = X.route_plain(rows, valid, omap, n_shards, bucket, KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    assert bool(got[2].any()) == (case in ("overflow", "bucket_0"))


def _sharded_applied(dev):
    """A mixed batch routed to S shards of CAP slots (kernels)."""
    from risingwave_tpu_torch.parallel import exchange as X
    from risingwave_tpu_torch.parallel.mesh import contiguous_owner_map
    packed = torch.from_numpy(np.concatenate([_batch(s) for s in range(S)])
                              ).to(dev)
    omap = torch.from_numpy(contiguous_owner_map(S)).to(dev)
    recv, rvalid, ovf = X.route(packed, packed[:, KW + 1], omap, S, N, KW)
    assert not bool(ovf.any())
    st = H.make_sharded_agg_state(S, CAP, KW, _specs(), dev)
    slots, stats = ht.probe_insert_sharded(st.table, recv[:, :, :KW], rvalid)
    assert not bool(stats[:, 1].any())
    return st, slots, recv, rvalid


def test_sharded_probe_insert_invariants(dev):
    st, slots, recv, rvalid = _sharded_applied(dev)
    ref = H.make_sharded_agg_state(S, CAP, KW, _specs(), dev)
    _ps, pstats = ht.probe_insert_sharded_plain(ref.table, recv[:, :, :KW],
                                                rvalid)
    for s in range(S):
        sl = slots[s].cpu().numpy()
        v = rvalid[s].cpu().numpy() != 0
        keys = recv[s, :, :KW].cpu().numpy()
        k = st.table.keys[s].cpu().numpy()
        assert (sl[~v] == -1).all() and (sl[v] >= 0).all()
        assert (k[sl[v]] == keys[v]).all()

        def keyset(t):
            x = t.keys[s].cpu().numpy()[t.occ[s].cpu().numpy() != 0]
            return x[np.lexsort(x.T[::-1])]
        np.testing.assert_array_equal(keyset(st.table), keyset(ref.table))
    occ = (st.table.occ != 0).sum(dim=1).cpu().numpy()
    np.testing.assert_array_equal(occ, pstats[:, 0].cpu().numpy())


def test_sharded_agg_kernels_match_plain(dev):
    """K2-K4 with a shard axis against their plain versions on the same
    slots: integers exact, float SUM within rel 1e-6 of Σ|terms|."""
    st, slots, recv, _rv = _sharded_applied(dev)
    plan = H.ApplyPlan(KW, _specs(), dev)
    a = H.ShardedAggState(st.table, st.st.clone())
    b = H.ShardedAggState(st.table, st.st.clone())
    H.agg_apply_sharded(a, recv, slots, plan)
    H.agg_apply_sharded_plain(b, recv, slots, plan)
    x, y = a.st.cpu().numpy(), b.st.cpu().numpy()
    f = [H.ROW_ACC0 + 5, H.ROW_ACC0 + 6]
    ints = [r for r in range(x.shape[1]) if r not in f]
    np.testing.assert_array_equal(x[:, ints], y[:, ints])
    for row in f:
        err = np.abs(x[:, row].view(np.float32).astype(np.float64)
                     - y[:, row].view(np.float32).astype(np.float64))
        assert float(err.max()) <= 1e-6 * 100 * N
    for fc in (1 << 12, 64):
        np.testing.assert_array_equal(
            H.flush_gather_sharded(b, fc).cpu().numpy(),
            H.flush_gather_sharded_plain(b, fc).cpu().numpy())
    c = H.ShardedAggState(b.table, b.st.clone())
    H.advance_sharded(c)
    for s in range(S):
        H.advance_plain(b.shard(s))
    np.testing.assert_array_equal(c.st.cpu().numpy(), b.st.cpu().numpy())
    hi, lo = lanes.split_i64(np.asarray([1000 * 31], dtype=np.int64))
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE):
        live = H.live_mask_sharded(b, mode, 0, int(hi[0]), int(lo[0]))
        want = torch.stack([H.live_mask_plain(b.shard(s), mode, 0, int(hi[0]),
                                              int(lo[0])) for s in range(S)])
        np.testing.assert_array_equal(live.cpu().numpy(), want.cpu().numpy())
    fill = torch.tensor(H.state_fills(_specs()), dtype=torch.int32,
                        device=dev)
    table = ht.TableState(
        torch.zeros((S, 2 * CAP, KW), dtype=torch.int32, device=dev),
        torch.zeros((S, 2 * CAP), dtype=torch.int32, device=dev))
    o2n, _s = ht.probe_insert_sharded(table, b.table.keys, live)
    np.testing.assert_array_equal(
        H.remap_sharded(b.st, o2n, table.occ, fill, 2 * CAP).cpu().numpy(),
        torch.stack([H.remap_plain(b.st[s], o2n[s], table.occ[s], fill,
                                   2 * CAP) for s in range(S)]).cpu().numpy())


def test_agg_prelude_segments_match_plain(dev):
    """agg_prelude with a segment length: each block its own ring for the
    U-/U+ pair rules, bit for bit against the plain program."""
    for seed in range(4):
        fs, chunk = FC.port_case(seed, 1 << 12, True, separators=16)
        g, calls, specs = FC.agg_plan(fs, seed)
        prog = F.compile_program(fs, F.MODE_AGG, group_indices=g,
                                 agg_calls=calls, specs=specs)
        if prog.units != 1:
            continue
        raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols)) \
            .to(dev)
        for seg in (8, 512):
            ck = torch.zeros(prog.n_counts, dtype=torch.int64, device=dev)
            cp = ck.clone()
            got = F.agg_prelude(prog, raw, ck, seg=seg)
            want = F.run_program_plain(prog, raw, None, cp, seg=seg)
            assert FC.mismatch(prog, got.cpu().numpy(), want.cpu().numpy(),
                               FC.nan_rows_of(fs, chunk)) == 0
            np.testing.assert_array_equal(ck.cpu().numpy(), cp.cpu().numpy())


def test_sharded_kernel_on_the_card_matches_the_cpu(dev):
    """ShardedAggKernel end to end, card against CPU: the same snapshots
    after growth, flushes, retirement, a reshard and a rebuild (integer
    plan: the card's slots differ, its decoded groups do not), and one
    routed step launches route, probe_insert and agg_apply as often at 8
    shards as at 1."""
    from risingwave_tpu_torch.parallel import ShardedAggKernel, ShardMesh
    from risingwave_tpu_torch.utils.device import LAUNCHES
    specs = tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                  for k, d in [("sum", np.int64), ("max", np.int64),
                               ("count", None)])
    rng = np.random.default_rng(4)
    kernels = {d: ShardedAggKernel(ShardMesh(S, d), KW, specs, capacity=256)
               for d in ("cuda", "cpu")}
    for _e in range(3):
        g = rng.integers(0, 3000, 2048).astype(np.int64) * 13
        v = rng.integers(-10**9, 10**9, 2048)
        args = (_lanes(g), np.ones(2048, np.int32), np.ones(2048, bool),
                [(specs[0].encode_input(v), np.ones(2048, bool)),
                 (specs[1].encode_input(v), np.ones(2048, bool)),
                 ((), None)])
        for k in kernels.values():
            k.apply(*args)
            k.flush()
            k.advance()
    snaps = [k.snapshot() for k in kernels.values()]
    assert snaps[0] == snaps[1] and kernels["cuda"].capacity > 256
    for k in kernels.values():
        k.retire_below(0, 1500 * 13)
        k.reshard(np.roll(k.mesh.owner_map(), 11))
    snaps = [k.snapshot() for k in kernels.values()]
    assert snaps[0] == snaps[1] and snaps[0]
    n = 500
    keys = _lanes(np.arange(n, dtype=np.int64) * 7)
    accs = [rng.integers(-10**9, 10**9, n), np.ones(n, np.int64),
            rng.integers(-10**9, 10**9, n), np.ones(n, np.int64),
            rng.integers(1, 9, n)]
    for k in kernels.values():
        k.rebuild(keys, np.ones(n, np.int64), accs)
    assert kernels["cuda"].snapshot() == kernels["cpu"].snapshot()
    steps = {}
    for n_shards in (1, S):
        k = ShardedAggKernel(ShardMesh(n_shards, "cuda"), KW, specs,
                             capacity=1 << 12)
        k.apply(*args)
        LAUNCHES.reset()
        k._dispatch_backlog()
        steps[n_shards] = LAUNCHES.snapshot()
    assert steps[1] == steps[S]
    assert steps[S]["route"] == 1 and steps[S]["probe_insert"] == 1


# -- the sharded join: K5 and K6 with a shard axis, B16 -----------------------


def _recv_block(rng, s, n, hot=True):
    """A receive block as route leaves it: [S, n] rows, ~40% empty (zero
    lanes and flags, ref 0), insert rows with in-block duplicates and a
    hot key, delete rows of refs stored by the first call."""
    valid = rng.random((s, n)) < 0.6
    g = rng.integers(0, 4000, (s, n))
    if hot:
        g[rng.random((s, n)) < 0.05] = 77
    keys = _lanes(g.reshape(-1)).reshape(s, n, KW)
    keys[~valid] = 0
    return keys, valid


def _sharded_join_state(dev, rng, s=S, n=N, rows=1 << 15):
    """Sharded chains after one insert block (kernels): (table, chains,
    keys, valid, refs)."""
    keys, valid = _recv_block(rng, s, n)
    refs = np.zeros((s, n), np.int32)
    refs[valid] = np.arange(int(valid.sum()))
    table = ht.TableState(
        torch.zeros((s, CAP, KW), dtype=torch.int32, device=dev),
        torch.zeros((s, CAP), dtype=torch.int32, device=dev))
    chains = J.ChainState(
        torch.full((s, CAP), -1, dtype=torch.int32, device=dev),
        *(torch.full((s, rows), v, dtype=torch.int32, device=dev)
          for v in (-1, J.I32_MAX, J.I32_MAX)))
    kd, vd = torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)
    slots, stats = ht.probe_insert_sharded(table, kd, vd.to(torch.int32))
    assert not bool(stats[:, 1].any())
    J.join_apply_sharded(chains, slots, ins_ok=vd.to(torch.int32),
                         ins_ref=torch.from_numpy(refs).to(dev), seq=1)
    return table, chains, keys, valid, refs


def test_sharded_join_apply_matches_plain(dev):
    """Sharded K5 (S = 8) against its plain version on the same slots:
    inserts with a hot key and in-block duplicates, tombstones of stored
    refs, empty received rows, per-row sequences; every array exact, and
    exact again when a second batch reuses the bucket words (no launch
    restores them: each takes a new generation)."""
    rng = np.random.default_rng(31)
    table, chains, _k, valid0, refs0 = _sharded_join_state(dev, rng)
    keys, valid = _recv_block(rng, S, N)
    ins = valid & (rng.random((S, N)) < 0.6)
    dels = valid & ~ins
    flags = (ins * J.FLAG_INS + dels * J.FLAG_DEL).astype(np.int32)
    ins_ref = np.zeros((S, N), np.int32)
    ins_ref[ins] = 100_000 + np.arange(int(ins.sum()))
    del_ref = np.zeros((S, N), np.int32)
    del_ref[dels] = rng.choice(refs0[valid0], int(dels.sum()), replace=False)
    seq = torch.from_numpy(rng.integers(2, 50, (S, N)).astype(np.int32)) \
        .to(dev)
    f = torch.from_numpy(flags).to(dev)
    slots, _st = ht.probe_insert_sharded(table, torch.from_numpy(keys).to(dev),
                                         f & J.FLAG_INS)
    kw = dict(ins_ok=f, ins_bits=J.FLAG_INS,
              ins_ref=torch.from_numpy(ins_ref).to(dev), del_ok=f,
              del_bits=J.FLAG_DEL, del_ref=torch.from_numpy(del_ref).to(dev),
              seq=seq)
    a = J.ChainState(*(t.clone() for t in chains))
    b = J.ChainState(*(t.clone() for t in chains))
    scratch = J.link_scratch(chains.head)
    for _ in range(2):
        J.join_apply_sharded(a, slots, scratch=scratch, **kw)
        J.join_apply_sharded_plain(b, slots, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert scratch.gen == 2


def test_sharded_join_probe_matches_plain(dev):
    """Sharded K6 (S = 8) with the row-id map against its plain version:
    with and without degree rows, at a scalar and at per-row sequences,
    and with a pair buffer too small (each header its TRUE total)."""
    rng = np.random.default_rng(32)
    table, chains, _k, _v, _r = _sharded_join_state(dev, rng)
    keys, valid = _recv_block(rng, S, N)
    vis = torch.from_numpy(valid.astype(np.int32)).to(dev)
    kd = torch.from_numpy(keys).to(dev)
    rid = torch.from_numpy(rng.permutation(S * N).reshape(S, N)
                           .astype(np.int32)).to(dev)
    rseq = torch.from_numpy(rng.integers(0, 3, (S, N)).astype(np.int32)) \
        .to(dev)
    for seq, out_cap, deg in ((2, 1 << 14, True), (rseq, 1 << 14, False),
                              (J.I32_MAX, 64, True)):
        got = J.join_probe_sharded(table, chains, kd, vis, -1, seq, out_cap,
                                   deg, rid=rid, rvalid=vis)
        want = J.join_probe_sharded_plain(table, chains, kd, vis, -1, seq,
                                          out_cap, deg, rid=rid, rvalid=vis)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
        if out_cap == 64:
            assert int(got[0][:, 0, 0].max()) > 64


@pytest.mark.parametrize("n_shards", [1, S])
def test_apply_and_probe_matches_plain(dev, n_shards):
    """B16 per chunk: at S = 1 the launch sequence apply_and_probe (K6,
    K1, K5) against its plain version; at S = 8 ShardedJoinKernel's
    routed step. The probe outputs and the ref-indexed arrays exact, the
    heads per key."""
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    rng = np.random.default_rng(33)
    n = 4096
    if n_shards == 1:
        sides = {d: [J.JoinSideKernel(KW, 1 << 14, 1 << 14, 1 << 12,
                                      device=d) for _ in range(2)]
                 for d in (dev, "cpu")}
    else:
        sides = {d: [ShardedJoinKernel(ShardMesh(S, d), KW, 1 << 12,
                                       1 << 14, 1 << 12) for _ in range(2)]
                 for d in (dev, "cpu")}
    live = [[], []]
    for seq in range(1, 7):
        me = seq % 2
        g = rng.integers(0, 3000, n)
        g[rng.random(n) < 0.02] = 5
        kl = _lanes(g)
        pvis = rng.random(n) < 0.9
        ins = pvis & (rng.random(n) < 0.7)
        dels = pvis & ~ins
        refs = np.zeros(n, np.int32)
        refs[ins] = seq * n + np.arange(int(ins.sum()))
        drefs = np.zeros(n, np.int32)
        pos = np.flatnonzero(dels)
        k = min(len(pos), len(live[me]))
        dels[pos[k:]] = False
        for i, (r, row) in zip(pos[:k], live[me][:k]):
            drefs[i], kl[i] = r, row
        live[me] = live[me][k:] + list(zip(refs[ins].tolist(), kl[ins]))
        outs = [s[me].apply_and_probe(s[1 - me], kl, pvis, refs, ins, drefs,
                                      dels, seq).collect()
                for s in sides.values()]
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(*sides.values()):
        for x, y in zip(a.chains[1:], b.chains[1:]):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
        ta = a.table if n_shards > 1 else a.table.state
        tb = b.table if n_shards > 1 else b.table.state
        for s in range(n_shards):
            pa = _head_by_key(*_shard_of(ta, a.chains, s, n_shards))
            pb = _head_by_key(*_shard_of(tb, b.chains, s, n_shards))
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)


def _shard_of(table, chains, s, n_shards):
    if n_shards == 1:
        return table, chains
    return (ht.TableState(table.keys[s], table.occ[s]),
            J.ChainState(*(c[s] for c in chains)))


def test_sharded_join_kernel_on_the_card_matches_the_cpu(dev):
    """ShardedJoinKernel end to end, card against CPU: the same probe
    outputs and ref-indexed chains after per-chunk steps, epoch applies
    and probes with the skew bucket, key and row growth, a rebase and a
    rebuild; and each routed step launches the same kernels as often at 8
    shards as at 1."""
    from risingwave_tpu_torch.parallel import ShardedJoinKernel, ShardMesh
    from risingwave_tpu_torch.utils.device import LAUNCHES
    rng = np.random.default_rng(34)
    ks = {d: [ShardedJoinKernel(ShardMesh(S, d), KW, 1 << 10, 1 << 12,
                                1 << 8) for _ in range(2)]
          for d in (dev, "cpu")}
    next_ref = [0, 0]
    for epoch in range(4):
        staged = {d: {} for d in ks}
        for side in (0, 1):
            m = 3000 + 37 * epoch
            kl = _lanes(rng.integers(0, 20_000, m))
            aux = np.zeros((m, 4), np.int32)
            ins = rng.random(m) < 0.8
            aux[ins, J.AUX_INS_REF] = next_ref[side] + np.arange(
                int(ins.sum()))
            next_ref[side] += int(ins.sum())
            aux[:, J.AUX_FLAGS] = J.FLAG_PROBE + ins * J.FLAG_INS
            aux[:, J.AUX_SEQ] = 1 + epoch * 100 + np.arange(m) // 512
            for d, k in ks.items():
                staged[d][side] = k[side].stage_epoch(
                    kl, aux, m, int(aux[:, 0].max()), k[side].owners_of(kl))
        outs = {}
        for d, k in ks.items():
            for side, (u, a, b) in staged[d].items():
                k[side].apply_epoch(u, a, 0, -1, bucket=b)
            outs[d] = [k[1 - side].probe_epoch(u, a, False, bucket=b)
                       .collect() for side, (u, a, b) in staged[d].items()]
        for x, y in zip(*outs.values()):
            for p, q in zip(x, y):
                assert (p is None) == (q is None)
                if p is not None:
                    np.testing.assert_array_equal(p, q)
    assert ks[dev][0].key_capacity > 1 << 10
    assert ks[dev][0].row_capacity > 1 << 12
    for k in (*ks[dev], *ks["cpu"]):
        k.rebase_seq()
    for a, b in zip(ks[dev], ks["cpu"]):
        for x, y in zip(a.chains[1:], b.chains[1:]):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    q = _lanes(rng.integers(0, 20_000, 1000))
    kl = _lanes(rng.integers(0, 500, 2000))
    for k in (ks[dev][1], ks["cpu"][1]):
        k.rebuild(kl, np.arange(2000, dtype=np.int32))
    for p, r in zip(ks[dev][1].probe(kl[:500], np.ones(500, bool)),
                    ks["cpu"][1].probe(kl[:500], np.ones(500, bool))):
        np.testing.assert_array_equal(p, r)
    steps = {}
    for n_shards in (1, S):
        a, b = (ShardedJoinKernel(ShardMesh(n_shards, dev), KW)
                for _ in range(2))
        LAUNCHES.reset()
        a.apply_and_probe(b, q, np.ones(1000, bool),
                          np.arange(1000, dtype=np.int32),
                          np.ones(1000, bool), np.zeros(1000, np.int32),
                          np.zeros(1000, bool), 1).collect()
        steps[n_shards] = LAUNCHES.snapshot()
    assert steps[1] == steps[S]
    assert steps[S] == {"route": 1, "join_probe": 1, "probe_insert": 1,
                        "join_apply": 1}


# -- K4's mask with the fresh table, the patched advance, the drop rule ------

def _live_args(mode):
    hi, lo = lanes.split_i64(np.asarray([1000 * 31], dtype=np.int64))
    return (0, int(hi[0]), int(lo[0])) if mode == H.LIVE_RETIRE \
        else (0, 0, 0)


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("mode", [H.LIVE_GROW, H.LIVE_RETIRE, H.LIVE_EVICT,
                                  H.LIVE_OCCUPIED])
def test_live_mask_clears_the_fresh_table(dev, mode, grow):
    """K4's mask launch in each mode, with a fresh table of cap or 2 x cap
    slots: the mask equals live_mask_plain and the table, filled with
    garbage before the launch, comes back zeroed, keys and occ; the
    wrapper (``live_and_table``) agrees, in one launch."""
    from risingwave_tpu_torch.ops import cuda as kcuda
    from risingwave_tpu_torch.utils.device import LAUNCHES
    st, slots, packed = _applied(dev)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, _specs(), dev))
    H.advance(st)
    st.st[H.ROW_DIRTY, ::7] = 1
    dropped = torch.from_numpy((np.random.default_rng(4).random(CAP) < 0.3)
                               .astype(np.int32)).to(dev)
    args = _live_args(mode)
    d = dropped if mode == H.LIVE_EVICT else None
    want = H.live_mask_plain(st, mode, *args, d).cpu().numpy()
    new_cap = 2 * CAP if grow else CAP
    live = torch.empty(CAP, dtype=torch.int32, device=dev)
    keys = torch.full((new_cap, KW), -7, dtype=torch.int32, device=dev)
    occ = torch.full((new_cap,), -7, dtype=torch.int32, device=dev)
    kcuda.call("rebuild", "rw_live_mask", mode, st.st.data_ptr(),
               st.table.keys.data_ptr(), st.table.occ.data_ptr(), CAP, KW,
               *args, st.st.numel(), 1,
               None if d is None else d.data_ptr(), live.data_ptr(),
               keys.data_ptr(), occ.data_ptr(), new_cap)
    np.testing.assert_array_equal(live.cpu().numpy(), want)
    assert not keys.any() and not occ.any()
    LAUNCHES.reset()
    live2, table = H.live_and_table(st, mode, new_cap, *args, dropped=d)
    assert LAUNCHES.snapshot() == {"live_mask": 1}
    np.testing.assert_array_equal(live2.cpu().numpy(), want)
    assert table.keys.shape == (new_cap, KW) and not table.keys.any()
    assert table.occ.shape == (new_cap,) and not table.occ.any()
    assert 0 < int(want.sum())
    if mode in (H.LIVE_RETIRE, H.LIVE_EVICT):
        assert int(want.sum()) < int((st.table.occ != 0).sum())


def test_live_mask_scalar_edges(dev):
    """K4's mask where no 16-byte access is possible (a capacity and a
    fresh capacity that are not multiples of 4, three shards): the
    element-wise path, each mode, against the plain version."""
    rng = np.random.default_rng(5)
    s, cap, new_cap, r = 3, 1030, 2062, H.ROW_ACC0 + 2
    st = rng.integers(-2, 3, (s, r, cap)).astype(np.int32)
    st[:, H.ROW_DIRTY] = rng.random((s, cap)) < 0.2
    st[:, H.ROW_EMITTED_VALID] = rng.random((s, cap)) < 0.2
    keys = rng.integers(-3, 4, (s, cap, KW)).astype(np.int32)
    occ = (rng.random((s, cap)) < 0.6).astype(np.int32)
    state = H.ShardedAggState(
        ht.TableState(torch.from_numpy(keys).to(dev),
                      torch.from_numpy(occ).to(dev)),
        torch.from_numpy(st).to(dev))
    for mode in (H.LIVE_GROW, H.LIVE_RETIRE, H.LIVE_OCCUPIED):
        live, table = H.live_and_table_sharded(state, mode, new_cap, 0, 1,
                                               -5)
        want = np.stack([H.live_mask_plain(state.shard(d), mode, 0, 1, -5)
                         .cpu().numpy() for d in range(s)])
        np.testing.assert_array_equal(live.cpu().numpy(), want)
        assert table.keys.shape == (s, new_cap, KW)
        assert not table.keys.any() and not table.occ.any()


@pytest.mark.parametrize("kind", ["retire", "grow", "evict"])
def test_rebuild_in_three_launches_matches_plain(dev, kind):
    """retire_state, grow_state and evict_state on the card: K4's mask
    with the fresh table, K1, K4's remap (K8 first when evicting), one
    launch each, the state key-sorted equal to the plain twin's."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    st, slots, packed = _applied(dev)
    H.agg_apply(st, packed, slots, H.ApplyPlan(KW, _specs(), dev))
    H.advance(st)
    fill = torch.tensor(H.state_fills(_specs()), dtype=torch.int32,
                        device=dev)
    args = _live_args(H.LIVE_RETIRE)
    rng = np.random.default_rng(6)
    occ = np.flatnonzero(st.table.occ.cpu().numpy())
    q = torch.from_numpy(st.table.keys.cpu().numpy()[rng.choice(occ, 500)]
                         ).to(dev)
    v = torch.ones(500, dtype=torch.int32, device=dev)
    LAUNCHES.reset()
    if kind == "retire":
        got, stats = H.retire_state(st, args[1], args[2], 0, fill)
        mode, new_cap, d = H.LIVE_RETIRE, CAP, None
    elif kind == "grow":
        got, stats = H.grow_state(st, 2 * CAP, fill)
        mode, new_cap, d = H.LIVE_GROW, 2 * CAP, None
    else:
        got, stats, _l = H.evict_state(st, q, v, fill)
        mode, new_cap = H.LIVE_EVICT, CAP
        d = torch.zeros(CAP, dtype=torch.int32, device=dev)
        ht.lookup_plain(st.table, q, v, d)
    want = {"live_mask": 1, "probe_insert": 1, "remap": 1}
    if kind == "evict":
        want["lookup"] = 1
    assert LAUNCHES.snapshot() == want
    live = H.live_mask_plain(st, mode, *(args if kind == "retire"
                                         else (0, 0, 0)), d)
    table = ht.make_state(new_cap, KW, dev)
    o2n, pstats = ht.probe_insert_plain(table, st.table.keys, live)
    plain = H.AggState(table, H.remap_plain(st.st, o2n, table.occ, fill,
                                            new_cap))
    assert stats.tolist() == pstats.tolist()
    assert _groups(got) == _groups(plain)


@pytest.mark.parametrize("mode", [H.LIVE_RETIRE, H.LIVE_OCCUPIED])
def test_sharded_rebuild_matches_plain(dev, mode):
    """rebuild_sharded over 8 shards (retire_below's rule; growth keeping
    every occupied slot into 2 x cap) in three launches, every shard
    key-sorted equal to the plain versions'."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    st, slots, recv, rvalid = _sharded_applied(dev)
    H.agg_apply_sharded(st, recv, slots, H.ApplyPlan(KW, _specs(), dev))
    H.advance_sharded(st)
    fill = torch.tensor(H.state_fills(_specs()), dtype=torch.int32,
                        device=dev)
    args = _live_args(mode)
    new_cap = CAP if mode == H.LIVE_RETIRE else 2 * CAP
    LAUNCHES.reset()
    got, stats = H.rebuild_sharded(st, mode, new_cap, fill, *args)
    assert LAUNCHES.snapshot() == {"live_mask": 1, "probe_insert": 1,
                                   "remap": 1}
    for d in range(S):
        one = st.shard(d)
        live = H.live_mask_plain(one, mode, *args)
        table = ht.make_state(new_cap, KW, dev)
        o2n, pstats = ht.probe_insert_plain(table, one.table.keys, live)
        plain = H.AggState(table, H.remap_plain(one.st, o2n, table.occ,
                                                fill, new_cap))
        assert stats[d].tolist() == pstats.tolist()
        assert _groups(got.shard(d)) == _groups(plain)


@pytest.mark.parametrize("n_shards", [1, S])
def test_patched_advance_matches_plain(dev, n_shards):
    """advance carrying a patch (column i for list row i) in one launch,
    against scatter_rows_plain at the list's slots (padded with cap)
    followed by advance_listed_plain; no K9 launch."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    if n_shards == 1:
        one, slots, packed = _applied(dev)
        H.agg_apply(one, packed, slots, H.ApplyPlan(KW, _specs(), dev))
        st = H.ShardedAggState(ht.TableState(one.table.keys[None],
                                             one.table.occ[None]),
                               one.st[None])
    else:
        st, slots, recv, rvalid = _sharded_applied(dev)
        H.agg_apply_sharded(st, recv, slots, H.ApplyPlan(KW, _specs(), dev))
    mats = H.flush_gather_sharded(st, 1 << 12)
    ns = mats[:, 0, 0].cpu().numpy()
    assert (ns <= 1 << 12).all() and ns.min() > 0
    pad = 1 << int(ns.max() - 1).bit_length()
    rng = np.random.default_rng(n_shards)
    patch = torch.from_numpy(rng.integers(-2**31, 2**31, (
        n_shards, st.n_acc, pad)).astype(np.int32)).to(dev)
    idx = torch.full((n_shards, pad), CAP, dtype=torch.int32, device=dev)
    for d in range(n_shards):
        idx[d, :int(ns[d])] = mats[d, 1:1 + int(ns[d]), 0]
    a = H.ShardedAggState(st.table, st.st.clone())
    b = H.ShardedAggState(st.table, st.st.clone())
    LAUNCHES.reset()
    H.advance_sharded(a, mats, patch=patch)
    assert LAUNCHES.snapshot() == {"advance": 1}
    H.scatter_rows_plain(b.st, idx, H.patch_rows(st.n_acc, dev), patch)
    for d in range(n_shards):
        H.advance_listed_plain(b.shard(d), mats[d])
    np.testing.assert_array_equal(a.st.cpu().numpy(), b.st.cpu().numpy())


@pytest.mark.parametrize("then", ["advance", "step"])
def test_grouped_kernel_patch_rides_in_advance(dev, then):
    """GroupedAggKernel on the card against the same kernel on the CPU:
    patch_accs then advance launches advance once and no scatter_rows;
    patch_accs then a step first writes the patch with one K9 launch.
    The decoded groups match (key-sorted). Each group's patched value is
    a function of its key, not of its flush row: K1 may give the card's
    flush another row order than the CPU's (queue C)."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    specs = tuple(H.AggSpec(H.AggKind(k), None if d is None else np.dtype(d))
                  for k, d in [("max", np.int64), ("count", None)])
    rng = np.random.default_rng(21)
    g = rng.integers(0, 700, 4096).astype(np.int64)
    v = rng.integers(-10**6, 10**6, 4096)
    args = (_lanes(g), np.ones(4096, np.int32), np.ones(4096, bool),
            [(specs[0].encode_input(v), np.ones(4096, bool)), ((), None)])
    out = {}
    for d in ("cuda", "cpu"):
        k = H.GroupedAggKernel(KW, specs, capacity=1 << 12, device=d)
        k.apply(*args)
        fr = k.flush()
        LAUNCHES.reset()
        k.patch_accs([(fr.keys[:, 1].astype(np.int64) * 3 - 7,
                       fr.nns[0]), None], fr.raw_accs)
        if then == "advance":
            k.advance()
        else:
            k.apply(*args)
            k._dispatch_backlog()
        if d == "cuda":
            snap = LAUNCHES.snapshot()
            if then == "advance":
                assert snap == {"advance": 1}
            else:
                assert snap["scatter_rows"] == 1 and "advance" not in snap
        fr2 = k.flush()
        order = np.lexsort(fr2.keys.T[::-1])
        out[d] = (fr2.keys[order], [o[order] for o in fr2.outs],
                  [o[order] for o in fr2.prev_outs])
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(x, y)


def test_join_kernels_drop_a_negative_ref(dev):
    """The declared deviation (ROADMAP.md queue C): K5 and K7 drop a
    negative ref, as the port's plain versions do (the reference wraps
    it: tests/test_torch_hash_join.py::
    test_deviation_negative_ref_dropped_where_reference_wraps). Element
    row_cap - 1, which no other ref of the batch names, keeps its value."""
    c = KC.k5_case("refs_out_of_range")
    row_cap = c["row_cap"]
    c["ins_ref"] = np.where(c["ins_ref"] >= row_cap, -1, c["ins_ref"])
    c["del_ref"] = np.where(c["del_ref"] >= row_cap, -1, c["del_ref"])
    for r in ("ins_ref", "del_ref"):
        c[r][c[r] == row_cap - 1] = -1
    assert (c["ins_ref"] == -1).sum() > 100 and (c["del_ref"] == -1).sum()
    chains, pay, parts = KC.k5_tensors(c, dev)
    want_c, want_p, _p = KC.k5_tensors(c, dev)
    KC.k5_launch(chains, pay, parts, J.link_scratch(chains.head))
    KC.k5_plain(want_c, want_p, parts)
    for x, y in zip(KC.k5_result(chains, pay),
                    KC.k5_result(want_c, want_p)):
        np.testing.assert_array_equal(x, y)
    for name, arr in zip(("next", "ins_seq", "del_seq"), chains[1:]):
        assert int(arr[0, row_cap - 1]) == int(c[name][0, row_cap - 1])
    assert pay[0, row_cap - 1].tolist() == c["pay"][0, row_cap - 1].tolist()
    rng = np.random.default_rng(12)
    arr = torch.from_numpy(rng.integers(-9, 9, (ROWS, JP))
                           .astype(np.int32)).to(dev)
    refs = rng.permutation(ROWS - 1)[:N].astype(np.int32)
    refs[::5] = -1
    refs_t = torch.from_numpy(refs).to(dev)
    vis = torch.ones(N, dtype=torch.int32, device=dev)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (N, JP))
                            .astype(np.int32)).to(dev)
    a = J._masked_scatter(arr.clone(), refs_t, vis, vals)
    b = J._masked_scatter_plain(arr.clone(), refs_t, vis, vals)
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert a[ROWS - 1].tolist() == arr[ROWS - 1].tolist()


# -- the join's other modes on the card: outer, degrees, compaction, reload ---

def _join_stream(seed, n_epochs=4, rows=1500, key_range=400, null_p=0.05,
                 wide=False, kill_share=0.2):
    """Both sides' messages for an executor run: each epoch a chunk a
    side of deletes of live rows (``kill_share`` of them) and inserts,
    NULL keys included (columns k, v, id; the state-table pk is (id,) or
    (k, id)). ``wide`` widens the key range each epoch."""
    from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk
    from risingwave_tpu_torch.common.epoch import Epoch, EpochPair
    from risingwave_tpu_torch.common.types import DataType, Schema
    from risingwave_tpu_torch.stream.message import Barrier, BarrierKind
    rng = np.random.default_rng(seed)
    schema = Schema.of(k=DataType.INT64, v=DataType.INT64,
                       id=DataType.INT64)

    def barrier(b):
        prev = Epoch.from_physical(b - 1) if b > 1 else Epoch.INVALID
        return Barrier(EpochPair(Epoch.from_physical(b), prev),
                       BarrierKind.CHECKPOINT)
    msgs = ([barrier(1)], [barrier(1)])
    live = [[], []]
    next_id = [0, 10**6]
    for b in range(2, n_epochs + 2):
        for side in (0, 1):
            ks, vs, ids, ops, nulls = [], [], [], [], []
            kill = rng.permutation(len(live[side]))[
                :int(len(live[side]) * kill_share)]
            for j in sorted(kill.tolist(), reverse=True):
                k, i, nul = live[side].pop(j)
                ks.append(k)
                nulls.append(nul)
                ids.append(i)
                vs.append(i * 3)
                ops.append(int(Op.DELETE))
            hi = key_range * (b if wide else 1)
            for _ in range(rows - len(ks)):
                k = int(rng.integers(0, hi))
                nul = bool(rng.random() < null_p)
                i = next_id[side]
                next_id[side] += 1
                live[side].append((k, i, nul))
                ks.append(k)
                nulls.append(nul)
                ids.append(i)
                vs.append(i * 3)
                ops.append(int(Op.INSERT))
            null = np.asarray(nulls)
            msgs[side].append(StreamChunk(schema, [
                Column(DataType.INT64, np.where(null, 0, ks), ~null),
                Column(DataType.INT64, np.asarray(vs, np.int64)),
                Column(DataType.INT64, np.asarray(ids, np.int64))],
                np.ones(len(ks), bool), np.asarray(ops, np.int8)))
            msgs[side].append(barrier(b))
    return msgs, schema, n_epochs + 1


def _run_join_on(device, msgs, schema, nb, join_type, pks=([2], [2]),
                 **kw):
    """One HashJoinExecutor run: (records per chunk, executor, state
    rows)."""
    import asyncio
    from risingwave_tpu_torch.state.state_table import StateTable
    from risingwave_tpu_torch.state.store import MemoryStateStore
    from risingwave_tpu_torch.stream.executors.hash_join import (
        HashJoinExecutor, JoinType,
    )
    from risingwave_tpu_torch.stream.executors.test_utils import (
        MockSource, collect_until_n_barriers,
    )
    store = MemoryStateStore()
    lt = StateTable(21, schema, pks[0], store, dist_key_indices=[])
    rt = StateTable(22, schema, pks[1], store, dist_key_indices=[])
    ex = HashJoinExecutor(
        MockSource(schema, list(msgs[0])), MockSource(schema, list(msgs[1])),
        [0], [0], lt, rt, join_type=JoinType(join_type), device=device,
        **kw)
    out = asyncio.run(collect_until_n_barriers(ex, nb))
    recs = [[(int(op), tuple(r)) for op, r in m.to_records()]
            for m in out if hasattr(m, "to_records")]
    return recs, ex, (list(lt.iter_rows()), list(rt.iter_rows()))


def _live_degrees(ex):
    return [s.kernel.read_degrees(s.live_refs()) if s.track_degrees
            else None for s in ex.sides]


def _same_runs(a, b):
    assert a[0] == b[0]
    assert a[2] == b[2]
    for x, y in zip(_live_degrees(a[1]), _live_degrees(b[1])):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("join_type", ["left_outer", "full_outer",
                                       "right_semi", "left_anti"])
def test_outer_join_executor_on_the_card_matches_the_cpu(dev, join_type):
    """A degree-tracked HashJoinExecutor on the card (K1, K5, K6 with
    degrees) against the same executor on the CPU (the plain versions):
    the same messages record for record, the same state tables and the
    same device degrees of every live row; the card's run launched
    join_probe_deg, not join_probe."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    msgs, schema, nb = _join_stream(51)
    LAUNCHES.reset()
    card = _run_join_on(dev, msgs, schema, nb, join_type)
    launched = LAUNCHES.snapshot()
    _same_runs(card, _run_join_on("cpu", msgs, schema, nb, join_type))
    assert launched.get("join_probe_deg", 0) == 2 * (nb - 1)
    assert launched.get("join_probe", 0) == 0


def test_degree_epoch_pair_buffer_overflow_on_the_card(dev):
    """FULL OUTER with a 64-row pair buffer: each degree-tracked epoch
    probe overflows, re-dispatches from the degree arrays it started
    from and installs them only after its collect; the card equals the
    CPU."""
    msgs, schema, nb = _join_stream(52, key_range=200, null_p=0.0)
    card = _run_join_on(dev, msgs, schema, nb, "full_outer",
                        shard_opts={"probe_capacity": 64})
    assert all(s.kernel._probe_cap > 64 for s in card[1].sides)
    _same_runs(card, _run_join_on("cpu", msgs, schema, nb, "full_outer",
                                  shard_opts={"probe_capacity": 64}))


def test_outer_compaction_carries_degrees_on_the_card(dev, monkeypatch):
    """LEFT OUTER with compaction at every barrier: each rebuild writes
    its payload lanes in K5's launch (join_apply) and carries the live
    rows' degrees from the old array into the fresh one with K7's gather
    (masked_scatter), with no read of the degree array to the host; the
    card equals the CPU."""
    from risingwave_tpu_torch.stream.executors import hash_join as X
    from risingwave_tpu_torch.utils.device import LAUNCHES
    msgs, schema, nb = _join_stream(53)
    monkeypatch.setattr(X._JoinSide, "COMPACT_DEAD_RATIO", 0.05)
    monkeypatch.setattr(X._JoinSide, "COMPACT_MIN_REFS", 64)
    rebuilds = []
    real = J.JoinSideKernel.rebuild

    def spy(self, key_lanes, row_refs, payload=None, carry=None):
        before = LAUNCHES.snapshot()
        real(self, key_lanes, row_refs, payload, carry)
        after = LAUNCHES.snapshot()
        rebuilds.append((self.device.type, len(row_refs), carry is not None,
                         {k: after.get(k, 0) - before.get(k, 0)
                          for k in ("join_apply", "masked_scatter")}))
    monkeypatch.setattr(J.JoinSideKernel, "rebuild", spy)
    runs = []
    for d in (dev, "cpu"):
        LAUNCHES.reset()
        runs.append(_run_join_on(d, msgs, schema, nb, "left_outer"))
        runs[-1] += (LAUNCHES.snapshot(),)
    _same_runs(runs[0][:3], runs[1][:3])
    card = [r for r in rebuilds if r[0] == "cuda" and r[1]]
    # the payload in K5's launch, the degrees in K7's carry, nothing else
    for _t, _n, carried, d in card:
        assert d == {"join_apply": 1, "masked_scatter": int(carried)}
    assert sum(c for _t, _n, c, _d in card) > 0
    assert runs[0][3].get("masked_scatter", 0) == \
        sum(c for _t, _n, c, _d in card)
    assert runs[0][1].sides[0].next_ref < sum(
        m.capacity for m in msgs[0] if hasattr(m, "ops"))


def test_cold_reload_recomputes_degrees_on_the_card(dev):
    """FULL OUTER under a 64-key cold tier: keys evict (compaction: the
    payload in K5's launch, the degrees carried by K7's gather) and reload
    (K1 + K5 at seq 0), and the reloaded rows' degrees recompute by one
    probe of the other side (join_probe_deg) whose degree column K7
    writes at the staged refs; the card equals the CPU, eviction and
    reload counts included."""
    from risingwave_tpu_torch.utils.device import LAUNCHES
    msgs, schema, nb = _join_stream(54, n_epochs=6, rows=400,
                                    key_range=300, null_p=0.0, wide=True,
                                    kill_share=0.0)
    LAUNCHES.reset()
    card = _run_join_on(dev, msgs, schema, nb, "full_outer",
                        pks=([0, 2], [0, 2]), state_cap=64)
    launched = LAUNCHES.snapshot()
    cpu = _run_join_on("cpu", msgs, schema, nb, "full_outer",
                       pks=([0, 2], [0, 2]), state_cap=64)
    assert card[0] == cpu[0] and card[2] == cpu[2]
    counts = [[(p.evicted_total, p.reload_total) for p in r[1]._tier_parts]
              for r in (card, cpu)]
    assert counts[0] == counts[1]
    assert sum(e for e, _r in counts[0]) > 0
    assert sum(r for _e, r in counts[0]) > 0
    assert launched.get("masked_scatter", 0) > 0
    assert launched.get("join_probe_deg", 0) > 2 * (nb - 1)
