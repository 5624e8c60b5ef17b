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
against the same kernel on the CPU.
"""

import numpy as np
import pytest
import torch

from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.ops import fused_cases as FC
from risingwave_tpu_torch.ops import hash_agg as H
from risingwave_tpu_torch.ops import hash_join as J
from risingwave_tpu_torch.ops import hash_table as ht
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
    the bucket scratch all -1 again."""
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
    scratch = torch.full((S, CAP), -1, dtype=torch.int32, device=dev)
    J.join_apply_sharded(a, slots, scratch=scratch, **kw)
    J.join_apply_sharded_plain(b, slots, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert bool((scratch == -1).all())


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
