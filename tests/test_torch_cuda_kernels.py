"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a card every test here skips. On a CUDA
machine (which need not have JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Integers must match exactly; K1 (probe_insert) is held to the table
invariants, since its slot rule differs from the plain version's; float
SUM's hi and lo rows are each held to rel 1e-6 of the group's summed
magnitudes in that row (atomic order).
"""

import numpy as np
import pytest
import torch

from risingwave_tpu_torch.ops import hash_agg as H
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
