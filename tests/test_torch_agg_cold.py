"""The agg's last two device programs in the port against the JAX
reference, on the CPU (the kernels' plain versions):

- K8 ``lookup`` against ``ht.lookup`` (absent keys, padding rows,
  duplicates) and its dropped mask;
- B9 ``evict_state`` (K8, K4's evict mode, the K1 + K4 rebuild) against
  ``build_evict``, including keys that are not resident and duplicates;
- B10 ``patch_state`` / ``encode_patch_cols`` against ``build_patch`` and
  ``encode_patch_cols``: untouched calls pass through, float SUM's (hi,
  lo) bits and the integer SUM limbs included;
- ``GroupedAggKernel.load_groups`` against the reference's: resident
  groups untouched, reloaded groups emitted, ``dirty`` unchanged; and
  ``evict_keys``' refusal of an undispatched backlog;
- the sharded ``patch_accs`` (K9 with a shard axis) against the
  reference's ``ShardedAggKernel.patch_accs`` over 8 shards, driven by a
  retractable MIN/MAX executor on both packages.

States are compared bit for bit through ``to_numpy_state``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from risingwave_tpu.ops import hash_agg as R
from risingwave_tpu.ops import hash_table as RT
from risingwave_tpu.ops import lanes as ref_lanes
from risingwave_tpu.parallel.agg import ShardedAggKernel as RefSharded
from risingwave_tpu_torch.ops import hash_agg as P
from risingwave_tpu_torch.ops import hash_table as PT
from risingwave_tpu_torch.parallel.agg import ShardedAggKernel
from risingwave_tpu_torch.parallel.mesh import ShardMesh

from tests import test_torch_agg_kinds as K

torch.set_num_threads(2)

CPU = torch.device("cpu")
KW = 3
MIXED = [("sum", np.int64), ("sum", np.float64), ("min", np.int64),
         ("count", None), ("max", np.int64)]


def _specs(mod, pairs):
    return tuple(mod.AggSpec(mod.AggKind(k), None if d is None
                             else np.dtype(d)) for k, d in pairs)


def _keys(g: np.ndarray) -> np.ndarray:
    hi, lo = ref_lanes.split_i64(g.astype(np.int64))
    return np.stack([hi, lo, np.ones(len(g), np.int32)], axis=1)


def _packed(rng, n, groups, specs, append_only=True):
    g = rng.integers(0, groups, n).astype(np.int64) * 7_919 - 3
    signs = np.ones(n, np.int32) if append_only else \
        np.where(rng.random(n) < 0.2, -1, 1).astype(np.int32)
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
    return R.pack_chunk(KW, specs, _keys(g), signs, vis, inputs)


def _state(groups=600, cap=2048, seed=3, pairs=MIXED):
    """A reference state after two applies, a flush and an advance, and
    a third apply (some groups dirty again), with its port copy."""
    specs = _specs(R, pairs)
    rng = np.random.default_rng(seed)
    step = R.build_apply(KW, specs)
    st = R.make_agg_state(cap, KW, specs)
    for _ in range(2):
        st, _ins = step(st, jnp.asarray(_packed(rng, 512, groups, specs)))
    st = R.advance_state(st)
    st, _ins = step(st, jnp.asarray(_packed(rng, 64, groups, specs)))
    return specs, _specs(P, pairs), st, rng


def _same(port_state, ref_state, pspecs):
    got = P.to_numpy_state(port_state, pspecs)
    np.testing.assert_array_equal(got.table.keys,
                                  np.asarray(ref_state.table.keys))
    np.testing.assert_array_equal(got.table.occ,
                                  np.asarray(ref_state.table.occ))
    for name in ("group_rows", "dirty", "emitted_valid", "emitted_rows"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref_state, name)),
                                      err_msg=name)
    for a, b in zip(got.accs + got.emitted_accs,
                    tuple(ref_state.accs) + tuple(ref_state.emitted_accs)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _queries(rng, ref_state, n=300):
    """Resident keys, absent keys, duplicates and padding rows."""
    occ = np.flatnonzero(np.asarray(ref_state.table.occ))
    res = np.asarray(ref_state.table.keys)[rng.choice(occ, n // 2)]
    absent = _keys(rng.integers(10**6, 10**7, n // 4) * 7_919 + 1)
    q = np.concatenate([res, absent, res[: n // 4]])
    rng.shuffle(q)
    valid = rng.random(len(q)) < 0.9
    return np.ascontiguousarray(q), valid


def test_lookup_matches_reference():
    _s, _p, ref, rng = _state()
    q, valid = _queries(rng, ref)
    want = np.asarray(RT.lookup(ref.table, jnp.asarray(q),
                                jnp.asarray(valid)))
    table = P.from_jax_state(ref, CPU).table
    dropped = torch.zeros(table.capacity, dtype=torch.int32)
    got, stats = PT.lookup(table, torch.from_numpy(q),
                           torch.from_numpy(valid), dropped)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats.tolist() == [0, 0]
    assert (want >= 0).sum() > 100 and (want < 0).sum() > 50
    mark = np.zeros(table.capacity, np.int32)
    mark[want[want >= 0]] = 1
    np.testing.assert_array_equal(dropped.numpy(), mark)


def test_lookup_overflow_on_a_full_table():
    table = PT.make_state(1024, KW, CPU)
    table.occ.fill_(1)
    table.keys.copy_(torch.from_numpy(_keys(np.arange(1024) * 3)))
    _slots, stats = PT.lookup(table, torch.from_numpy(_keys(np.asarray(
        [-5]))), torch.ones(1, dtype=torch.int32))
    assert stats.tolist() == [0, 1]


def test_evict_state_matches_reference():
    specs, pspecs, ref, rng = _state()
    q, valid = _queries(rng, ref)
    fills = tuple(f for _dt, f in R.dev_layout(specs))
    want, n_live = jax.jit(R.evict_state, static_argnums=(3,))(
        ref, jnp.asarray(q), jnp.asarray(valid), fills)
    fill = torch.tensor(P.state_fills(pspecs), dtype=torch.int32)
    got, stats, lstats = P.evict_state(
        P.from_jax_state(ref, CPU), torch.from_numpy(q),
        torch.from_numpy(valid), fill)
    _same(got, want, pspecs)
    assert int(stats[0]) == int(n_live) and lstats.tolist() == [0, 0]
    assert int(np.asarray(want.table.occ).sum()) < \
        int(np.asarray(ref.table.occ).sum())


def test_patch_state_matches_reference():
    """Corrected MIN and MAX calls beside untouched SUMs and COUNT: the
    untouched calls' raw gathered columns pass through bit for bit."""
    specs, pspecs, ref, rng = _state()
    fc = 1024
    mat = np.asarray(R.gather_packed(ref, fc))
    n = int(mat[0, 0])
    data = mat[1:1 + n]
    rfr = R.decode_flush_data(specs, KW, data)
    pfr = P.decode_flush_data(pspecs, KW, data)
    decoded = []
    for j, s in enumerate(specs):
        if s.kind.value in ("min", "max"):
            v = rng.integers(-10**9, 10**9, n)
            nn = rng.integers(0, 3, n).astype(np.int64)
            decoded.append((v, nn))
        else:
            decoded.append(None)
    rcols = R.encode_patch_cols(specs, decoded, rfr.raw_accs)
    pcols = P.encode_patch_cols(pspecs, decoded, pfr.raw_accs)
    for a, b in zip(pcols, rcols):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    idx = data[:, 0].astype(np.int32)
    pad = 2 * n
    idx_p = np.full(pad, ref.table.capacity, np.int32)
    idx_p[:n] = idx
    padded = tuple(np.concatenate([c, np.zeros(pad - n, c.dtype)])
                   for c in rcols)
    want = R.build_patch(specs)(ref, jnp.asarray(idx_p), padded)
    port = P.from_jax_state(ref, CPU)
    src = np.zeros((len(pcols), pad), np.int32)
    src[:, :n] = np.stack(P.as_i32_cols(pcols))
    P.patch_state(port, torch.from_numpy(idx_p), torch.from_numpy(src))
    _same(port, want, pspecs)


def test_load_groups_matches_reference():
    """Reload groups into a live table beside resident ones: the
    resident state is untouched, the reloaded groups come back emitted,
    and ``dirty`` does not move."""
    specs, pspecs, ref, rng = _state(groups=300)
    rk = R.GroupedAggKernel(KW, specs, capacity=2048)
    rk.state = ref
    pk = P.GroupedAggKernel(KW, pspecs, capacity=2048, device="cpu")
    pk.state = P.from_jax_state(ref, CPU)
    n = 120
    keys = _keys(rng.permutation(10**5)[:n].astype(np.int64) * 7_919 + 5)
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
    rk.load_groups(keys, rows, accs)
    pk.load_groups(keys, rows, accs)
    _same(pk.state, rk.state, pspecs)
    ev = np.asarray(rk.state.emitted_valid)
    slots = np.asarray(RT.lookup(rk.state.table, jnp.asarray(keys),
                                 jnp.ones(n, bool)))
    assert ev[slots].all()
    np.testing.assert_array_equal(np.asarray(rk.state.dirty),
                                  np.asarray(ref.dirty))


def test_dummy_lanes_match_reference():
    """approx_count_distinct and string_agg beside COUNT and MAX: K2's
    plain version writes nothing to their dummy lanes (kNone), as the
    reference's ``_update_call``; the state, the dummy lanes included,
    carries across ``from_jax_state`` / ``to_numpy_state``."""
    pairs = [("approx_count_distinct", np.int64), ("count", None),
             ("string_agg", object), ("max", np.int64)]
    specs, pspecs = _specs(R, pairs), _specs(P, pairs)
    rng = np.random.default_rng(14)
    n = 2048
    g = rng.integers(0, 300, n).astype(np.int64)
    v = rng.integers(-10**9, 10**9, n)
    inputs = [((), rng.random(n) < 0.9), ((), None),
              ((), rng.random(n) < 0.9), (specs[3].encode_input(v),
                                          np.ones(n, bool))]
    packed = R.pack_chunk(KW, specs, _keys(g), np.ones(n, np.int32),
                          rng.random(n) < 0.95, inputs)
    packed[:, 5:7] = 0        # approx_count_distinct's unused lane columns
    ref, _ins = R.build_apply(KW, specs)(R.make_agg_state(1024, KW, specs),
                                         jnp.asarray(packed))
    port = P.make_agg_state(1024, KW, pspecs, CPU)
    plan = P.ApplyPlan(KW, pspecs, CPU)
    assert plan.desc[[0, 2], 0].tolist() == [P._K_NONE] * 2
    P.apply_batch(port, torch.from_numpy(packed), plan)
    _same(port, ref, pspecs)
    _same(P.from_jax_state(ref, CPU), ref, pspecs)
    assert [s.out_dtype for s in pspecs] == [s.out_dtype for s in specs]
    assert P.acc_dtypes(pspecs) == R.acc_dtypes(specs)


def test_evict_keys_refuses_a_backlog():
    pspecs = _specs(P, [("count", None)])
    k = P.GroupedAggKernel(KW, pspecs, device="cpu")
    k.apply(_keys(np.arange(4)), np.ones(4, np.int32), np.ones(4, bool),
            (((), None),))
    with pytest.raises(RuntimeError, match="backlog"):
        k.evict_keys(_keys(np.arange(2)))


# -- the sharded patch (tests/test_multichip_agg.py:281's executor content) --

def _mesh_executor(pkg, devs, msgs, calls):
    p = K.PKG[pkg]
    sch = K.schema(pkg, K.GV)
    agg_calls = K.make_calls(pkg, calls)
    specs = [c.spec(sch) for c in agg_calls]
    if pkg == "ref":
        kernel = RefSharded(Mesh(np.asarray(devs[:8]), ("d",)), KW, specs,
                            capacity=256)
    else:
        kernel = ShardedAggKernel(ShardMesh(8, "cpu"), KW, specs,
                                  capacity=256)
    store = p["Store"]()
    sschema, spk = p["ex"].agg_state_schema(sch, [0], agg_calls)
    table = p["Table"](10, sschema, spk, store, dist_key_indices=[0])
    _d, minput = p["ex"].agg_aux_tables(sch, [0], agg_calls, False, store,
                                        lambda c: 50 + c, lambda j: 100 + j)
    ex = p["ex"].HashAggExecutor(p["utils"].MockSource(sch, msgs), [0],
                                 agg_calls, table, minput_tables=minput,
                                 kernel=kernel, **p["kw"])
    return ex, {"value": table, **{f"m{j}": t for j, t in minput.items()}}


def test_sharded_patch_accs_matches_reference(eight_devices, monkeypatch):
    """A retractable MAX/MIN beside a SUM over 8 shards: each barrier's
    recompute patches every shard through one K9 launch; the emitted
    chunks, the tables and every shard's state equal the reference's."""
    steps, live = K._random_minmax_steps(seed=7, epochs=6, rows=200,
                                         groups=60)
    calls = [("max", 1, False), ("min", 1, False), ("sum", 1, False)]
    calls_seen = []
    orig = ShardedAggKernel.patch_accs

    def spy(self, decoded, raw_accs=None):
        calls_seen.append(sum(len(ix) for ix in self._flush_idx))
        return orig(self, decoded, raw_accs)

    monkeypatch.setattr(ShardedAggKernel, "patch_accs", spy)
    out = {}
    for pkg in ("ref", "port"):
        msgs = K.script(pkg, K.GV, steps)
        ex, tables = _mesh_executor(pkg, eight_devices, msgs, calls)
        n = sum(1 for s in steps if s[0] == "b")
        got = asyncio.run(K.PKG[pkg]["utils"].collect_until_n_barriers(
            ex, n))
        out[pkg] = (K.records(got), K.table_rows(tables), ex.kernel)
    assert out["port"][:2] == out["ref"][:2]
    assert len(calls_seen) >= 3
    port_k, ref_k = out["port"][2], out["ref"][2]
    got = P.to_numpy_sharded_state(port_k.state, port_k.specs)
    want = jax.device_get(ref_k.state)
    for a, b in zip(got.accs + got.emitted_accs,
                    tuple(want.accs) + tuple(want.emitted_accs)):
        np.testing.assert_array_equal(a.view(np.int32),
                                      np.asarray(b).view(np.int32))
    want_view = {}
    for g, v in live:
        want_view.setdefault(g, []).append(v)
    assert K.view(out["port"][0]) == {g: (max(v), min(v), sum(v))
                                      for g, v in want_view.items()}
