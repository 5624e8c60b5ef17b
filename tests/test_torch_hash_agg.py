"""Grouped-agg parity: the PyTorch port's K2–K4 (plain versions here)
and its HashAggExecutor against the JAX reference.

- apply (``build_apply``): COUNT, COUNT(col), int SUM, float SUM, MIN,
  MAX — bit-identical state except float SUM, held to rel 1e-6 because
  its (hi, lo) f32 pair depends on summation order;
- flush gather and advance (``gather_packed``, ``advance_state``), the
  watermark retirement (``retire_state``) and the growth rebuild, from
  one shared input state — bit-identical;
- carrying state across: ``from_jax_state``/``to_numpy_state`` round
  trip, and a stream that runs half in JAX and the rest in the port;
- the ``tests/test_hash_agg.py`` executor cases, mirrored: both
  executors take the same script and must emit the same chunks (same
  records in the same order) and leave the same state-table rows.

Inputs are made from seeds with numpy and handed to both packages.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common import chunk as ref_chunk
from risingwave_tpu.common import epoch as ref_epoch
from risingwave_tpu.common import types as ref_types
from risingwave_tpu.ops import hash_agg as ref_agg
from risingwave_tpu.ops import lanes as ref_lanes
from risingwave_tpu.state.state_table import StateTable as RefStateTable
from risingwave_tpu.state.store import MemoryStateStore as RefStore
from risingwave_tpu.stream import message as ref_msg
from risingwave_tpu.stream.executors import hash_agg as ref_exec
from risingwave_tpu.stream.executors import test_utils as ref_utils
from risingwave_tpu_torch.common import chunk as port_chunk
from risingwave_tpu_torch.common import epoch as port_epoch
from risingwave_tpu_torch.common import types as port_types
from risingwave_tpu_torch.models.nexmark import from_jax_state, to_numpy_state
from risingwave_tpu_torch.ops import hash_agg as port_agg
from risingwave_tpu_torch.state.state_table import StateTable as PortStateTable
from risingwave_tpu_torch.state.store import MemoryStateStore as PortStore
from risingwave_tpu_torch.stream import message as port_msg
from risingwave_tpu_torch.stream.executors import hash_agg as port_exec
from risingwave_tpu_torch.stream.executors import test_utils as port_utils

# Under pytest-xdist these tests share the host's cores with timing-bound
# tests on other workers (tests/test_chaos.py's 8 s barrier timeouts), so
# torch's intra-op pool stays small.
torch.set_num_threads(2)

CPU = torch.device("cpu")
KW = 3                   # one int64 group column: (hi, lo, valid) lanes
FLOAT_SUM_RTOL = 1e-6    # f32 pair sums: atomic/scatter order differs

R, P = ref_agg, port_agg
SPECS = [
    ("count", None), ("count", np.int64), ("sum", np.int64),
    ("sum", np.float64), ("min", np.int64), ("max", np.int64),
]


def _specs(mod, pairs):
    return tuple(mod.AggSpec(mod.AggKind(k), None if d is None
                             else np.dtype(d)) for k, d in pairs)


def _packed(rng, n, n_groups, specs, retract=True):
    """A packed batch (pack_chunk layout) with nulls, invisible rows and,
    optionally, retractions."""
    g = rng.integers(0, n_groups, n).astype(np.int64) * 1_000_003 - 7
    hi, lo = ref_lanes.split_i64(g)
    keys = np.stack([hi, lo, np.ones(n, np.int32)], axis=1)
    signs = np.where(rng.random(n) < (0.2 if retract else 0.0), -1, 1) \
        .astype(np.int32)
    vis = rng.random(n) < 0.9
    ints = rng.integers(-10**12, 10**12, n)
    floats = rng.standard_normal(n) * 1e3
    inputs = []
    for s in specs:
        ok = rng.random(n) < 0.8
        if s.in_dtype is None:
            inputs.append(((), None))
            continue
        vals = floats if np.issubdtype(s.in_dtype, np.floating) else ints
        inputs.append((s.encode_input(vals), ok))
    return R.pack_chunk(KW, specs, keys, signs, vis, inputs)


def _assert_state_equal(port_state, ref_state, specs, float_rows=()):
    got = to_numpy_state(port_state, _specs(P, [(s.kind.value, s.in_dtype)
                                               for s in specs]))
    np.testing.assert_array_equal(got.table.keys,
                                  np.asarray(ref_state.table.keys))
    np.testing.assert_array_equal(got.table.occ,
                                  np.asarray(ref_state.table.occ))
    for name in ("group_rows", "dirty", "emitted_valid", "emitted_rows"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref_state, name)),
                                      err_msg=name)
    for field in ("accs", "emitted_accs"):
        for i, (a, b) in enumerate(zip(getattr(got, field),
                                       getattr(ref_state, field))):
            b = np.asarray(b)
            if i in float_rows:
                np.testing.assert_allclose(a, b, rtol=FLOAT_SUM_RTOL,
                                           atol=1e-6, err_msg=field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{field}{i}")


def _float_sum_rows(specs):
    rows, j = [], 0
    for s in specs:
        n = len(s.dev_layout())
        if s.is_float_sum:
            rows += [j, j + 1]
        j += n
    return rows


def _run_applies(specs, batches, cap=1024):
    ref_state = R.make_agg_state(cap, KW, specs)
    step = R.build_apply(KW, specs)
    port_specs = _specs(P, [(s.kind.value, s.in_dtype) for s in specs])
    port_state = P.make_agg_state(cap, KW, port_specs, CPU)
    plan = P.ApplyPlan(KW, port_specs, CPU)
    for packed in batches:
        ref_state, ins = step(ref_state, jnp.asarray(packed))
        stats = P.apply_batch(port_state, torch.from_numpy(packed), plan)
        assert int(stats[0]) == int(ins) and int(stats[1]) == 0
    return ref_state, port_state, port_specs


@pytest.mark.parametrize("rows,append_only", [(512, False), (16384, True)])
def test_apply_matches_reference(rows, append_only):
    """16384 rows span two 8192-row limb slices (carry between them)."""
    specs = _specs(R, SPECS)
    rng = np.random.default_rng(rows)
    batches = [_packed(rng, rows, 60, specs, retract=not append_only)
               for _ in range(3)]
    ref_state, port_state, _ = _run_applies(specs, batches)
    _assert_state_equal(port_state, ref_state, specs,
                        float_rows=_float_sum_rows(specs))


def _shared_state(seed=3, groups=300):
    """A reference state after a few applies (no float SUM, so every
    function of it must match bit for bit) and its port copy."""
    specs = _specs(R, [p for p in SPECS if p != ("sum", np.float64)])
    rng = np.random.default_rng(seed)
    batches = [_packed(rng, 512, groups, specs) for _ in range(2)]
    ref_state, _port, port_specs = _run_applies(specs, batches)
    return specs, port_specs, ref_state, from_jax_state(ref_state, CPU)


@pytest.mark.parametrize("flush_cap", [8, 1024])
def test_flush_gather_and_advance_match_reference(flush_cap):
    """Includes a too-small buffer: the header keeps the true n_dirty."""
    specs, _ps, ref_state, port_state = _shared_state()
    want = np.asarray(R.gather_packed(ref_state, flush_cap))
    got = P.flush_gather(port_state, flush_cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] > flush_cap or flush_cap == 1024
    P.advance(port_state)
    _assert_state_equal(port_state, R.advance_state(ref_state), specs)


def test_retire_and_grow_match_reference():
    specs, port_specs, ref_state, port_state = _shared_state(groups=500)
    fills = tuple(f for _dt, f in R.dev_layout(specs))
    fill = torch.tensor(P.state_fills(port_specs), dtype=torch.int32)
    # retire below a watermark in the middle of the key range
    wm = 200 * 1_000_003 - 7
    hi, lo = ref_lanes.split_i64(np.asarray([wm], dtype=np.int64))
    ref_ret, ref_live = jax.jit(R.retire_state, static_argnums=(3, 4))(
        ref_state, jnp.int32(hi[0]), jnp.int32(lo[0]), 0, fills)
    port_ret, stats = P.retire_state(port_state, int(hi[0]), int(lo[0]),
                                     0, fill)
    assert int(stats[0]) == int(ref_live) and int(stats[1]) == 0
    _assert_state_equal(port_ret, ref_ret, specs)
    # the growth rebuild (GroupedAggKernel._grow_step rule)
    live = ref_state.table.occ & ((ref_state.group_rows != 0)
                                  | ref_state.dirty
                                  | ref_state.emitted_valid)
    ref_grown, _n = R._rebuild_live(ref_state, live, 2048, fills)
    port_grown, _stats = P.grow_state(from_jax_state(ref_state, CPU), 2048,
                                      fill)
    _assert_state_equal(port_grown, ref_grown, specs)


def test_state_round_trip_and_split_stream():
    """from_jax_state/to_numpy_state round trip; then a stream run half
    in the reference kernel and finished in the port's equals the
    reference run whole."""
    specs = _specs(R, [("sum", np.int64), ("count", None),
                       ("max", np.int64)])
    port_specs = _specs(P, [("sum", np.int64), ("count", None),
                            ("max", np.int64)])
    rng = np.random.default_rng(21)
    chunks = []
    for _ in range(6):
        n = 200
        g = rng.integers(0, 40, n).astype(np.int64)
        hi, lo = ref_lanes.split_i64(g)
        keys = np.stack([hi, lo, np.ones(n, np.int32)], axis=1)
        v = rng.integers(-1000, 1000, n)
        inputs = tuple((s.encode_input(v), np.ones(n, bool))
                       if s.in_dtype is not None else ((), None)
                       for s in specs)
        chunks.append((keys, np.ones(n, np.int32), np.ones(n, bool), inputs))
    ref_k = R.GroupedAggKernel(KW, specs)
    for c in chunks[:3]:
        ref_k.apply(*c)
    ref_k.flush()
    ref_k.advance()
    port_k = P.GroupedAggKernel(KW, port_specs, device="cpu")
    port_k.state = from_jax_state(ref_k.state, CPU)
    _assert_state_equal(port_k.state, ref_k.state, specs)
    for c in chunks[3:]:
        ref_k.apply(*c)
        port_k.apply(*c)
    rf, pf = ref_k.flush(), port_k.flush()
    assert pf.n == rf.n > 0
    np.testing.assert_array_equal(pf.keys, rf.keys)
    for a, b in zip(pf.outs + pf.prev_outs, rf.outs + rf.prev_outs):
        np.testing.assert_array_equal(a, b)
    ref_k.advance()
    port_k.advance()
    _assert_state_equal(port_k.state, ref_k.state, specs)


def test_flush_overflow_retry_matches_reference():
    """flush_capacity=1 forces the header-compare/double/refetch path."""
    pairs = [("sum", np.int64), ("count", None)]
    specs, port_specs = _specs(R, pairs), _specs(P, pairs)
    n = 64
    gk = (np.arange(n, dtype=np.int64) % 13) * 1_000_000
    hi, lo = ref_lanes.split_i64(gk)
    args = (np.stack([hi, lo], axis=1), np.ones(n, dtype=np.int32),
            np.ones(n, dtype=bool),
            ((specs[0].encode_input(np.arange(n)), np.ones(n, bool)),
             ((), None)))
    ref_k = R.GroupedAggKernel(key_width=2, specs=specs, flush_capacity=1)
    port_k = P.GroupedAggKernel(key_width=2, specs=port_specs,
                                flush_capacity=1, device="cpu")
    ref_k.apply(*args)
    port_k.apply(*args)
    rf, pf = ref_k.flush(), port_k.flush()
    assert pf.n == rf.n == 13 and port_k._flush_cap == ref_k._flush_cap
    np.testing.assert_array_equal(pf.keys, rf.keys)
    for a, b in zip(pf.outs, rf.outs):
        np.testing.assert_array_equal(a, b)
    port_k.advance()
    assert not bool(port_k.state.st[P.ROW_DIRTY].any())


# -- executor cases mirrored from tests/test_hash_agg.py -----------------------

def _schema(types):
    return types.Schema.of(g=types.DataType.INT64, v=types.DataType.INT64)


def _barrier(msg, epoch, n):
    curr = epoch.Epoch.from_physical(n)
    prev = epoch.Epoch.from_physical(n - 1) if n > 1 else epoch.Epoch.INVALID
    return msg.Barrier(epoch.EpochPair(curr, prev),
                       msg.BarrierKind.CHECKPOINT)


_PKG = {
    "ref": (ref_types, ref_epoch, ref_msg, ref_chunk, ref_exec, ref_utils,
            RefStateTable, RefStore, ref_agg),
    "port": (port_types, port_epoch, port_msg, port_chunk, port_exec,
             port_utils, PortStateTable, PortStore, port_agg),
}


def _script(pkg, steps):
    """Abstract steps → one package's messages. A step is ("b", n) or
    ("c", groups, values, ops|None)."""
    types, epoch, msg, chunk = _PKG[pkg][:4]
    schema = _schema(types)
    out = []
    for s in steps:
        if s[0] == "b":
            out.append(_barrier(msg, epoch, s[1]))
        else:
            out.append(chunk.StreamChunk.from_pydict(
                schema, {"g": s[1], "v": s[2]}, ops=s[3]))
    return out


def _calls(pkg, calls):
    ex_mod, agg_mod = _PKG[pkg][4], _PKG[pkg][8]
    return [ex_mod.AggCall(agg_mod.AggKind(k), i) for k, i in calls]


def _drive(pkg, steps, calls, append_only, store=None):
    types, _e, _m, _c, ex_mod, utils, StateTable, Store, _a = _PKG[pkg]
    store = store if store is not None else Store()
    schema = _schema(types)
    agg_calls = _calls(pkg, calls)
    sschema, spk = ex_mod.agg_state_schema(schema, [0], agg_calls)
    table = StateTable(10, sschema, spk, store, dist_key_indices=[0])
    kw = {"device": "cpu"} if pkg == "port" else {}
    ex = ex_mod.HashAggExecutor(utils.MockSource(schema, _script(pkg, steps)),
                                [0], agg_calls, table,
                                append_only=append_only, **kw)
    n_barriers = sum(1 for s in steps if s[0] == "b")
    msgs = asyncio.run(utils.collect_until_n_barriers(ex, n_barriers))
    records = [m.to_records() if hasattr(m, "to_records") else type(m)
               .__name__ for m in msgs]
    return records, list(table.iter_rows()), ex, store


def _random_stream(seed, n_chunks, rows, groups, per_barrier=2):
    rng = np.random.default_rng(seed)
    live, steps, b = [], [("b", 1)], 2
    for i in range(n_chunks):
        gs, vs, ops = [], [], []
        for _ in range(rows):
            if live and rng.random() < 0.4:
                g, v = live.pop(int(rng.integers(0, len(live))))
                gs.append(g), vs.append(v), ops.append(2)
            else:
                g, v = int(rng.integers(0, groups)), int(rng.integers(-50, 50))
                live.append((g, v))
                gs.append(g), vs.append(v), ops.append(1)
        steps.append(("c", gs, vs, ops))
        if i % per_barrier == per_barrier - 1:
            steps.append(("b", b))
            b += 1
    return steps


def _q7_shape():
    rng = np.random.default_rng(3)
    steps = [("b", 1)]
    for e in range(5):
        for _ in range(3):
            steps.append(("c", rng.integers(0, 6, 64).tolist(),
                          rng.integers(0, 10_000, 64).tolist(), None))
        steps.append(("b", e + 2))
    return steps


def _growth():
    steps = [("b", 1)]
    for start in range(0, 1024, 256):
        steps.append(("c", list(range(start, start + 256)), [1] * 256, None))
    return steps + [("b", 2)]


CASES = {
    "count_sum_insert_only": (
        [("b", 1), ("c", [1, 1, 2], [10, 20, 5], None), ("b", 2),
         ("c", [2, 3], [7, 100], None), ("b", 3)],
        [("count", None), ("sum", 1)], False),
    "retraction_to_zero_emits_delete": (
        [("b", 1), ("c", [1, 1], [10, 20], None), ("b", 2),
         ("c", [1, 1], [10, 20], [2, 2]), ("b", 3)],
        [("count", None), ("sum", 1)], False),
    "create_delete_within_epoch": (
        [("b", 1), ("c", [9], [1], None), ("c", [9], [1], [2]), ("b", 2)],
        [("count", None)], False),
    "null_inputs_and_null_group_key": (
        [("b", 1), ("c", [1, 1, None], [None, 3, 8], None), ("b", 2)],
        [("count", None), ("count", 1), ("sum", 1)], False),
    "max_append_only_q7_shape": (
        _q7_shape(), [("max", 1), ("count", None)], True),
    "random_stream_sum_count": (
        _random_stream(11, 16, 32, 10),
        [("count", None), ("sum", 1), ("count", 1)], False),
    "growth_under_many_groups": (_growth(), [("sum", 1)], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_case_matches_reference(case):
    steps, calls, append_only = CASES[case]
    ref_records, ref_rows, ref_ex, _ = _drive("ref", steps, calls,
                                              append_only)
    port_records, port_rows, port_ex, _ = _drive("port", steps, calls,
                                                 append_only)
    assert port_records == ref_records
    assert port_rows == ref_rows
    assert port_ex.kernel.capacity == ref_ex.kernel.capacity
    if case == "growth_under_many_groups":
        assert port_ex.kernel.capacity > 1024


def test_executor_recovery_matches_reference():
    """Phase 1 commits state; a fresh executor over the same store must
    rebuild it (K1 + K9, as load_groups) and emit updates, not inserts."""
    calls = [("count", None), ("sum", 1)]
    phase1 = [("b", 1), ("c", [1, 2], [10, 20], None), ("b", 2)]
    phase2 = [("b", 3), ("c", [1, 3], [5, 7], None), ("b", 4)]
    out = {}
    for pkg in ("ref", "port"):
        _r, _rows, _ex, store = _drive(pkg, phase1, calls, False)
        store.seal_epoch(port_epoch.Epoch.from_physical(2).value, True)
        store.sync(port_epoch.Epoch.from_physical(2).value)
        out[pkg] = _drive(pkg, phase2, calls, False, store=store)[:2]
    assert out["port"] == out["ref"]
    recs = [r for m in out["port"][0] if isinstance(m, list) for r in m]
    assert {op.name for op, _row in recs} == {"INSERT", "UPDATE_DELETE",
                                              "UPDATE_INSERT"}
