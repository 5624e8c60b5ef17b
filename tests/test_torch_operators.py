"""The small stream executors of the PyTorch port, against the JAX
reference: union, expand, the watermark filter, the wrapper, the simple
aggs, the dynamic filter, append-only dedup, ProjectSet and the EMIT ON
WINDOW CLOSE gate.

Every case builds the same script in both packages and runs it through
the reference executor and the port's: the message streams must be equal
message for message (records with their ops, barriers, watermarks) and
the state tables row for row.

- ``tests/test_operators.py``'s cases that the TopN and hop-window twins
  do not cover (union x2, expand, the watermark filter x2, the wrapper x3,
  the simple aggs x4, the dynamic filter x4, dedup), each with the
  reference test's own expectation;
- the same executors on scripts made from a numpy seed;
- ProjectSet (series and scalar items, retractions, update pairs
  demoted) and the EOWC gate (release order, recovery from its state
  table, a late change raising), which the reference tests only through
  SQL;
- SimpleAgg's exact integer SUM over values near the int64 bounds.
"""

import asyncio
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.expr.expr as r_expr
import risingwave_tpu.ops.hash_agg as r_ops_agg
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu.stream.executors.dedup as r_dedup
import risingwave_tpu.stream.executors.dynamic_filter as r_dyn
import risingwave_tpu.stream.executors.eowc as r_eowc
import risingwave_tpu.stream.executors.expand as r_expand
import risingwave_tpu.stream.executors.hash_agg as r_agg
import risingwave_tpu.stream.executors.project_set as r_ps
import risingwave_tpu.stream.executors.simple_agg as r_sagg
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.executors.union as r_union
import risingwave_tpu.stream.executors.watermark_filter as r_wmf
import risingwave_tpu.stream.executors.wrapper as r_wrap
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.expr.expr as p_expr
import risingwave_tpu_torch.ops.hash_agg as p_ops_agg
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store
import risingwave_tpu_torch.stream.executors.dedup as p_dedup
import risingwave_tpu_torch.stream.executors.dynamic_filter as p_dyn
import risingwave_tpu_torch.stream.executors.eowc as p_eowc
import risingwave_tpu_torch.stream.executors.expand as p_expand
import risingwave_tpu_torch.stream.executors.hash_agg as p_agg
import risingwave_tpu_torch.stream.executors.project_set as p_ps
import risingwave_tpu_torch.stream.executors.simple_agg as p_sagg
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.executors.union as p_union
import risingwave_tpu_torch.stream.executors.watermark_filter as p_wmf
import risingwave_tpu_torch.stream.executors.wrapper as p_wrap
import risingwave_tpu_torch.stream.message as p_msg

PKGS = {
    "ref": SimpleNamespace(
        chunk=r_chunk, epoch=r_epoch, types=r_types, expr=r_expr,
        ops_agg=r_ops_agg, st=r_st, store=r_store, dedup=r_dedup,
        dyn=r_dyn, eowc=r_eowc, expand=r_expand, agg=r_agg, ps=r_ps,
        sagg=r_sagg, tu=r_tu, union=r_union, wmf=r_wmf, wrap=r_wrap,
        msg=r_msg),
    "port": SimpleNamespace(
        chunk=p_chunk, epoch=p_epoch, types=p_types, expr=p_expr,
        ops_agg=p_ops_agg, st=p_st, store=p_store, dedup=p_dedup,
        dyn=p_dyn, eowc=p_eowc, expand=p_expand, agg=p_agg, ps=p_ps,
        sagg=p_sagg, tu=p_tu, union=p_union, wmf=p_wmf, wrap=p_wrap,
        msg=p_msg),
}

INSERT, DELETE, U_DEL, U_INS = 1, 2, 3, 4


# -- scripts: built per package from one plain description ------------------------

def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def schema_of(m, cols):
    """cols: [(name, type name)]."""
    T = m.types
    return T.Schema.of(**{nm: getattr(T.DataType, t) for nm, t in cols})


S2 = [("k", "INT64"), ("v", "INT64")]
RHS = [("bound", "INT64"), ("dummy", "INT64")]
TS2 = [("ts", "TIMESTAMP"), ("v", "INT64")]


def script(m, cols, steps):
    """("b", n) a barrier, ("w", col, type, value) a watermark,
    ("c", rows, ops) a chunk of row tuples (None for NULL)."""
    sch = schema_of(m, cols)
    out = []
    for st in steps:
        if st[0] == "b":
            out.append(barrier(m, st[1]))
        elif st[0] == "w":
            out.append(m.msg.Watermark(
                st[1], getattr(m.types.DataType, st[2]), st[3]))
        else:
            _c, rows, ops = st
            data = {nm: [r[i] for r in rows]
                    for i, (nm, _t) in enumerate(cols)}
            out.append(m.chunk.StreamChunk.from_pydict(sch, data, ops=ops))
    return out


def C(rows, ops=None):
    return ("c", [tuple(r) for r in rows], ops)


def B(n):
    return ("b", n)


def source(m, cols, steps, pk=None):
    return m.tu.MockSource(schema_of(m, cols), script(m, cols, steps),
                           pk_indices=pk)


def norm(m, msgs):
    """A message stream in a package-free form."""
    out = []
    for x in msgs:
        if m.msg.is_chunk(x):
            out.append(("C", [(int(op), r) for op, r in x.to_records()]))
        elif m.msg.is_barrier(x):
            out.append(("B", x.epoch.curr.value))
        else:
            out.append(("W", x.col_idx, x.value))
    return out


def collect(m, ex, n_barriers):
    return norm(m, asyncio.run(m.tu.collect_until_n_barriers(ex, n_barriers)))


def drain(m, ex):
    async def go():
        return [x async for x in ex.execute()]
    return norm(m, asyncio.run(go()))


def records(stream):
    return [rec for item in stream if item[0] == "C" for rec in item[1]]


def net_view(stream) -> Counter:
    view = Counter()
    for op, row in records(stream):
        view[row] += 1 if op in (INSERT, U_INS) else -1
    return Counter({k: v for k, v in view.items() if v != 0})


def rows_of(table):
    return [(tuple(pk), tuple(r)) for pk, r in table.iter_rows()]


def both(fn):
    """fn(m) -> (stream, [state tables]) in each package: equal streams,
    equal state rows; returns the port's stream."""
    got = {}
    for pkg in ("ref", "port"):
        stream, tables = fn(PKGS[pkg])
        got[pkg] = (stream, [rows_of(t) for t in tables])
    assert got["port"][0] == got["ref"][0], "message streams differ"
    assert got["port"][1] == got["ref"][1], "state tables differ"
    return got["port"][0]


def raises_in_both(fn, exc_name):
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        exc = {"SanityError": m.wrap.SanityError,
               "NotImplementedError": NotImplementedError,
               "RuntimeError": RuntimeError}[exc_name]
        with pytest.raises(exc):
            fn(m)


# -- Union (tests/test_operators.py:78, :89) ---------------------------------------

def test_union_merges_aligned_inputs_matches_reference():
    def run(m):
        u = m.union.UnionExecutor([
            source(m, S2, [B(1), C([(1, 10)]), B(2)]),
            source(m, S2, [B(1), C([(2, 20)]), B(2)])])
        return collect(m, u, 2), []
    got = both(run)
    assert net_view(got) == Counter({(1, 10): 1, (2, 20): 1})
    assert sum(1 for x in got if x[0] == "B") == 2   # one per epoch


def test_union_watermark_is_min_across_inputs_matches_reference():
    def run(m):
        u = m.union.UnionExecutor([
            source(m, S2, [B(1), ("w", 0, "INT64", 10), B(2)]),
            source(m, S2, [B(1), ("w", 0, "INT64", 5), B(2)])])
        return collect(m, u, 2), []
    got = both(run)
    assert [x[2] for x in got if x[0] == "W"] == [5]


# -- Expand (tests/test_operators.py:103) ------------------------------------------

def test_expand_subsets_and_flag_matches_reference():
    def run(m):
        ex = m.expand.ExpandExecutor(
            source(m, S2, [B(1), C([(1, 10)]), B(2)]),
            column_subsets=[[0], [1]])
        assert len(ex.schema) == 5 and ex.schema[4].name == "flag"
        return collect(m, ex, 2), []
    recs = records(both(run))
    assert (INSERT, (1, None, 1, 10, 0)) in recs
    assert (INSERT, (None, 10, 1, 10, 1)) in recs
    assert len(recs) == 2


# -- WatermarkFilter (tests/test_operators.py:147, :171) ---------------------------

def _wm_state(m, store):
    return m.st.StateTable(41, m.wmf.WATERMARK_STATE_SCHEMA, [0], store)


def test_watermark_filter_emits_and_drops_late_matches_reference():
    def run(m):
        state = _wm_state(m, m.store.MemoryStateStore())
        ex = m.wmf.WatermarkFilterExecutor(
            source(m, TS2, [B(1), C([(100, 1), (200, 2)]), B(2),
                            # late (50 < 200 - 100) and fresh rows
                            C([(50, 3), (300, 4)]), B(3)]),
            time_col=0, delay=m.types.Interval(usecs=100), state=state)
        return collect(m, ex, 3), [state]
    got = both(run)
    rows = [r for _op, r in records(got)]
    assert (50, 3) not in rows
    assert set(rows) == {(100, 1), (200, 2), (300, 4)}
    assert [x[2] for x in got if x[0] == "W"] == [100, 200]


def test_watermark_filter_recovers_watermark_matches_reference():
    def run(m):
        store = m.store.MemoryStateStore()
        ex1 = m.wmf.WatermarkFilterExecutor(
            source(m, TS2, [B(1), C([(500, 1)]), B(2)]), time_col=0,
            delay=m.types.Interval(usecs=100),
            state=_wm_state(m, store))
        first = collect(m, ex1, 2)
        state = _wm_state(m, store)
        ex2 = m.wmf.WatermarkFilterExecutor(
            source(m, TS2, [B(3)]), time_col=0,
            delay=m.types.Interval(usecs=100), state=state)
        # the restored watermark follows the first barrier
        return first + drain(m, ex2), [state]
    got = both(run)
    assert [x[2] for x in got if x[0] == "W"][-1:] == [400]


# -- Wrapper (tests/test_operators.py:201, :207, :215) -----------------------------

def test_wrapper_passes_valid_stream_matches_reference():
    def run(m):
        ex = m.wrap.WrapperExecutor(
            source(m, S2, [B(1), C([(1, 2)]), B(2)]))
        return collect(m, ex, 2), []
    assert len(records(both(run))) == 1


def test_wrapper_catches_broken_update_pair_in_both():
    raises_in_both(lambda m: collect(m, m.wrap.WrapperExecutor(
        source(m, S2, [B(1), C([(1, 1), (2, 2)], [U_DEL, INSERT])])), 2),
        "SanityError")


def test_wrapper_catches_epoch_regression_in_both():
    raises_in_both(lambda m: collect(m, m.wrap.WrapperExecutor(
        source(m, S2, [B(2), B(1)])), 2), "SanityError")


# -- SimpleAgg / StatelessSimpleAgg (tests/test_operators.py:233-271) --------------

def _calls(m, spec):
    K = m.ops_agg.AggKind
    return [m.agg.AggCall(getattr(K, kind), idx) for kind, idx in spec]


def _simple_agg(m, steps, spec, append_only=False, store=None, cols=S2):
    store = store or m.store.MemoryStateStore()
    calls = _calls(m, spec)
    src = source(m, cols, steps)
    sch, pk = m.sagg.simple_agg_state_schema(src.schema, calls)
    state = m.st.StateTable(51, sch, pk, store)
    return m.sagg.SimpleAggExecutor(src, calls, state,
                                    append_only=append_only), state


def test_simple_agg_count_sum_first_emit_then_updates_matches_reference():
    def run(m):
        ex, state = _simple_agg(
            m, [B(1), B(2), C([(1, 10), (2, 20)]), B(3),
                C([(1, 10)], [DELETE]), B(4)],
            [("COUNT", None), ("SUM", 1)])
        return collect(m, ex, 4), [state]
    recs = records(both(run))
    # the first barrier with no input emits the initial row
    assert recs[0] == (INSERT, (0, None))
    assert (U_INS, (2, 30)) in recs
    assert recs[-1] == (U_INS, (1, 20))


def test_simple_agg_max_append_only_and_recovery_matches_reference():
    spec = [("MAX", 1), ("COUNT", None)]

    def run(m):
        store = m.store.MemoryStateStore()
        ex1, _s = _simple_agg(m, [B(1), C([(1, 7), (2, 30)]), B(2)], spec,
                              append_only=True, store=store)
        first = collect(m, ex1, 2)
        assert records(first)[-1] == (INSERT, (30, 2))
        # a restart over the same store: no second initial insert
        ex2, state = _simple_agg(m, [B(3), C([(5, 40)]), B(4)], spec,
                                 append_only=True, store=store)
        return first + collect(m, ex2, 2), [state]
    got = both(run)
    assert records(got)[-2:] == [(U_DEL, (30, 2)), (U_INS, (40, 3))]


def test_simple_agg_min_retractable_rejected_in_both():
    raises_in_both(lambda m: _simple_agg(m, [], [("MIN", 1)]),
                   "NotImplementedError")


def test_stateless_simple_agg_partials_matches_reference():
    def run(m):
        ex = m.sagg.StatelessSimpleAggExecutor(
            source(m, S2, [B(1), C([(1, 10), (2, 20)]),
                           C([(3, 5)], [DELETE]), B(2)]),
            _calls(m, [("COUNT", None), ("SUM", 1)]))
        return collect(m, ex, 2), []
    assert records(both(run)) == [(INSERT, (2, 30)), (INSERT, (-1, -5))]


def test_simple_agg_exact_integer_sum_near_int64_bounds_matches_reference():
    """Within an epoch the sum passes 2^64 and comes back: exact Python
    ints give 2^63 - 1 at the barrier, where an int64 accumulator could
    wrap and a float64 one rounds (neither 2^63 - 1 nor 2^53 + 1 is a
    float64). The output column is INT64 in both packages."""
    top = (1 << 63) - 1
    low = -(1 << 63)

    def run(m):
        ex, state = _simple_agg(
            m, [B(1), C([(1, top), (2, top)]), C([(3, top)], [DELETE]),
                B(2), C([(4, low), (5, top), (6, 1)]), B(3),
                C([(7, -top), (8, (1 << 53) + 1)]), B(4)],
            [("SUM", 1), ("COUNT", 1)])
        assert [f.data_type.name for f in ex.schema] == ["INT64", "INT64"]
        return collect(m, ex, 4), [state]
    assert records(both(run)) == [
        (INSERT, (top, 1)),
        (U_DEL, (top, 1)), (U_INS, (top, 4)),
        (U_DEL, (top, 4)), (U_INS, ((1 << 53) + 1, 6))]


# -- DynamicFilter (tests/test_operators.py:375-407) -------------------------------

def _dyn(m, left, right, cmp):
    lt = m.st.StateTable(71, schema_of(m, S2), [1],
                         m.store.MemoryStateStore(), dist_key_indices=[])
    ex = m.dyn.DynamicFilterExecutor(
        source(m, S2, left, pk=[1]), source(m, RHS, right),
        left_col=1, comparator=cmp, left_state=lt)
    return ex, lt


def rhs(vals, ops=None):
    return C([(v, 0) for v in vals], ops)


DYN_CASES = {
    # epoch 2: bound 15 applies at the barrier (20, 30 out then); epoch
    # 3: 25 passes at once; epoch 4: bound 28 retracts 20 and 25
    "emits_on_bound_and_transitions": (
        [B(1), C([(1, 10), (1, 20), (1, 30)]), B(2), C([(1, 25)]), B(3),
         B(4)],
        [B(1), rhs([15]), B(2), B(3), rhs([15, 28], [U_DEL, U_INS]),
         B(4)], ">", 4, {(1, 30): 1}),
    "initial_bound_emits_backlog": (
        [B(1), C([(1, 10), (1, 30)]), B(2), B(3)],
        [B(1), B(2), rhs([20]), B(3)], ">=", 3, {(1, 30): 1}),
    "less_than": (
        [B(1), C([(1, 10), (1, 30)]), B(2), B(3)],
        [B(1), rhs([20]), B(2), B(3)], "<", 3, {(1, 10): 1}),
    "null_rows_never_match": (
        [B(1), C([(1, None), (1, 50)]), B(2), B(3)],
        [B(1), rhs([20]), B(2), B(3)], ">", 3, {(1, 50): 1}),
}


@pytest.mark.parametrize("name", list(DYN_CASES))
def test_dynamic_filter_matches_reference(name):
    left, right, cmp, n, want = DYN_CASES[name]

    def run(m):
        ex, lt = _dyn(m, left, right, cmp)
        return collect(m, ex, n), [lt]
    assert net_view(both(run)) == Counter(want)


# -- AppendOnlyDedup (tests/test_operators.py:418) ---------------------------------

def test_append_only_dedup_first_wins_and_recovers_matches_reference():
    def run(m):
        store = m.store.MemoryStateStore()
        key_schema = schema_of(m, [("k", "INT64")])

        def go(steps, n):
            state = m.st.StateTable(70, key_schema, [0], store)
            ex = m.dedup.AppendOnlyDedupExecutor(source(m, S2, steps), [0],
                                                 state)
            return collect(m, ex, n), state
        first, _s = go([B(1), C([(1, 10), (2, 20), (1, 11)]), B(2),
                        C([(2, 21), (3, 30)]), B(3)], 3)
        assert [r for _op, r in records(first)] == \
            [(1, 10), (2, 20), (3, 30)]
        # a restart over the same store: keys 1-3 stay deduped
        second, state = go([B(4), C([(3, 31), (4, 40)]), B(5)], 2)
        return first + second, [state]
    got = both(run)
    assert [r for _op, r in records(got)][-1:] == [(4, 40)]


# -- the same executors on scripts made from a numpy seed --------------------------

def _random_chunks(rng, n_chunks, rows, key_hi=6, val_hi=50, ops=False,
                   unique_v=False):
    """A random script; with ``unique_v`` no two live rows share v (a
    state table keyed by v)."""
    fresh = iter(rng.permutation(val_hi).tolist())
    steps = []
    epoch = 1
    steps.append(B(epoch))
    live: list = []
    for _ in range(n_chunks):
        rs, os_ = [], []
        for _r in range(int(rng.integers(1, rows + 1))):
            if ops and live and rng.random() < 0.3:
                row = live.pop(int(rng.integers(len(live))))
                rs.append(row)
                os_.append(DELETE)
            else:
                row = (int(rng.integers(key_hi)),
                       next(fresh) if unique_v
                       else int(rng.integers(val_hi)))
                live.append(row)
                rs.append(row)
                os_.append(INSERT)
        steps.append(C(rs, os_))
        if rng.random() < 0.4:
            epoch += 1
            steps.append(B(epoch))
    epoch += 1
    steps.append(B(epoch))
    return steps, epoch


SEEDS = [3, 11]


@pytest.mark.parametrize("seed", SEEDS)
def test_union_and_expand_random_scripts_match_reference(seed):
    rng = np.random.default_rng(seed)
    a, n = _random_chunks(rng, 12, 9, ops=True)
    bsteps = [s for s in a]           # same barriers, other rows
    bsteps = [C([(k + 100, v) for k, v in s[1]], s[2]) if s[0] == "c"
              else s for s in bsteps]

    def run(m):
        u = m.union.UnionExecutor([source(m, S2, a), source(m, S2, bsteps)])
        ex = m.expand.ExpandExecutor(u, column_subsets=[[0], [1], [0, 1]])
        return collect(m, ex, n), []
    got = both(run)
    assert len(records(got)) == 3 * 2 * sum(
        len(s[1]) for s in a if s[0] == "c")


@pytest.mark.parametrize("seed", SEEDS)
def test_simple_aggs_random_scripts_match_reference(seed):
    rng = np.random.default_rng(seed)
    steps, n = _random_chunks(rng, 16, 12, ops=True)
    spec = [("COUNT", None), ("SUM", 1), ("COUNT", 0), ("SUM", 0)]

    def run(m):
        ex, state = _simple_agg(m, steps, spec)
        stream = collect(m, ex, n)
        stateless = collect(m, m.sagg.StatelessSimpleAggExecutor(
            source(m, S2, steps), _calls(m, spec)), n)
        return stream + stateless, [state]
    got = both(run)
    # the last simple-agg row equals the net of the script
    net = Counter()
    for st in steps:
        if st[0] == "c":
            for row, op in zip(st[1], st[2]):
                net[row] += 1 if op == INSERT else -1
    live = [r for r, c in net.items() for _ in range(c)]
    last = [r for op, r in records(got)
            if op in (INSERT, U_INS) and len(r) == 4]
    want_sum = sum(v for _k, v in live)
    assert any(r[0] == len(live) and r[1] == want_sum for r in last)


@pytest.mark.parametrize("seed", SEEDS)
def test_dynamic_filter_random_bounds_match_reference(seed):
    rng = np.random.default_rng(seed)
    left, n = _random_chunks(rng, 14, 8, val_hi=1000, ops=True,
                             unique_v=True)
    # one bound move (or none) per epoch on the right
    right = [B(1)]
    cur = None
    for e in range(2, n + 1):
        if rng.random() < 0.7:
            new = int(rng.integers(1000))
            right.append(rhs([new]) if cur is None
                         else rhs([cur, new], [U_DEL, U_INS]))
            cur = new
        right.append(B(e))
    for cmp in (">", ">=", "<", "<="):
        def run(m):
            ex, lt = _dyn(m, left, right, cmp)
            return collect(m, ex, n), [lt]
        got = both(run)
        # the view equals the live rows that pass the last bound
        net = Counter()
        for st in left:
            if st[0] == "c":
                for row, op in zip(st[1], st[2]):
                    net[row] += 1 if op == INSERT else -1
        ops = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
               "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}[cmp]
        want = Counter({r: c for r, c in net.items()
                        if c and cur is not None and ops(r[1], cur)})
        assert net_view(got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_dedup_and_wrapper_random_scripts_match_reference(seed):
    rng = np.random.default_rng(seed)
    steps, n = _random_chunks(rng, 12, 10, key_hi=20)

    def run(m):
        state = m.st.StateTable(70, schema_of(m, [("k", "INT64")]), [0],
                                m.store.MemoryStateStore())
        ex = m.wrap.WrapperExecutor(m.dedup.AppendOnlyDedupExecutor(
            source(m, S2, steps), [0], state))
        return collect(m, ex, n), [state]
    got = both(run)
    keys = [r[0] for _op, r in records(got)]
    assert len(keys) == len(set(keys))


@pytest.mark.parametrize("seed", SEEDS)
def test_watermark_filter_random_script_matches_reference(seed):
    rng = np.random.default_rng(seed)
    steps = [B(1)]
    t = 1000
    for e in range(2, 8):
        for _c in range(int(rng.integers(1, 4))):
            rows = []
            for _r in range(int(rng.integers(1, 8))):
                t += int(rng.integers(-30, 60))
                rows.append((t, int(rng.integers(100))))
            steps.append(C(rows))
        steps.append(B(e))

    def run(m):
        state = _wm_state(m, m.store.MemoryStateStore())
        ex = m.wmf.WatermarkFilterExecutor(
            source(m, TS2, steps), time_col=0,
            delay=m.types.Interval(usecs=40), state=state)
        return collect(m, ex, 7), [state]
    both(run)


# -- ProjectSet: direct parity ------------------------------------------------------

def _project_set(m, steps, cols=S2):
    E = m.expr
    T = m.types.DataType
    src = source(m, cols, steps, pk=[0])
    items = [
        ("scalar", E.InputRef(0, T.INT64)),
        ("series", (E.lit(1, T.INT64), E.InputRef(1, T.INT64),
                    E.lit(1, T.INT64))),
        ("series", (E.InputRef(1, T.INT64), E.lit(0, T.INT64),
                    E.lit(-2, T.INT64))),
    ]
    return m.ps.ProjectSetExecutor(src, items, ["k", "s", "s"],
                                   pass_pk=[0])


def test_project_set_series_and_scalar_items_match_reference():
    """Two series zip with NULL padding; a row whose series are both
    empty vanishes; duplicate output names stay positional."""
    def run(m):
        ex = _project_set(m, [B(1), C([(7, 3), (8, 0), (9, -1)]), B(2)])
        assert [f.name for f in ex.schema][:3] == ["k", "s", "s"]
        return collect(m, ex, 2), []
    recs = records(both(run))
    assert recs == [
        (INSERT, (7, 1, 3, 7, 0)), (INSERT, (7, 2, 1, 7, 1)),
        (INSERT, (7, 3, None, 7, 2)),
        (INSERT, (8, None, 0, 8, 0)),
    ]


def test_project_set_retraction_and_demoted_update_pairs_match_reference():
    def run(m):
        ex = _project_set(m, [
            B(1), C([(1, 2), (2, 1)]), B(2),
            C([(1, 2), (2, 1), (2, 3)], [DELETE, U_DEL, U_INS]), B(3)])
        return collect(m, ex, 3), []
    got = both(run)
    ops = [op for op, _r in records(got)]
    assert U_DEL not in ops and U_INS not in ops     # pairs demoted
    assert net_view(got) == Counter({
        (2, 1, 3, 2, 0): 1, (2, 2, 1, 2, 1): 1, (2, 3, None, 2, 2): 1})


@pytest.mark.parametrize("seed", SEEDS)
def test_project_set_random_script_matches_reference(seed):
    rng = np.random.default_rng(seed)
    steps, n = _random_chunks(rng, 10, 6, key_hi=50, val_hi=6, ops=True)

    def run(m):
        return collect(m, _project_set(m, steps), n), []
    both(run)


def test_project_set_watermark_follows_a_scalar_passthrough():
    def run(m):
        ex = _project_set(m, [B(1), ("w", 0, "INT64", 5),
                              ("w", 1, "INT64", 9), C([(1, 1)]), B(2)])
        return collect(m, ex, 2), []
    got = both(run)
    assert [x for x in got if x[0] == "W"] == [("W", 0, 5)]


# -- EowcGate: direct parity ---------------------------------------------------------

EOWC = [("w", "INT64"), ("k", "INT64"), ("v", "INT64")]


def _eowc(m, steps, store):
    sch = schema_of(m, EOWC)
    state = m.st.StateTable(81, sch, [0, 1], store, dist_key_indices=[])
    ex = m.eowc.EowcGateExecutor(source(m, EOWC, steps, pk=[0, 1]), 0,
                                 state)
    return ex, state


def test_eowc_gate_releases_closed_windows_in_order_matches_reference():
    """Each row's latest version comes out once, as an INSERT, when the
    watermark passes its window; windows release in window order; a NULL
    window never closes."""
    steps = [B(1),
             C([(20, 1, 5), (10, 2, 7), (30, 1, 1), (None, 3, 3)]),
             C([(10, 2, 7), (10, 2, 8)], [U_DEL, U_INS]),
             ("w", 0, "INT64", 25), B(2),
             C([(30, 1, 1)], [DELETE]), C([(40, 4, 4)]),
             ("w", 1, "INT64", 99),          # not the window column
             ("w", 0, "INT64", 45), B(3)]

    def run(m):
        ex, state = _eowc(m, steps, m.store.MemoryStateStore())
        return collect(m, ex, 3), [state]
    got = both(run)
    assert [x for x in got if x[0] == "C"] == [
        ("C", [(INSERT, (10, 2, 8)), (INSERT, (20, 1, 5))]),
        ("C", [(INSERT, (40, 4, 4))])]
    assert [x for x in got if x[0] == "W"] == [("W", 0, 25), ("W", 0, 45)]


def test_eowc_gate_recovers_its_buffer_from_the_state_table():
    def run(m):
        store = m.store.MemoryStateStore()
        ex1, _s = _eowc(m, [B(1), C([(10, 1, 1), (50, 2, 2)]),
                            ("w", 0, "INT64", 20), B(2)], store)
        first = collect(m, ex1, 2)
        ex2, state = _eowc(m, [B(3), C([(60, 3, 3)]),
                               ("w", 0, "INT64", 70), B(4)], store)
        return first + collect(m, ex2, 2), [state]
    got = both(run)
    chunks = [x for x in got if x[0] == "C"]
    assert chunks[-1] == ("C", [(INSERT, (50, 2, 2)), (INSERT, (60, 3, 3))])


def test_eowc_gate_late_change_to_a_released_window_raises_in_both():
    steps = [B(1), C([(10, 1, 1)]), ("w", 0, "INT64", 20), B(2),
             C([(15, 2, 2)]), B(3)]
    raises_in_both(
        lambda m: collect(m, _eowc(m, steps, m.store.MemoryStateStore())[0],
                          3), "RuntimeError")
