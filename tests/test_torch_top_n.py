"""GroupTopNExecutor / TopNExecutor on the PyTorch port, against the JAX
reference.

The reference's executor tests run against both packages on the same
scripted chunks: each package's output must be the reference test's
expectation, and the two packages' message streams must be equal record
for record, with equal state tables at the end:

- ``tests/test_operators.py:297-343``: window maintenance, OFFSET, DESC,
  per-group windows, recovery from the state table, append-only pruning;
- ``tests/test_state_tier.py:445`` (a cold group touched by a later chunk
  reloads its pre-chunk state, a delete against a cold group retracts)
  and :477 (the tier's guards);
- PostgreSQL's NULL order (last for ASC, first for DESC), on the native
  tuple keys and on the comparator keys a VARCHAR DESC column needs
  (``_fast_keys`` off), with U-/U+ pairs;
- the deviation ROADMAP.md queue C declares for the card (the agg's
  flush order follows K1's slots): a barrier's agg rows in other orders
  and chunkings give the same view after every barrier and the same
  state.
"""

import asyncio
from collections import Counter
from types import SimpleNamespace

import pytest

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu.state.tier as r_tier
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.executors.top_n as r_topn
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu.utils.memory as r_memory
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store
import risingwave_tpu_torch.state.tier as p_tier
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.executors.top_n as p_topn
import risingwave_tpu_torch.stream.message as p_msg
import risingwave_tpu_torch.utils.memory as p_memory

PKGS = {
    "ref": SimpleNamespace(chunk=r_chunk, epoch=r_epoch, types=r_types,
                           st=r_st, store=r_store, tu=r_tu, topn=r_topn,
                           msg=r_msg),
    "port": SimpleNamespace(chunk=p_chunk, epoch=p_epoch, types=p_types,
                            st=p_st, store=p_store, tu=p_tu, topn=p_topn,
                            msg=p_msg),
}


@pytest.fixture(autouse=True)
def _fresh_tier(monkeypatch):
    """Empty global tiers and no memory pressure in both packages."""
    for mod, mem in ((r_tier, r_memory), (p_tier, p_memory)):
        monkeypatch.setattr(mod, "GLOBAL", mod.StateTier())
        monkeypatch.setattr(mem.GLOBAL, "soft_limit", None)
    yield


def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def s2(m):
    T = m.types
    return T.Schema.of(k=T.DataType.INT64, v=T.DataType.INT64)


def rows_chunk(m, schema, rows, ops=None):
    names = [f.name for f in schema]
    return m.chunk.StreamChunk.from_pydict(
        schema, {nm: [r[i] for r in rows] for i, nm in enumerate(names)},
        ops=ops)


def build(m, steps, schema):
    """A scripted message list: ("b", n) a barrier, (rows, ops) a chunk."""
    out = []
    for st in steps:
        if st[0] == "b":
            out.append(barrier(m, st[1]))
        else:
            rows, ops = st
            out.append(rows_chunk(m, schema, rows, ops))
    return out


def run(pkg, steps, order_by, offset, limit, group_indices=(),
        append_only=False, store=None, schema=s2, table_pk=None,
        tier_cap=None, pk_indices=None, src_pk=(1,)):
    m = PKGS[pkg]
    S = schema(m)
    store = store or m.store.MemoryStateStore()
    src = m.tu.MockSource(S, build(m, steps, S), pk_indices=list(src_pk))
    pk = table_pk or ([0, 1] if group_indices else [1])
    state = m.st.StateTable(61, S, pk, store, dist_key_indices=[])
    kw = {} if tier_cap is None else dict(tier_cap=tier_cap)
    if pk_indices is not None:
        kw["pk_indices"] = pk_indices
    ex = m.topn.GroupTopNExecutor(src, order_by, offset, limit, state,
                                  group_indices=group_indices,
                                  append_only=append_only, **kw)
    n_b = sum(1 for st in steps if st[0] == "b")
    msgs = asyncio.run(m.tu.collect_until_n_barriers(ex, n_b))
    recs = [[(int(op), r) for op, r in x.to_records()]
            for x in msgs if m.msg.is_chunk(x)]
    return ex, recs, [tuple(r) for _pk, r in state.iter_rows()], store


def net_view(recs) -> Counter:
    out = Counter()
    for rec in recs:
        for op, row in rec:
            out[row] += 1 if op in (1, 4) else -1
    return +Counter({k: v for k, v in out.items() if v})


def both(steps, *a, **kw):
    port = run("port", steps, *a, **kw)
    ref = run("ref", steps, *a, **kw)
    assert port[1] == ref[1], "emitted records differ"
    assert port[2] == ref[2], "state tables differ"
    return port


def C(rows, ops=None):
    return (rows, ops)


# -- tests/test_operators.py:297-343 -----------------------------------------------

CASES = {
    # top-2 by v ascending, pk = v: an insert displaces, a delete refills
    "basic_window_maintenance": (
        [("b", 1), C([(1, 30), (1, 10), (1, 20)]), ("b", 2),
         C([(1, 5)]), ("b", 3), C([(1, 10)], [2]), ("b", 4)],
        dict(order_by=[(1, False)], offset=0, limit=2),
        {(1, 5): 1, (1, 20): 1}),
    "offset_skips_leaders": (
        [("b", 1), C([(1, 30), (1, 10), (1, 20)]), ("b", 2)],
        dict(order_by=[(1, False)], offset=1, limit=1), {(1, 20): 1}),
    "descending": (
        [("b", 1), C([(1, 30), (1, 10), (1, 20)]), ("b", 2)],
        dict(order_by=[(1, True)], offset=0, limit=2),
        {(1, 30): 1, (1, 20): 1}),
    "group_topn_per_group_windows": (
        [("b", 1), C([(1, 10), (1, 20), (2, 7), (2, 5), (2, 6)]), ("b", 2)],
        dict(order_by=[(1, False)], offset=0, limit=1, group_indices=[0]),
        {(1, 10): 1, (2, 5): 1}),
    "append_only_prunes_state": (
        [("b", 1), C([(1, 40), (1, 10), (1, 30), (1, 20)]), ("b", 2)],
        dict(order_by=[(1, False)], offset=0, limit=2, append_only=True),
        {(1, 10): 1, (1, 20): 1}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_topn_operator_cases_match_reference(name):
    steps, kw, want = CASES[name]
    _ex, recs, state, _s = both(steps, **kw)
    assert net_view(recs) == Counter(want)
    if kw.get("append_only"):
        assert [r[1] for r in state] == [10, 20]   # only the window kept


def test_topn_recovery_from_state_matches_reference():
    """A restart recovers the candidates from the state table: a smaller
    row displaces the recovered leader."""
    out = {}
    for pkg in ("ref", "port"):
        store = PKGS[pkg].store.MemoryStateStore()
        kw = dict(order_by=[(1, False)], offset=0, limit=1, store=store)
        run(pkg, [("b", 1), C([(1, 10), (1, 20)]), ("b", 2)], **kw)
        _ex, recs, state, _s = run(pkg, [("b", 3), C([(1, 5)]), ("b", 4)],
                                   **kw)
        out[pkg] = (recs, state)
        assert net_view(recs) == Counter({(1, 5): 1}) and \
            sum(1 for rec in recs for op, r in rec
                if r == (1, 10) and op == 2) == 1
    assert out["port"] == out["ref"]


# -- PostgreSQL's NULL order, fast and comparator keys ------------------------------

def _kvs(m):
    T = m.types
    return T.Schema.of(k=T.DataType.INT64, v=T.DataType.INT64,
                       s=T.DataType.VARCHAR)


NULL_STEPS = [
    ("b", 1),
    C([(1, None, "b"), (1, 3, "a"), (1, 7, None), (2, 1, "z"),
       (2, None, None)]), ("b", 2),
    C([(1, 3, "a"), (1, 4, "c")], [3, 4]), ("b", 3),
    C([(1, None, "b"), (2, 9, "y")], [2, 1]), ("b", 4),
]


@pytest.mark.parametrize("order_by", [[(1, False)], [(1, True)],
                                      [(2, True)], [(2, False), (1, True)]])
def test_topn_null_order_matches_reference(order_by):
    """NULLS LAST for ASC, FIRST for DESC; a VARCHAR DESC column turns the
    native tuple keys off (the comparator path). Each group's top 2, with
    a U-/U+ pair and a delete of a NULL row."""
    ex, recs, _state, _s = both(
        NULL_STEPS, order_by=order_by, offset=0, limit=2,
        group_indices=[0], schema=_kvs, table_pk=[0, 2], src_pk=(2,))
    assert ex._fast_keys == all(
        not d or i != 2 for i, d in order_by)
    view = net_view(recs)
    assert sum(view.values()) == 4
    if order_by == [(1, False)]:
        assert view == Counter({(1, 4, "c"): 1, (1, 7, None): 1,
                                (2, 1, "z"): 1, (2, 9, "y"): 1})
    if order_by == [(1, True)]:                  # NULLs first for DESC
        assert (2, None, None) in view and (1, 7, None) in view


# -- tests/test_state_tier.py:445, :477 ---------------------------------------------

def _gv(m):
    T = m.types
    return T.Schema.of(g=T.DataType.INT64, v=T.DataType.INT64)


def _cold_steps():
    steps = [("b", 1), C([(g, 10 + g) for g in range(8)]), ("b", 2)]
    for e in range(3, 8):          # group 0 ages out of a 4-group cap
        steps += [C([(7, 100 + e)]), ("b", e)]
    steps += [C([(0, 99)]), ("b", 8)]
    steps += [C([(0, 10)], [2]), ("b", 9)]
    steps += [C([(0, 99)], [2]), ("b", 10)]
    return steps


def test_group_topn_cold_touch_reloads_pre_chunk_state():
    """A cold group touched by a later chunk reloads its pre-chunk state:
    the delta replaces the old top with the new one, and a delete against
    a cold group retracts. Capped = uncapped, in both packages, with the
    same evictions and reloads."""
    kw = dict(order_by=[(1, True)], offset=0, limit=1, group_indices=[0],
              schema=_gv, pk_indices=[0, 1])
    parts = {}
    for cap in (4, None):
        ex, recs, state, _s = both(_cold_steps(), tier_cap=cap, **kw)
        parts[cap] = (net_view(recs), recs, state, ex)
    capped, uncapped = parts[4], parts[None]
    assert capped[:3] == uncapped[:3]
    part = capped[3]._tier_part
    assert part.evicted_total > 0 and part.reload_total > 0
    ref_ex = run("ref", _cold_steps(), tier_cap=4, **kw)[0]
    assert (part.evicted_total, part.reload_total) == \
        (ref_ex._tier_part.evicted_total, ref_ex._tier_part.reload_total)
    flat = Counter((r, op) for rec in uncapped[1] for op, r in rec)
    assert flat[((0, 99), 1)] == flat[((0, 99), 2)]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_group_topn_guards(pkg):
    m = PKGS[pkg]
    S = _gv(m)
    store = m.store.MemoryStateStore()
    G = m.topn.GroupTopNExecutor
    with pytest.raises(ValueError, match="prefixed"):
        G(m.tu.MockSource(S, []), [(1, True)], 0, 1,
          m.st.StateTable(5, S, [1], store), group_indices=[0],
          pk_indices=[0, 1], tier_cap=4)
    with pytest.raises(ValueError, match="grouped"):
        G(m.tu.MockSource(S, []), [(1, True)], 0, 1,
          m.st.StateTable(6, S, [0, 1], store), tier_cap=4)
    with pytest.raises(ValueError, match="dist keys"):
        G(m.tu.MockSource(S, []), [(1, True)], 0, 1,
          m.st.StateTable(7, S, [0, 1], store, dist_key_indices=[1]),
          group_indices=[0], tier_cap=4)
    plain = m.topn.TopNExecutor(m.tu.MockSource(S, [], pk_indices=[0, 1]),
                                [(1, False)], 0, 3,
                                m.st.StateTable(8, S, [0, 1], store))
    assert plain.identity == "TopNExecutor" and plain.pk_indices == [0, 1]


def test_append_only_topn_refuses_a_delete():
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError, match="append-only"):
            run(pkg, [("b", 1), C([(1, 4)]), ("b", 2), C([(1, 4)], [2]),
                      ("b", 3)],
                order_by=[(1, False)], offset=0, limit=2, append_only=True)


# -- the card's flush order (ROADMAP.md queue C) ------------------------------

def _agg_like_barrier(rng, groups, auctions):
    """Three barriers of an append-only COUNT agg's flushes as q5-hot's
    TopN sees them: each dirty (window, auction) group once a barrier, an
    insert when it is new, a U-/U+ pair when its count grew."""
    counts = {}
    barriers = []
    for _b in range(3):
        dirty = {}
        for _ in range(60):
            g = (int(rng.integers(0, groups)), int(rng.integers(0, auctions)))
            dirty[g] = dirty.get(g, counts.get(g, 0)) + \
                int(rng.integers(1, 4))
        rows, ops = [], []
        for g, c in dirty.items():
            if g in counts:
                rows += [g + (counts[g],), g + (c,)]
                ops += [3, 4]
            else:
                rows.append(g + (c,))
                ops.append(1)
            counts[g] = c
        barriers.append((rows, ops))
    return barriers


def _gac(m):
    T = m.types
    return T.Schema.of(w=T.DataType.INT64, a=T.DataType.INT64,
                       c=T.DataType.INT64)


def test_deviation_flush_order_moves_only_intermediate_chunks():
    """On the card the agg's flush follows K1's slots, so the TopN gets a
    barrier's rows in another order and chunking. The view after every
    barrier (so each barrier's net delta) and the state table are the
    same, and the reference's on the CPU order; only the chunks inside a
    barrier can differ."""
    import numpy as np
    rng = np.random.default_rng(7)
    barriers = _agg_like_barrier(rng, 4, 12)

    def steps(order_seed, chunk, n_barriers=3):
        r = np.random.default_rng(order_seed)
        out, e = [("b", 1)], 2
        for rows, ops in barriers[:n_barriers]:
            # keep each U-/U+ pair adjacent, as a flush emits it
            units, i = [], 0
            while i < len(rows):
                n = 2 if ops[i] == 3 else 1
                units.append((rows[i:i + n], ops[i:i + n]))
                i += n
            perm = r.permutation(len(units)) if order_seed else \
                range(len(units))
            flat = [units[k] for k in perm]
            for lo in range(0, len(flat), chunk):
                part = flat[lo:lo + chunk]
                out.append(C([x for rr, _o in part for x in rr],
                             [x for _r, oo in part for x in oo]))
            out.append(("b", e))
            e += 1
        return out

    def per_barrier(recs_steps):
        ex, recs, state, _s = run(
            "port", recs_steps, order_by=[(2, True), (1, False)],
            offset=0, limit=1, group_indices=[0], schema=_gac,
            table_pk=[0, 1], src_pk=(0, 1))
        return recs, state

    # the view after each barrier (so each barrier's net delta) and the
    # state agree; the chunks inside a barrier need not
    for nb in (1, 2, 3):
        base_recs, base_state = per_barrier(steps(0, 1000, nb))
        for seed, chunk in ((1, 7), (2, 1000), (3, 1)):
            recs, state = per_barrier(steps(seed, chunk, nb))
            assert state == base_state
            assert net_view(recs) == net_view(base_recs)
    ref = run("ref", steps(0, 1000), order_by=[(2, True), (1, False)],
              offset=0, limit=1, group_indices=[0], schema=_gac,
              table_pk=[0, 1], src_pk=(0, 1))
    assert ref[1] == base_recs and ref[2] == base_state
