"""The over-window executor and the window functions of the PyTorch port,
against the JAX reference, on the CPU (host code: exact equality).

Every executor case runs the same script, built from one plain
description in each package, through the reference's executor and the
port's: the message streams must be equal message for message, and the
state tables row for row.

- the twins of ``tests/test_over_window.py``'s executor cases (:117,
  :127, :139, :152, :185, :207, :321, :337), each with the reference
  test's own oracle or expectation;
- ``compute_window_outputs`` for all 11 kinds on seeded partitions with
  NULLs and ORDER BY peers, LAG/LEAD over a VARCHAR column, an INT64 SUM
  that wraps past 2^63 and a DECIMAL SUM;
- one barrier's changes fed to the port in a permuted order (as a device
  agg's slot order can deliver a flush), against the reference on the
  unpermuted input: equal net delta per barrier and equal state;
- the partition cache evicted mid-stream through ``memory.GLOBAL.tick()``
  under a soft limit (and by a small LRU): equal outputs, state and
  ``sizes()``;
- recovery from state the reference's executor wrote: its committed
  (key bytes, row) pairs copied into the port's store, then both resume.
"""

import asyncio
import random
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import risingwave_tpu.common.chunk as r_chunk
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.expr.window as r_window
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu.stream.executors.over_window as r_ow
import risingwave_tpu.stream.executors.test_utils as r_tu
import risingwave_tpu.stream.message as r_msg
import risingwave_tpu.utils.memory as r_memory
import risingwave_tpu_torch.common.chunk as p_chunk
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.expr.window as p_window
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store
import risingwave_tpu_torch.stream.executors.over_window as p_ow
import risingwave_tpu_torch.stream.executors.test_utils as p_tu
import risingwave_tpu_torch.stream.message as p_msg
import risingwave_tpu_torch.utils.memory as p_memory

PKGS = {
    "ref": SimpleNamespace(chunk=r_chunk, epoch=r_epoch, types=r_types,
                           window=r_window, st=r_st, store=r_store, ow=r_ow,
                           tu=r_tu, msg=r_msg, memory=r_memory),
    "port": SimpleNamespace(chunk=p_chunk, epoch=p_epoch, types=p_types,
                            window=p_window, st=p_st, store=p_store, ow=p_ow,
                            tu=p_tu, msg=p_msg, memory=p_memory),
}

INSERT, DELETE, U_DEL, U_INS = 1, 2, 3, 4
COLS = ("p", "o", "v", "k")     # partition, order, value, pk

# tests/test_over_window.py:42's calls: (kind, input_idx, offset)
CALLS = [("ROW_NUMBER", None, 1), ("RANK", None, 1), ("DENSE_RANK", None, 1),
         ("SUM", 2, 1), ("MAX", 2, 1), ("LAG", 2, 1), ("LEAD", 2, 2),
         ("COUNT", 2, 1), ("FIRST_VALUE", 2, 1), ("LAST_VALUE", 2, 1)]


# -- scripts, built per package from one plain description ---------------------

def schema(m):
    T = m.types.DataType
    return m.types.Schema.of(p=T.INT64, o=T.INT64, v=T.INT64, k=T.INT64)


def barrier(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.msg.Barrier(m.epoch.EpochPair(E.from_physical(n), prev),
                         m.msg.BarrierKind.CHECKPOINT)


def B(n):
    return ("b", n)


def C(rows, ops=None):
    return ("c", [tuple(r) for r in rows], ops)


def script(m, steps):
    out = []
    for st in steps:
        if st[0] == "b":
            out.append(barrier(m, st[1]))
        else:
            _c, rows, ops = st
            data = {nm: [r[i] for r in rows] for i, nm in enumerate(COLS)}
            out.append(m.chunk.StreamChunk.from_pydict(schema(m), data,
                                                       ops=ops))
    return out


def calls_of(m, calls):
    W = m.window
    return [W.WindowCall(W.WindowFuncKind[k], input_idx=i, offset=o)
            for k, i, o in calls]


def norm(m, msgs):
    out = []
    for x in msgs:
        if m.msg.is_chunk(x):
            out.append(("C", [(int(op), tuple(r)) for op, r in
                              x.to_records()]))
        elif m.msg.is_barrier(x):
            out.append(("B", x.epoch.curr.value))
    return out


def make_exec(m, steps, store, table_id=31, order_by=((1, False),),
              calls=CALLS, source_cls=None):
    st = m.st.StateTable(table_id, schema(m), [0, 1, 3], store,
                         dist_key_indices=[0])
    src = (source_cls or m.tu.MockSource)(schema(m), script(m, steps))
    ex = m.ow.OverWindowExecutor(src, [0], list(order_by),
                                 calls_of(m, calls), st)
    return ex, st


def run_exec(m, steps, n_barriers, store=None, **kw):
    store = store or m.store.MemoryStateStore()
    ex, st = make_exec(m, steps, store, **kw)
    msgs = asyncio.run(m.tu.collect_until_n_barriers(ex, n_barriers))
    return norm(m, msgs), rows_of(st), store


def rows_of(table):
    return [(tuple(pk), tuple(r)) for pk, r in table.iter_rows()]


def both(steps, n_barriers, **kw):
    """The script through both executors: equal streams and equal state
    rows; returns the port's stream."""
    got = {pkg: run_exec(PKGS[pkg], steps, n_barriers, **kw)[:2]
           for pkg in PKGS}
    assert got["port"][0] == got["ref"][0], "message streams differ"
    assert got["port"][1] == got["ref"][1], "state tables differ"
    return got["port"][0]


# -- the reference test's oracle (tests/test_over_window.py:55, :88) ----------

def oracle(rows, desc=False):
    """A full recompute with PostgreSQL's default frame."""
    out = {}
    parts = {}
    for r in rows:
        parts.setdefault(r[0], []).append(r)
    for rs in parts.values():
        rs.sort(key=lambda r: (-r[1] if desc else r[1], r[3]))
        n = len(rs)
        okeys = [r[1] for r in rs]
        for i, r in enumerate(rs):
            j = i
            while j + 1 < n and okeys[j + 1] == okeys[i]:
                j += 1
            peers_end = j + 1
            vals = [x[2] for x in rs[:peers_end] if x[2] is not None]
            rank = next(j for j in range(n) if okeys[j] == okeys[i]) + 1
            dense = len({okeys[j] for j in range(i + 1)})
            out[r[3]] = r + (
                i + 1, rank, dense,
                sum(vals) if vals else None,
                max(vals) if vals else None,
                rs[i - 1][2] if i >= 1 else None,
                rs[i + 2][2] if i + 2 < n else None,
                len(vals), rs[0][2], rs[peers_end - 1][2])
    return out


def materialize(stream):
    """Apply the changelog keyed by the pk; a delete must match the row
    it retracts (so a pk's delete comes before its new insert)."""
    view = {}
    for item in stream:
        if item[0] != "C":
            continue
        for op, row in item[1]:
            if op in (INSERT, U_INS):
                view[row[3]] = row
            else:
                assert view.pop(row[3]) == row
    return view


# -- twins of tests/test_over_window.py -----------------------------------------

def test_over_window_basic_inserts_matches_reference():
    steps = [B(1), C([(1, 10, 100, 1), (1, 20, 200, 2), (2, 5, 7, 3)]), B(2)]
    got = materialize(both(steps, 2))
    assert got == oracle([(1, 10, 100, 1), (1, 20, 200, 2), (2, 5, 7, 3)])


def test_over_window_insert_shifts_row_numbers_matches_reference():
    steps = [B(1), C([(1, 20, 200, 1), (1, 30, 300, 2)]), B(2),
             C([(1, 10, 100, 3)]), B(3)]
    got = materialize(both(steps, 3))
    assert got == oracle([(1, 20, 200, 1), (1, 30, 300, 2),
                          (1, 10, 100, 3)])


def test_over_window_delete_and_peers_matches_reference():
    rows = [(1, 10, 1, 1), (1, 10, 2, 2), (1, 20, 3, 3), (1, 20, None, 4),
            (1, 30, 5, 5)]
    steps = [B(1), C(rows), B(2), C([(1, 10, 1, 1)], ops=[DELETE]), B(3)]
    got = materialize(both(steps, 3))
    assert got == oracle([r for r in rows if r[3] != 1])


def random_steps(seed, n_chunks=6, rows_per_chunk=20, parts=4, orders=15,
                 updates=False):
    """tests/test_over_window.py:152's random stream (inserts, deletes of
    live rows, 10% NULL values); with ``updates``, also U-/U+ pairs that
    may move a row to another partition. Returns (steps, live rows)."""
    rng = np.random.default_rng(seed)
    live = {}
    steps = [B(1)]
    b = 2
    nk = 0
    for _ in range(n_chunks):
        rows, ops = [], []
        for _ in range(rows_per_chunk):
            u = rng.random()
            if live and u < 0.3:
                k = int(rng.choice(list(live)))
                p, o, v = live.pop(k)
                rows.append((p, o, v, k))
                ops.append(DELETE)
            elif updates and live and u < 0.5:
                k = int(rng.choice(list(live)))
                old = live[k]
                new = (int(rng.integers(0, parts)),
                       int(rng.integers(0, orders)), old[2])
                live[k] = new
                rows += [old + (k,), new + (k,)]
                ops += [U_DEL, U_INS]
            else:
                p = int(rng.integers(0, parts))
                o = int(rng.integers(0, orders))
                v = None if rng.random() < 0.1 else int(rng.integers(0, 100))
                live[nk] = (p, o, v)
                rows.append((p, o, v, nk))
                ops.append(INSERT)
                nk += 1
        steps += [C(rows, ops), B(b)]
        b += 1
    return steps, [(p, o, v, k) for k, (p, o, v) in live.items()]


def test_over_window_random_stream_oracle_matches_reference():
    steps, live = random_steps(5)
    got = materialize(both(steps, len(steps) // 2 + 1))
    assert got == oracle(live)


def test_over_window_desc_order_matches_reference():
    steps = [B(1), C([(1, 10, 1, 1), (1, 30, 3, 2), (1, 20, 2, 3)]), B(2)]
    stream = both(steps, 2, table_id=32, order_by=[(1, True)],
                  calls=[("ROW_NUMBER", None, 1), ("SUM", 2, 1)])
    got = {r[3]: (r[4], r[5]) for item in stream if item[0] == "C"
           for op, r in item[1] if op == INSERT}
    # DESC: o=30 first (rn 1, sum 3), o=20 (rn 2, sum 5), o=10 (rn 3, 6)
    assert got == {2: (1, 3), 3: (2, 5), 1: (3, 6)}


def test_over_window_recovery_resumes_matches_reference():
    """A fresh executor over the same state table recomputes the outputs
    and applies further deltas."""
    views = {}
    for pkg, m in PKGS.items():
        store = m.store.MemoryStateStore()
        s1, _t, _s = run_exec(m, [B(1), C([(1, 20, 200, 1), (1, 30, 300, 2)]),
                                  B(2)], 2, store=store)
        s2, t2, _s = run_exec(m, [B(3), C([(1, 10, 100, 3)]), B(4)], 2,
                              store=store)
        views[pkg] = (s1, s2, t2)
    assert views["port"] == views["ref"]
    s1, s2, _t = views["port"]
    assert materialize(s1 + s2) == oracle(
        [(1, 20, 200, 1), (1, 30, 300, 2), (1, 10, 100, 3)])


def test_over_window_partition_move_delete_before_insert_matches_reference():
    steps = [B(1), C([(1, 10, 100, 1), (2, 10, 200, 2)]), B(2),
             C([(1, 10, 100, 1), (2, 10, 100, 1)], ops=[U_DEL, U_INS]), B(3)]
    got = materialize(both(steps, 3))     # asserts D before I
    assert got == oracle([(2, 10, 100, 1), (2, 10, 200, 2)])


@pytest.mark.parametrize("desc,want", [(False, {1: 1, 3: 2, 2: 3}),
                                       (True, {2: 1, 3: 2, 1: 3})])
def test_over_window_null_order_keys_pg_defaults_matches_reference(desc,
                                                                  want):
    """ASC sorts NULLS LAST, DESC NULLS FIRST."""
    steps = [B(1), C([(1, 10, 1, 1), (1, None, 2, 2), (1, 20, 3, 3)]), B(2)]
    stream = both(steps, 2, table_id=33, order_by=[(1, desc)],
                  calls=[("ROW_NUMBER", None, 1)])
    got = {r[3]: r[4] for item in stream if item[0] == "C"
           for op, r in item[1] if op == INSERT}
    assert got == want


# -- compute_window_outputs --------------------------------------------------

def _partitions(seed, values):
    """Seeded partitions of sizes 0-60 in window order: (n, eq_prev,
    (values, nonnull)); order keys over a small range, so peers are many;
    ``values(rng, n)`` makes the column."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (0, 1, 2, 7, 31, 60):
        okeys = np.sort(rng.integers(0, max(n // 3, 1), n))
        eq_prev = np.zeros(n, dtype=bool)
        eq_prev[1:] = okeys[1:] == okeys[:-1]
        vals = values(rng, n)
        ok = rng.random(n) > 0.2
        out.append((n, eq_prev, (vals, ok)))
    return out


def _ints(rng, n):
    return rng.integers(-1000, 1000, n).astype(np.int64)


def _near_max(rng, n):
    # an INT64 SUM past 2^63: the int64 cumsum wraps, as the reference's
    return rng.integers((1 << 62), (1 << 63) - 1, n, dtype=np.int64)


def _decimal(rng, n):
    # DECIMAL is a scaled int64 (4 digits)
    return rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int64)


def _floats(rng, n):
    return rng.normal(size=n).astype(np.float64)


def _strings(rng, n):
    return np.asarray([f"s{int(x)}" for x in rng.integers(0, 50, n)],
                      dtype=object)


WINDOW_CASES = {
    **{k.lower(): (k, _ints, 1) for k in (
        "ROW_NUMBER", "RANK", "DENSE_RANK", "LAG", "LEAD", "SUM", "COUNT",
        "MIN", "MAX", "FIRST_VALUE", "LAST_VALUE")},
    "count_star": ("COUNT", None, 1),
    "lag_3": ("LAG", _ints, 3),
    "lead_40": ("LEAD", _ints, 40),
    "lag_varchar": ("LAG", _strings, 1),
    "lead_varchar": ("LEAD", _strings, 2),
    "first_value_varchar": ("FIRST_VALUE", _strings, 1),
    "sum_int64_wraps": ("SUM", _near_max, 1),
    "sum_decimal": ("SUM", _decimal, 1),
    "sum_float": ("SUM", _floats, 1),
    "min_float": ("MIN", _floats, 1),
    "max_float": ("MAX", _floats, 1),
    "min_near_max": ("MIN", _near_max, 1),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_compute_window_outputs_matches_reference(case):
    kind, values, offset = WINDOW_CASES[case]
    wrapped = False
    for n, eq_prev, inp in _partitions(17, values or _ints):
        got_want = []
        for m in (PKGS["port"], PKGS["ref"]):
            W = m.window
            call = W.WindowCall(W.WindowFuncKind[kind],
                                input_idx=None if values is None else 0,
                                offset=offset)
            got_want.append(W.compute_window_outputs(
                [call], n, eq_prev.copy(),
                [None if values is None else (inp[0].copy(), inp[1].copy())]))
        (gv, gok), = got_want[0]
        (wv, wok), = got_want[1]
        assert gv.dtype == wv.dtype and gok.dtype == wok.dtype
        assert gv.shape == wv.shape == (n,)
        np.testing.assert_array_equal(gok, wok)
        # LAG/LEAD leave the values under a NULL unset (np.empty_like)
        np.testing.assert_array_equal(gv[gok], wv[wok])
        if case == "sum_int64_wraps" and n > 2:
            exact = np.cumsum([int(v) if o else 0
                               for v, o in zip(*inp)], dtype=object)
            wrapped |= any(int(x) != int(e) for x, e in
                           zip(gv[gok], exact[np.flatnonzero(gok)]))
    if case == "sum_int64_wraps":
        assert wrapped


def test_window_call_output_types_match_reference():
    names = ("INT16", "INT32", "INT64", "SERIAL", "DECIMAL", "FLOAT64",
             "VARCHAR", "TIMESTAMP")
    got = {}
    for pkg, m in PKGS.items():
        T, W = m.types, m.window
        sch = T.Schema.of(**{f"c{i}": getattr(T.DataType, t)
                             for i, t in enumerate(names)})
        got[pkg] = [(k.name, i, W.WindowCall(k, input_idx=i).output_type(
            sch).name) for k in W.WindowFuncKind for i in range(len(names))]
        assert [k.name for k in W.RANK_KINDS] == [
            "ROW_NUMBER", "RANK", "DENSE_RANK"]
        assert [k.needs_input for k in W.WindowFuncKind] == \
            [False] * 3 + [True] * 8
    assert got["port"] == got["ref"]


# -- a device agg's flush order -------------------------------------------------

def _agg_flush_steps(seed, permute):
    """Per barrier, one change per pk (an insert, a U-/U+ pair or a
    delete) as an agg's flush gives them; with ``permute`` the changes of
    each barrier come in a shuffled order (a pair stays a pair) and in
    chunks of another size."""
    rng = np.random.default_rng(seed)
    live = {}
    steps = [B(1)]
    shuffle = random.Random(seed + 1)
    nk = 0
    for b in range(2, 9):
        units = []
        for k in list(live):
            u = rng.random()
            if u < 0.15:
                units.append([(live.pop(k) + (k,), DELETE)])
            elif u < 0.55:
                old = live[k]
                new = (old[0], int(rng.integers(0, 12)),
                       None if rng.random() < 0.1 else int(rng.integers(0,
                                                                      90)))
                live[k] = new
                units.append([(old + (k,), U_DEL), (new + (k,), U_INS)])
        for _ in range(int(rng.integers(5, 25))):
            new = (int(rng.integers(0, 6)), int(rng.integers(0, 12)),
                   int(rng.integers(0, 90)))
            live[nk] = new
            units.append([(new + (nk,), INSERT)])
            nk += 1
        if permute:
            shuffle.shuffle(units)
        flat = [rec for u in units for rec in u]
        size = 7 if permute else 16
        at = 0
        while at < len(flat):
            end = min(at + size, len(flat))
            if end < len(flat) and flat[end - 1][1] == U_DEL:
                end += 1            # a pair is never split across chunks
            part = flat[at:end]
            steps.append(C([r for r, _o in part], [o for _r, o in part]))
            at = end
        steps.append(B(b))
    return steps


def _net_by_barrier(stream):
    out, cur = [], Counter()
    for item in stream:
        if item[0] == "B":
            out.append(+cur)
            cur = Counter()
        else:
            for op, row in item[1]:
                cur[row] += 1 if op in (INSERT, U_INS) else -1
    return [Counter({k: v for k, v in c.items() if v}) for c in out]


def test_over_window_permuted_flush_order_matches_reference():
    """The port fed each barrier's changes permuted, the reference fed
    them in order: equal net delta per barrier, equal state tables."""
    ordered = _agg_flush_steps(11, permute=False)
    permuted = _agg_flush_steps(11, permute=True)
    assert ordered != permuted
    n = sum(1 for s in ordered if s[0] == "b")
    got, got_rows, _s = run_exec(PKGS["port"], permuted, n)
    want, want_rows, _s = run_exec(PKGS["ref"], ordered, n)
    assert _net_by_barrier(got) == _net_by_barrier(want)
    assert len(_net_by_barrier(got)) == n
    assert got_rows == want_rows and got_rows


# -- eviction ------------------------------------------------------------------

def ticking_source(m, record):
    """A MockSource class that ticks its package's memory context before
    every message it yields (eviction mid-epoch, with deltas buffered),
    recording the sizes before and the total after."""
    class Src(m.tu.MockSource):
        async def execute(self):
            async for msg in super().execute():
                before = m.memory.GLOBAL.sizes()
                record.append((before, m.memory.GLOBAL.tick()))
                yield msg
    return Src


@pytest.mark.parametrize("how", ["tick", "lru"])
def test_over_window_eviction_matches_reference(how, monkeypatch):
    """The partition cache evicted mid-stream: by ``memory.GLOBAL.tick()``
    under a soft limit, or by a 4-partition LRU. Outputs, state tables and
    the memory context's ``sizes()`` equal the reference's."""
    steps, live = random_steps(23, n_chunks=8, rows_per_chunk=60, parts=40,
                               orders=10, updates=True)
    n = len(steps) // 2 + 1
    got = {}
    for pkg, m in PKGS.items():
        limit = 4000 if how == "tick" else None
        monkeypatch.setattr(m.memory, "GLOBAL",
                            m.memory.MemoryContext(limit))
        if how == "lru":
            monkeypatch.setattr(m.ow, "PARTITION_CACHE_CAP", 4)
        record = []
        loads = Counter()
        load = m.ow.OverWindowExecutor._load

        def counted(self, pkey, load=load, loads=loads):
            loads[pkey in self._cache] += 1
            return load(self, pkey)
        monkeypatch.setattr(m.ow.OverWindowExecutor, "_load", counted)
        stream, rows, _s = run_exec(m, steps, n, table_id=34,
                                    source_cls=ticking_source(m, record))
        names = [[k.split("#")[0] for k in before] for before, _a in record]
        got[pkg] = (stream, rows, [sorted(b.values()) for b, _a in record],
                    [a for _b, a in record], names, dict(loads))
    assert got["port"] == got["ref"]
    stream, _rows, sizes, _after, names, loads = got["port"]
    assert materialize(stream) == oracle(live)
    assert all(nm == ["OverWindowExecutor(actor=0)"] for nm in names[1:])
    # partitions were dropped and reloaded from the state table
    assert loads[False] > 40
    if how == "tick":
        assert any(s[0] > 4000 for s in sizes)


# -- recovery from the reference's state -------------------------------------

def test_over_window_recovers_from_reference_written_state():
    """The reference's executor writes the state; its committed (key
    bytes, row) pairs go into the port's store through ``ingest_batch``
    (the port's key codec gives the same bytes), and the port's executor
    resumes from them: its output equals the reference's resumed run."""
    steps, _live = random_steps(31, n_chunks=5, rows_per_chunk=30, parts=5,
                                updates=True)
    n1 = len(steps) // 2 + 1
    rm, pm = PKGS["ref"], PKGS["port"]
    rstore = rm.store.MemoryStateStore()
    s1, rows1, _s = run_exec(rm, steps, n1, store=rstore, table_id=35)
    epoch = pm.epoch.Epoch.from_physical(n1).value
    pairs = list(rstore.iter(35, epoch))
    assert len(pairs) == len(rows1) > 20
    pstore = pm.store.MemoryStateStore()
    pst = pm.st.StateTable(35, schema(pm), [0, 1, 3], pstore,
                           dist_key_indices=[0])
    for key, row in pairs:
        assert pst._encode_pk(pst.pk_of(row)) == key
    pstore.ingest_batch(35, pairs, epoch)

    tail = [B(n1 + 1), C([(1, 3, 7, 1000), (2, 9, None, 1001)]),
            C([rows1[0][1], rows1[-1][1]], ops=[DELETE, DELETE]),
            B(n1 + 2), C([(1, 1, 5, 1002)]), B(n1 + 3)]
    want, want_rows, _s = run_exec(rm, tail, 3, store=rstore, table_id=35)
    got, got_rows, _s = run_exec(pm, tail, 3, store=pstore, table_id=35)
    assert got == want and got_rows == want_rows
    assert sum(len(x[1]) for x in got if x[0] == "C") > 3
