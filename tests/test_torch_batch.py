"""The batch engine of the PyTorch port (``batch/``), against the JAX
reference, on the CPU (host code: exact equality).

Each case builds the same snapshot in both packages, runs the same plan
through each package's batch executors and compares the rows.

- the twins of ``tests/test_batch.py``'s cases that need no SQL and no
  hummock (:39, :50, :61, :77, :125, :175), each with the reference
  test's own expectation;
- ``rows_to_chunk`` with both DECIMAL domains (scaled int64 and
  ``decimal.Decimal``), NULLs and VARCHAR;
- ``BatchTaskManager.run_agg`` at parallelism 1, 3 and 8 with INT64 and
  VARCHAR group keys (NULL keys included), equal to the single-task
  ``BatchHashAgg`` and to the reference's partitioning;
- DISTINCT, APPROX_COUNT_DISTINCT (an exact set), SUM in Python ints
  (partial sums past 2^63; a result past int64 raises in both), the
  join's output chunks at 4,096 rows and ORDER BY with NULLs;
- Nexmark q5-hot end to end: ``build_q5`` in both packages, then the
  reads the smoke run makes on the card over q5-hot's agg state and MV
  at the committed epoch, in each package over its own tables.
"""

import asyncio
import decimal
from types import SimpleNamespace

import numpy as np
import pytest

import risingwave_tpu.batch as r_batch
import risingwave_tpu.batch.storage_table as r_bst
import risingwave_tpu.batch.task as r_task
import risingwave_tpu.common.epoch as r_epoch
import risingwave_tpu.common.types as r_types
import risingwave_tpu.expr.expr as r_expr
import risingwave_tpu.ops.hash_agg as r_ops_agg
import risingwave_tpu.state.state_table as r_st
import risingwave_tpu.state.store as r_store
import risingwave_tpu.stream.executors.hash_agg as r_agg
import risingwave_tpu_torch.batch as p_batch
import risingwave_tpu_torch.batch.storage_table as p_bst
import risingwave_tpu_torch.batch.task as p_task
import risingwave_tpu_torch.common.epoch as p_epoch
import risingwave_tpu_torch.common.types as p_types
import risingwave_tpu_torch.expr.expr as p_expr
import risingwave_tpu_torch.ops.hash_agg as p_ops_agg
import risingwave_tpu_torch.state.state_table as p_st
import risingwave_tpu_torch.state.store as p_store
import risingwave_tpu_torch.stream.executors.hash_agg as p_agg

PKGS = {
    "ref": SimpleNamespace(batch=r_batch, bst=r_bst, task=r_task,
                           epoch=r_epoch, types=r_types, expr=r_expr,
                           ops_agg=r_ops_agg, st=r_st, store=r_store,
                           agg=r_agg),
    "port": SimpleNamespace(batch=p_batch, bst=p_bst, task=p_task,
                            epoch=p_epoch, types=p_types, expr=p_expr,
                            ops_agg=p_ops_agg, st=p_st, store=p_store,
                            agg=p_agg),
}


def both(fn):
    """fn(m) in each package: equal results; returns the port's."""
    got, want = fn(PKGS["port"]), fn(PKGS["ref"])
    assert got == want
    return got


def schema_of(m, cols):
    T = m.types
    return T.Schema([T.Field(nm, getattr(T.DataType, t)) for nm, t in cols])


def pair(m, n):
    E = m.epoch.Epoch
    prev = E.from_physical(n - 1) if n > 1 else E.INVALID
    return m.epoch.EpochPair(E.from_physical(n), prev)


def seeded_store(m, cols, rows, table_id, dist_key=None, sync=True):
    """rows written through a StateTable at epoch 1 and committed; returns
    (store, snapshot epoch, StateTable)."""
    store = m.store.MemoryStateStore()
    t = m.st.StateTable(table_id, schema_of(m, cols), [0], store,
                        dist_key_indices=dist_key)
    t.init_epoch(pair(m, 1))
    for r in rows:
        t.insert(r)
    t.commit(pair(m, 2))
    epoch = pair(m, 2).prev.value
    store.seal_epoch(epoch, True)
    if sync:
        store.sync(epoch)
    return store, epoch, t


def calls(m, specs):
    A = m.agg.AggCall
    K = m.ops_agg.AggKind
    return [A(K[k], i, distinct=d) for k, i, d in specs]


S = [("k", "INT64"), ("v", "INT64"), ("s", "VARCHAR")]
S_ROWS = [(i, i * 10, None if i % 3 == 0 else f"s{i}") for i in range(10)]


# -- twins of tests/test_batch.py -------------------------------------------------

def test_row_seq_scan_snapshot_matches_reference():
    def run(m):
        store, epoch, _t = seeded_store(m, S, S_ROWS, 9)
        table = m.batch.StorageTable(9, schema_of(m, S), [0], store)
        rows = m.batch.collect(m.batch.RowSeqScan(table, epoch,
                                                  chunk_size=3))
        below = m.batch.collect(m.batch.RowSeqScan(table, 1))
        return rows, below
    rows, below = both(run)
    assert len(rows) == 10
    assert rows[0] == (0, 0, None)
    assert rows[4] == (4, 40, "s4")
    assert below == []            # nothing below the write epoch


def test_filter_project_limit_matches_reference():
    def run(m):
        store, epoch, _t = seeded_store(m, S, S_ROWS, 9)
        E, T = m.expr, m.types.DataType
        scan = m.batch.RowSeqScan(
            m.batch.StorageTable(9, schema_of(m, S), [0], store), epoch)
        f = m.batch.BatchFilter(scan, E.InputRef(1, T.INT64) >= E.lit(50))
        p = m.batch.BatchProject(
            f, [E.InputRef(0, T.INT64), E.InputRef(1, T.INT64) * E.lit(2)],
            names=["k", "v2"])
        return m.batch.collect(m.batch.BatchLimit(p, limit=3, offset=1))
    assert both(run) == [(6, 120), (7, 140), (8, 160)]


def test_hash_agg_and_order_by_matches_reference():
    def run(m):
        rows = [(i % 3, i, None if i == 4 else i * 1.0) for i in range(9)]
        sch = schema_of(m, [("g", "INT64"), ("v", "INT64"),
                            ("f", "FLOAT64")])
        agg = m.batch.BatchHashAgg(
            m.batch.BatchValues(sch, rows), [0],
            calls(m, [("COUNT", None, False), ("SUM", 1, False),
                      ("MAX", 2, False), ("COUNT", 2, False)]))
        return m.batch.collect(m.batch.BatchOrderBy(agg, [(0, False)]))
    assert both(run) == [
        (0, 3, 0 + 3 + 6, 6.0, 3),
        (1, 3, 1 + 4 + 7, 7.0, 2),      # f NULL at i=4: count(f) = 2
        (2, 3, 2 + 5 + 8, 8.0, 3),
    ]


def test_hash_join_inner_matches_reference():
    def run(m):
        ls = schema_of(m, [("a", "INT64"), ("x", "VARCHAR")])
        rs = schema_of(m, [("b", "INT64"), ("y", "INT64")])
        left = m.batch.BatchValues(
            ls, [(1, "l1"), (2, "l2"), (None, "l3"), (3, "l4")])
        right = m.batch.BatchValues(
            rs, [(1, 100), (1, 101), (3, 300), (None, 999)])
        return sorted(m.batch.collect(
            m.batch.BatchHashJoin(left, right, [0], [0])))
    assert both(run) == [(1, "l1", 1, 100), (1, "l1", 1, 101),
                         (3, "l4", 3, 300)]


def _task_agg(m, cols, rows, table_id, group, specs, parallelism,
              sync=True):
    """(single-task BatchHashAgg rows, run_agg rows), both sorted by repr
    (NULL keys sort with the rest)."""
    store, epoch, _t = seeded_store(m, cols, rows, table_id, dist_key=[0],
                                    sync=sync)
    st = m.batch.StorageTable(table_id, schema_of(m, cols), [0], store,
                              dist_key_indices=[0])
    cs = calls(m, specs)
    single = m.batch.collect(m.batch.BatchHashAgg(
        m.batch.RowSeqScan(st, epoch), group, cs))
    got = asyncio.run(m.task.BatchTaskManager(parallelism=parallelism)
                      .run_agg(st, epoch, group, cs))
    return sorted(single, key=repr), sorted(got, key=repr)


def test_batch_task_manager_staged_agg_matches_reference():
    """Parallel vnode-range scans → hash exchange on the group keys → an
    agg per partition → gather equals the single-task plan, at
    parallelism 4 and 1."""
    cols = [("k", "INT64"), ("g", "INT64"), ("v", "INT64")]
    rng = np.random.default_rng(7)
    rows = [(k, int(rng.integers(0, 37)), int(rng.integers(0, 100)))
            for k in range(2000)]
    specs = [("COUNT", None, False), ("SUM", 2, False), ("MAX", 2, False)]

    def run(m):
        return [_task_agg(m, cols, rows, 5, [1], specs, n) for n in (4, 1)]
    for single, got in both(run):
        assert got == single and len(single) == 37


def test_batch_task_manager_varchar_keys_and_global_agg_matches_reference():
    cols = [("k", "INT64"), ("name", "VARCHAR"), ("v", "INT64")]
    rows = [(k, f"n{k % 11}", k) for k in range(500)]

    def run(m):
        single, got = _task_agg(m, cols, rows, 6, [1],
                                [("COUNT", None, False), ("SUM", 2, False)],
                                3, sync=False)
        _s, glob = _task_agg(m, cols, rows, 6, [], [("COUNT", None, False)],
                             4, sync=False)
        return single, got, glob
    single, got, glob = both(run)
    assert got == single and len(single) == 11
    assert glob == [(500,)]        # one row, exact


# -- rows_to_chunk, the aggs, the join and the sort ----------------------------------

def test_rows_to_chunk_decimal_domains_match_reference():
    """A DECIMAL cell as a scaled int64 passes through; as a
    ``decimal.Decimal`` it is scaled: both read back as the same
    Decimal. NULLs and VARCHAR ride along."""
    D = decimal.Decimal
    cols = [("d", "DECIMAL"), ("s", "VARCHAR"), ("i", "INT32")]
    scaled = [(12345, "a", 1), (None, None, None), (-7, "c", -3)]
    logical = [(D("1.2345"), "a", 1), (None, None, None), (D("-0.0007"), "c",
                                                           -3)]
    mixed = [(D("1.2345"), "a", 1), (None, None, None), (-7, "c", -3)]

    def run(m):
        sch = schema_of(m, cols)
        out = []
        for rows in (scaled, logical, mixed):
            ch = m.bst.rows_to_chunk(sch, rows)
            out.append((ch.to_pylist(), ch.capacity,
                        ch.columns[0].values[:3].tolist(),
                        [None if c.validity is None else
                         c.validity.tolist() for c in ch.columns]))
        out.append(m.bst.rows_to_chunk(sch, []).to_pylist())
        return out
    got = both(run)
    assert got[0][0] == got[1][0] == got[2][0] == [
        (D("1.2345"), "a", 1), (None, None, None), (D("-0.0007"), "c", -3)]
    assert got[1][2] == [12345, 0, -7]
    assert got[3] == []


def test_hash_agg_kinds_match_reference():
    """DISTINCT per (group, call), APPROX_COUNT_DISTINCT as an exact set,
    SUM in Python ints (partial sums past 2^63), MIN/MAX over VARCHAR,
    NULL group keys and NULL inputs."""
    big = (1 << 62) + 5
    rows = [(g, v, f"s{v % 4}", big if j < 8 else 1 - big)
            for g in (1, 2, None)
            for j, v in enumerate(list(range(8)) * 2)] + [(3, None, None,
                                                           None)]

    def run(m):
        sch = schema_of(m, [("g", "INT64"), ("v", "INT64"),
                            ("s", "VARCHAR"), ("b", "INT64")])
        agg = m.batch.BatchHashAgg(
            m.batch.BatchValues(sch, rows), [0], calls(m, [
                ("COUNT", 1, True), ("SUM", 1, True), ("SUM", 1, False),
                ("APPROX_COUNT_DISTINCT", 2, False), ("MIN", 2, False),
                ("MAX", 2, False), ("SUM", 3, False), ("COUNT", None, False),
            ]))
        out = m.batch.collect(agg)
        return sorted(out, key=repr), [f.data_type.name for f in agg.schema]
    out, _types = both(run)
    by = {r[0]: r[1:] for r in out}
    assert by[1] == (8, 28, 56, 4, "s0", "s3", 8, 16)
    assert by[None] == by[2] == by[1]
    assert by[3] == (0, None, None, 0, None, None, None, 1)


def test_hash_agg_sum_past_int64_raises_in_both():
    """A SUM whose value leaves int64 does not wrap: writing it to the
    int64 output column raises, in both packages."""
    for m in PKGS.values():
        sch = schema_of(m, [("g", "INT64"), ("b", "INT64")])
        agg = m.batch.BatchHashAgg(
            m.batch.BatchValues(sch, [(1, (1 << 62) + 5)] * 2), [0],
            calls(m, [("SUM", 1, False)]))
        with pytest.raises(OverflowError):
            m.batch.collect(agg)


def test_hash_join_output_chunks_match_reference():
    """A probe whose matches pass 4,096 rows yields chunks of at least
    that many rows as the left side is drained: equal chunking."""
    def run(m):
        ls = schema_of(m, [("a", "INT64")])
        rs = schema_of(m, [("b", "INT64"), ("y", "VARCHAR")])
        left = m.batch.BatchValues(ls, [(i % 50,) for i in range(3000)])
        right = m.batch.BatchValues(rs, [(i % 50, f"y{i}")
                                         for i in range(200)])
        lsrc = _Rechunk(m, left, 500)
        chunks = list(m.batch.BatchHashJoin(lsrc, right, [0], [0])
                      .execute())
        return [c.to_pylist() for c in chunks]
    got = both(run)
    # 2,000 matches a left chunk: a chunk goes out after every third
    assert [len(c) for c in got] == [6000, 6000]


class _Rechunk:
    """A batch executor's rows in chunks of ``size`` rows."""

    def __init__(self, m, child, size):
        self.m, self.child, self.size = m, child, size
        self.schema = child.schema

    def execute(self):
        rows = self.m.batch.collect(self.child)
        for at in range(0, len(rows), self.size):
            yield self.m.bst.rows_to_chunk(self.schema,
                                           rows[at:at + self.size])


@pytest.mark.parametrize("offset", [0, 3, 25])
def test_order_by_nulls_and_limit_offset_match_reference(offset):
    rng = np.random.default_rng(offset)
    rows = [(int(x) if x >= 0 else None, f"s{int(y)}" if y >= 0 else None,
             i) for i, (x, y) in enumerate(zip(rng.integers(-2, 6, 40),
                                               rng.integers(-2, 4, 40)))]

    def run(m):
        sch = schema_of(m, [("a", "INT64"), ("s", "VARCHAR"),
                            ("i", "INT64")])
        out = []
        for order in ([(0, False)], [(0, True), (1, False)],
                      [(1, True), (0, False), (2, True)]):
            src = _Rechunk(m, m.batch.BatchValues(sch, rows), 7)
            out.append(m.batch.collect(m.batch.BatchLimit(
                m.batch.BatchOrderBy(src, order), limit=12, offset=offset)))
        return out
    got = both(run)
    asc = got[0]
    assert len(asc) == 12
    nulls = [r for r in rows if r[0] is None]
    if offset + 12 > len(rows) - len(nulls):
        assert asc[-1][0] is None     # ASC: NULLs last


@pytest.mark.parametrize("parallelism", [1, 3, 8])
@pytest.mark.parametrize("key", ["INT64", "VARCHAR"])
def test_run_agg_equals_single_task_matches_reference(parallelism, key):
    """run_agg equals the single-task agg, with NULL group keys, and each
    partition gets the rows the reference's exchange gives it."""
    rng = np.random.default_rng(parallelism)
    cols = [("k", "INT64"), ("g", key), ("v", "INT64")]
    gs = rng.integers(-1, 60, 3000)
    rows = [(k, None if g < 0 else (int(g) if key == "INT64"
                                    else f"key{int(g)}"),
             int(v)) for k, (g, v) in enumerate(
                 zip(gs, rng.integers(-100, 100, 3000)))]
    specs = [("COUNT", None, False), ("SUM", 2, False), ("MIN", 2, False),
             ("MAX", 2, False), ("COUNT", 2, True)]

    def run(m):
        single, got = _task_agg(m, cols, rows, 7, [1], specs, parallelism)
        ch = m.bst.rows_to_chunk(schema_of(m, cols), rows)
        parts = m.task._hash_partition(ch, [1], parallelism)
        # one partition a vnode: the NULL key's lane shows
        by_vnode = m.task._hash_partition(ch, [1], 256)
        return single, got, parts, by_vnode
    single, got, parts, _by_vnode = both(run)
    assert got == single and len(single) == 61
    assert sum(len(p) for p in parts) == 3000
    if parallelism > 1:
        assert sum(1 for p in parts if p) > 1


# -- q5-hot end to end --------------------------------------------------------------

def q5_batch_reads(m, p, n_bids):
    """The smoke run's reads over q5-hot's committed state, through
    package ``m``'s batch engine: (a) the agg table grouped by window, (b)
    the same through the staged task manager, (c) a top 10 by bid count,
    (d) a point get of every MV row."""
    agg = p.actor.consumer.input.input
    store = agg.table.store
    epoch = store.committed_epoch()
    table = m.batch.StorageTable.of(agg.table)
    mv = m.batch.StorageTable.of(p.mv_table)
    cs = calls(m, [("MAX", 2, False), ("SUM", 2, False),
                   ("COUNT", None, False)])
    a = m.batch.collect(m.batch.BatchHashAgg(
        m.batch.RowSeqScan(table, epoch), [0], cs))
    b = asyncio.run(m.task.BatchTaskManager(parallelism=4).run_agg(
        table, epoch, [0], cs))
    c = m.batch.collect(m.batch.BatchLimit(m.batch.BatchOrderBy(
        m.batch.RowSeqScan(table, epoch), [(2, True), (0, False),
                                           (1, False)]), 10))
    mv_rows = list(mv.iter_rows(epoch))
    d = [mv.get_row(r[:2], epoch) for r in mv_rows]
    scanned = [tuple(r) for r in table.iter_rows(epoch)]
    return dict(a=sorted(a), b=sorted(b), c=c, d=d, mv=mv_rows,
                scanned=scanned, epoch=epoch)


def test_q5_hot_batch_reads_match_reference():
    """build_q5 at 4,000 events 100 ms apart (~200 windows) in both
    packages; each package's batch
    engine reads its own agg state and MV at the committed epoch, and the
    rows are equal, and equal to their oracles."""
    from tests.test_torch_e2e_q5 import UNITS, run_q5
    got = {}
    for pkg in PKGS:
        p, mv, _tables, _cfg, n_bids = run_q5(pkg, "gap")
        got[pkg] = q5_batch_reads(PKGS[pkg], p, n_bids)
        got[pkg]["mv_table"] = mv
    port, ref = got["port"], got["ref"]
    # the epochs are wall-clock times: each run's own, above 0
    assert port.pop("epoch") > 0 and ref.pop("epoch") > 0
    assert port == ref
    a = port["a"]
    mv_count = {r[0]: r[2] for r in port["mv"]}
    assert len(a) == len(mv_count) > 10
    # (a): each window's MAX is its MV count; the SUMs are 5 per bid
    assert {w: mx for w, mx, _s, _n in a} == mv_count
    assert sum(s for _w, _m, s, _n in a) == UNITS * n_bids
    assert sum(n for *_x, n in a) == len(port["scanned"])
    # (b) = (a) as a set
    assert port["b"] == a
    # (c) = a numpy top 10 of the same rows
    sc = np.asarray([r[:3] for r in port["scanned"]], dtype=np.int64)
    top = np.lexsort((sc[:, 1], sc[:, 0], -sc[:, 2]))[:10]
    assert port["c"] == [port["scanned"][i] for i in top]
    # (d) = the MV rows
    assert port["d"] == port["mv"] == port["mv_table"]
