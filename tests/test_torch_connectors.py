"""The port's connectors against the reference's: parsers, filelog,
datagen and the DML channel.

- Twins of every case of ``tests/test_parser_batch.py`` (its four fuzz
  seeds included): each payload list goes through both packages' JSON or
  CSV parser, on the batch path and the row path, and the four chunks'
  records and error counts must agree.
- Twins of ``tests/test_filelog_source.py`` :37 (JSON types and errors),
  :53 (CSV), :60 (the enumerator and a tailing reader: a torn trailing
  write waits, a seek re-reads exactly) and :148 (a record straddling
  the read block carries over), plus the multi-partition reader and a
  filelog source in SQL whose producer appends between barriers (the
  source parks, then picks the new records up). Its recovery case (:90)
  needs hummock, ``ROADMAP.md`` item 11.
- The datagen reader's chunks bit for bit equal to the reference's for
  three option sets, ``DmlReader`` and ``RowIdSeq``.
- ``segmented='true'`` (the filelog sink's reader, item 13) raises
  ``NotImplementedError`` naming it.
"""

import io
import json
import os

import numpy as np
import pytest

from risingwave_tpu.common import types as r_types
from risingwave_tpu.connectors import datagen as r_datagen
from risingwave_tpu.connectors import dml as r_dml
from risingwave_tpu.connectors import filelog as r_filelog
from risingwave_tpu.connectors import parser as r_parser
from risingwave_tpu_torch.common import types as p_types
from risingwave_tpu_torch.connectors import datagen as p_datagen
from risingwave_tpu_torch.connectors import dml as p_dml
from risingwave_tpu_torch.connectors import filelog as p_filelog
from risingwave_tpu_torch.connectors import parser as p_parser
from tests.test_parser_batch import _rec
from tests.test_torch_frontend import (  # noqa: F401 — fixture
    _port_strict_checker, frontend, norm, norm_rows,
)

PKGS = {"ref": (r_types, r_parser, r_filelog),
        "port": (p_types, p_parser, p_filelog)}

ALL_TYPES = dict(
    i16="INT16", i32="INT32", i64="INT64", f32="FLOAT32", f64="FLOAT64",
    b="BOOLEAN", d="DECIMAL", ts="TIMESTAMP", dt="DATE", s="VARCHAR",
    by="BYTEA")


def schema(pkg, **cols):
    types = PKGS[pkg][0]
    return types.Schema.of(**{n: types.DataType[t]
                              for n, t in cols.items()})


def records(chunk):
    """A chunk's (op, row) records as plain Python (None: no chunk)."""
    if chunk is None:
        return None
    return [(int(op), norm(tuple(r))) for op, r in chunk.to_records()]


def parse_all(kind, cols, payloads):
    """Both packages x both paths through one parser kind: every arm's
    records and error count must agree. Returns them."""
    seen = []
    for pkg in PKGS:
        cls = getattr(PKGS[pkg][1], kind)
        for batch in (True, False):
            p = cls(schema(pkg, **cols), batch=batch)
            seen.append((records(p.build_chunk(list(payloads))),
                         p.errors))
    assert all(s == seen[0] for s in seen), seen
    return seen[0]


# -- tests/test_parser_batch.py twins -------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzzed_batch_vs_row_oracle_all_types_twin(seed):
    rng = np.random.default_rng(seed)
    payloads = [_rec(rng, i, malform=rng.random() < 0.07)
                for i in range(300)]
    recs, errors = parse_all("JsonRowParser", ALL_TYPES, payloads)
    assert recs and errors > 0


def test_bom_and_non_utf8_payloads_twin():
    recs, errors = parse_all("JsonRowParser", dict(a="INT64", s="VARCHAR"), [
        b'{"a": 1, "s": "x"}',
        "﻿".encode("utf-8") + b'{"a": 2, "s": "bom"}',
        '{"a": 3, "s": "wide"}'.encode("utf-16"),
        b'\xff\xfe garbage that is not any json',
        b'{"a": 4, "s": "tail"}'])
    rows = [r for _op, r in recs]
    for want in [(1, "x"), (2, "bom"), (3, "wide"), (4, "tail")]:
        assert want in rows
    assert errors == 1


def test_op_envelope_maps_to_deletes_in_both_arms_twin():
    recs, _e = parse_all("JsonRowParser", dict(k="INT64"), [
        b'{"k": 1}', b'{"k": 2, "__op": "D"}', b'{"k": 3, "__op": "I"}'])
    assert [op for op, _r in recs] == [1, 2, 1]


def test_coercion_failure_isolates_single_record_twin():
    recs, errors = parse_all("JsonRowParser", dict(a="INT64", s="VARCHAR"), [
        b'{"a": 1, "s": "x"}', b'{"a": "3.5", "s": "bad-int"}',
        b'{"a": "7", "s": "str-int-ok"}', b'{"a": 2, "s": "y"}'])
    assert [r for _op, r in recs] == [(1, "x"), (7, "str-int-ok"),
                                      (2, "y")]
    assert errors == 1


def test_decimal_parses_single_scaled_twin():
    import decimal
    recs, _e = parse_all("JsonRowParser", dict(d="DECIMAL"),
                         [b'{"d": 1.5}', b'{"d": "-2"}'])
    assert [r for _op, r in recs] == [(decimal.Decimal("1.5"),),
                                      (decimal.Decimal("-2"),)]


def test_all_malformed_batch_returns_none_twin():
    assert parse_all("JsonRowParser", dict(a="INT64"),
                     [b"nope", b"{broken"]) == (None, 2)


def test_csv_batch_vs_row_oracle_twin():
    recs, errors = parse_all(
        "CsvRowParser", dict(a="INT64", f="FLOAT64", s="VARCHAR"),
        [b"1,1.5,x", b"2,,", b"junk", b"3,2.5,y,extra", b"bad-int,1.0,z"])
    assert [r for _op, r in recs] == [(1, 1.5, "x"), (2, None, None),
                                      (3, 2.5, "y")]
    assert errors == 2


def test_csv_prebound_coercers_row_path_twin():
    for pkg in PKGS:
        p = PKGS[pkg][1].CsvRowParser(schema(
            pkg, a="INT64", t="TIMESTAMP", s="VARCHAR"))
        assert p.parse_one(b"5,2026-01-02T00:00:00,hello") == \
            (5, 1767312000000000, "hello")
        assert len(p._fields) == 3


def test_make_parser_batch_option_twin():
    for pkg in PKGS:
        mk, s = PKGS[pkg][1].make_parser, schema(pkg, a="INT64")
        assert mk("json", s).batch is True
        assert mk("json", s, {"parse.batch": "false"}).batch is False
        assert mk("csv", s, {"parse.batch": "off"}).batch is False


def test_comma_concatenated_payload_is_isolated_not_exploded_twin():
    recs, errors = parse_all("JsonRowParser", dict(a="INT64"), [
        b'{"a": 1}', b'{"a": 2},{"a": 3}', b'{"a": 4}'])
    assert [r for _op, r in recs] == [(1,), (4,)] and errors == 1


# -- tests/test_filelog_source.py twins -----------------------------------

S = dict(k="INT64", name="VARCHAR", price="FLOAT64", ts="TIMESTAMP")


def _produce(path, topic, part, recs):
    os.makedirs(path, exist_ok=True)
    with open(p_filelog.partition_path(path, topic, part), "ab") as f:
        for r in recs:
            f.write(json.dumps(r).encode() + b"\n")


def test_json_parser_types_and_errors_twin():
    """:37"""
    got = []
    for pkg in PKGS:
        p = PKGS[pkg][1].JsonRowParser(schema(pkg, **S))
        rows = p.parse_batch([
            b'{"k": 1, "name": "a", "price": 1.5, '
            b'"ts": "2026-01-02T03:04:05"}',
            b'{"k": 2, "name": null, "price": null}',
            b'not json',
            b'{"k": "3", "name": 7, "price": "2.5", "ts": 1700000000}'])
        got.append((rows, p.errors))
    assert got[0] == got[1]
    rows, errors = got[1]
    assert errors == 1 and rows[0][3] == 1767323045000000
    assert rows[1] == (2, None, None, None)
    assert rows[2] == (3, "7", 2.5, 1700000000000000)


def test_csv_parser_twin():
    """:53"""
    for pkg in PKGS:
        p = PKGS[pkg][1].CsvRowParser(schema(pkg, a="INT64", b="VARCHAR"))
        assert p.parse_batch([b"1,x", b"2,", b"junk"]) == \
            [(1, "x"), (2, None)]
        assert p.errors == 1


def _tail(pkg, path):
    """:60's script through one package: the chunks read, with a torn
    trailing write completed in between, and a fresh reader's read at
    the first one's offset."""
    fl = PKGS[pkg][2]
    out = [[s.split_id for s in fl.FileLogEnumerator(path, "t")
            .list_splits()]]
    r = fl.FileLogSplitReader(path, "t", 0, schema(pkg, **S),
                              max_chunk_size=3)
    out += [records(r.next_chunk()) for _ in range(3)]
    with open(fl.partition_path(path, "t", 0), "ab") as f:
        f.write(b'{"k": 7')
    out.append(records(r.next_chunk()))
    with open(fl.partition_path(path, "t", 0), "ab") as f:
        f.write(b', "name": "late"}\n')
    out.append(records(r.next_chunk()))
    r2 = fl.FileLogSplitReader(path, "t", 0, schema(pkg, **S))
    r2.seek(r.offset)
    out += [records(r2.next_chunk()), r.offset]
    return out


def test_enumerator_and_reader_tailing_twin(tmp_path):
    """:60"""
    got = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg)
        _produce(path, "t", 0, [{"k": i, "name": f"n{i}",
                                 "price": i * 1.0, "ts": 1000 + i}
                                for i in range(5)])
        _produce(path, "t", 1, [{"k": 100}])
        got[pkg] = _tail(pkg, path)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out[0] == ["filelog-t-0", "filelog-t-1"]
    assert [len(c) for c in out[1:3]] == [3, 2] and out[3] is None
    assert out[4] is None                  # torn write unconsumed
    assert out[5][0][1][:2] == (7, "late")
    assert out[6] is None


def test_block_read_carries_partial_line_across_blocks_twin(monkeypatch):
    """:148"""
    blob = b"aaa\nbbbbbb\nccc\n"
    for fl in (r_filelog, p_filelog):
        monkeypatch.setattr(fl, "_READ_BLOCK", 8)
        payloads = []
        consumed = fl._read_complete_records(io.BytesIO(blob), payloads,
                                             100)
        assert payloads == [b"aaa", b"bbbbbb", b"ccc"]
        assert consumed == len(blob)


def test_multi_partition_reader_matches_reference(tmp_path):
    """FileLogMultiReader over two partitions: the same chunks and the
    same per-split offsets; a seek by split resumes exactly."""
    path = str(tmp_path)
    for part in (0, 1, 2):
        _produce(path, "m", part, [{"k": part * 100 + i, "name": "x"}
                                   for i in range(7)])
    got = {}
    for pkg in PKGS:
        fl = PKGS[pkg][2]
        r = fl.FileLogMultiReader(path, "m", [0, 2], schema(pkg, **S),
                                  max_chunk_size=4)
        chunks = [records(r.next_chunk()) for _ in range(6)]
        splits = sorted(r.splits())
        r2 = fl.FileLogMultiReader(path, "m", [0, 2], schema(pkg, **S))
        for sid, off in splits:
            r2.seek_split(sid, off)
        got[pkg] = (chunks, splits, records(r2.next_chunk()))
    assert got["port"] == got["ref"]
    rows = [rec[1][0] for c in got["port"][0] if c for rec in c]
    assert sorted(rows) == [i for i in range(7)] + [200 + i
                                                    for i in range(7)]


def test_sql_filelog_source_tails_between_barriers_twin(tmp_path):
    """A filelog source in SQL (a column list, JSON, 16-record chunks):
    the producer appends while the session runs; the parked source reads
    the new records at a later epoch. Each package reads its own copy of
    the topic; the rows equal the reference's before and after the
    append, and the fold of everything produced."""
    import asyncio

    def trades(lo, hi):
        return [{"k": i, "name": f"sym{i % 3}", "price": float(i),
                 "ts": i} for i in range(lo, hi)]

    async def run(pkg, path):
        fe = frontend(pkg, rate_limit=2, min_chunks=2)
        await fe.execute(
            f"CREATE SOURCE trades (k BIGINT, name VARCHAR, "
            f"price DOUBLE PRECISION, ts TIMESTAMP) "
            f"WITH (connector='filelog', path='{path}', "
            f"topic='trades', format='json', max.chunk.size=16)")
        await fe.execute(
            "CREATE MATERIALIZED VIEW v AS SELECT name, count(*) AS c, "
            "sum(k) AS s FROM trades GROUP BY name")
        await fe.step(4)
        first = norm_rows(await fe.execute("SELECT * FROM v"))
        _produce(path, "trades", 0, trades(40, 60))
        await fe.step(8)
        rows = norm_rows(await fe.execute("SELECT * FROM v"))
        await fe.close()
        return sorted(first), sorted(rows)

    got = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg)
        _produce(path, "trades", 0, trades(0, 40))
        got[pkg] = asyncio.run(run(pkg, path))
    assert got["port"] == got["ref"]
    want = {}
    for i in range(60):
        c, s = want.get(f"sym{i % 3}", (0, 0))
        want[f"sym{i % 3}"] = (c + 1, s + i)
    first, final = got["port"]
    assert 0 < sum(c for _n, c, _s in first) < 60
    assert {n: (c, s) for n, c, s in final} == want


def test_filelog_planner_refusals(tmp_path):
    """A filelog source needs a column list (the reference's PlanError),
    and the segmented reader is item 13."""
    from risingwave_tpu_torch.frontend.planner import (
        PlanError, _source_reader, source_schema,
    )
    from risingwave_tpu_torch.frontend.catalog import SourceCatalog
    opts = {"connector": "filelog", "path": str(tmp_path)}
    with pytest.raises(PlanError, match="explicit column list"):
        source_schema(opts)
    sch = source_schema(opts, [("k", "BIGINT")])
    with pytest.raises(NotImplementedError, match="item 13"):
        _source_reader(SourceCatalog("t", 1, sch,
                                     {**opts, "segmented": "true"}))


# -- datagen and DML ------------------------------------------------------

DATAGEN_OPTIONS = {
    "sequence_and_random": {
        "fields.id.type": "bigint", "fields.id.kind": "sequence",
        "fields.id.start": "0", "fields.id.end": "1000000",
        "fields.v.type": "double", "fields.v.kind": "random",
        "fields.v.min": "0", "fields.v.max": "10",
        "datagen.rows.per.chunk": "500", "datagen.event.num": "2000"},
    "wrapping_sequence_strings_timestamps": {
        "fields.a.type": "int", "fields.a.start": "5",
        "fields.a.end": "17",
        "fields.s.type": "varchar", "fields.s.kind": "random",
        "fields.s.length": "6", "fields.s.seed": "3",
        "fields.t.type": "timestamp", "fields.t.kind": "random",
        "fields.t.min": "0", "fields.t.max": "1000000",
        "datagen.rows.per.chunk": "333", "datagen.event.num": "1000"},
    "booleans_and_reals_seeded": {
        "fields.f.type": "real", "fields.f.kind": "random",
        "fields.f.min": "-1", "fields.f.max": "1", "fields.f.seed": "9",
        "fields.b.type": "boolean", "fields.b.kind": "random",
        "fields.n.type": "smallint", "fields.n.kind": "random",
        "fields.n.min": "-50", "fields.n.max": "50",
        "datagen.rows.per.chunk": "1024", "datagen.event.num": "3000"},
}


@pytest.mark.parametrize("name", sorted(DATAGEN_OPTIONS))
def test_datagen_chunks_bit_for_bit(name):
    """The same options give the same schema and the same chunks, column
    arrays and masks compared bit for bit; a seek replays exactly."""
    opts = {"connector": "datagen", **DATAGEN_OPTIONS[name]}
    readers = []
    for mod in (r_datagen, p_datagen):
        cfg = mod.DatagenConfig.from_options(opts)
        readers.append(mod.DatagenSplitReader(cfg))
    ref, port = readers
    assert [(f.name, f.data_type.name) for f in port.schema] == \
        [(f.name, f.data_type.name) for f in ref.schema]
    n = 0
    while True:
        a, b = ref.next_chunk(), port.next_chunk()
        assert (a is None) == (b is None)
        if a is None:
            break
        for x, y in zip(a.columns, b.columns):
            assert x.values.dtype == y.values.dtype
            assert x.values.tolist() == y.values.tolist() \
                if x.values.dtype == object \
                else x.values.tobytes() == y.values.tobytes()
            assert (x.validity is None) == (y.validity is None)
            if x.validity is not None:
                assert x.validity.tobytes() == y.validity.tobytes()
        assert np.asarray(a.visibility).tobytes() == \
            np.asarray(b.visibility).tobytes()
        assert np.asarray(a.ops).tobytes() == np.asarray(b.ops).tobytes()
        n += a.cardinality()
    assert n == int(opts["datagen.event.num"])
    assert port.offset == ref.offset
    port.seek(0)
    ref.seek(0)
    assert records(port.next_chunk()) == records(ref.next_chunk())


def test_dml_reader_and_row_id_seq_match_reference():
    """DmlReader hands pushed chunks out in order and reports idle
    (unbounded) when empty; RowIdSeq rebases on the committed epoch."""
    for pkg, mod in (("ref", r_dml), ("port", p_dml)):
        sch = schema(pkg, a="INT64")
        r = mod.DmlReader(sch)
        assert r.unbounded and r.split_id == "dml"
        assert r.next_chunk() is None
        chunk_mod = __import__(
            {"ref": "risingwave_tpu", "port": "risingwave_tpu_torch"}[pkg]
            + ".common.chunk", fromlist=["StreamChunk"])
        for v in ([1, 2], [3]):
            r.push(chunk_mod.StreamChunk.from_pydict(sch, {"a": v}))
        got = [records(r.next_chunk()), records(r.next_chunk()),
               r.next_chunk(), r.offset]
        assert got == [[(1, (1,)), (1, (2,))], [(1, (3,))], None, 2]
    seqs = [r_dml.RowIdSeq(), p_dml.RowIdSeq()]
    for epoch, n in [(0, 3), (5 << 16, 2), (5 << 16, 4), (1, 1),
                     (9 << 16, 0), (9 << 16, 2)]:
        a, b = (list(s.take(epoch, n)) for s in seqs)
        assert a == b
