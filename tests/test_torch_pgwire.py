"""The port's pgwire server against the reference's, byte for byte.

Each case drives the reference's ``PgServer`` over its ``Frontend`` and
the port's over ``Frontend(device="cpu")`` through the same client
script on a loopback socket (``port=0``), and holds every message the
two servers send equal, byte for byte; DataRows are sorted within a
reply where its SELECT has no ORDER BY (the row order of a batch scan is
not the protocol's). Sessions pin ``min_chunks`` to ``rate_limit``, so
what the MVs hold at each read does not depend on the event loop.

Twins of ``tests/test_pgwire.py:73`` (startup, simple queries, an
ErrorResponse, NULL and bool text), :104 (the extended protocol with a
``$1`` parameter, an error skipped to Sync), :164 (token-aware ``$n``
substitution), :178 (cleartext password auth) and :233 (parameterized
INSERT through Parse/Bind/Execute), plus the text format of every type
the batch engine returns. :271 (pgwire over the cluster session) is
``ROADMAP.md`` item 13.
"""

import asyncio
import datetime
import decimal
import struct

import pytest

from risingwave_tpu.common.types import DataType as RD
from risingwave_tpu.common.types import Interval as RInterval
from risingwave_tpu.frontend import pgwire as r_pgwire
from risingwave_tpu_torch.common.types import DataType as PD
from risingwave_tpu_torch.common.types import Interval as PInterval
from risingwave_tpu_torch.frontend import pgwire as p_pgwire
from tests.test_pgwire import _Client, _rows
from tests.test_torch_frontend import frontend, nexmark_source


def _ext(c, tag, body):
    c.w.write(tag + struct.pack(">I", len(body) + 4) + body)


def wire(pkg):
    return p_pgwire if pkg == "port" else r_pgwire


def _sorted_rows(msgs):
    """A reply with its DataRows in one canonical order, in place."""
    at = [i for i, (t, _p) in enumerate(msgs) if t == b"D"]
    rows = sorted(msgs[i] for i in at)
    out = list(msgs)
    for i, m in zip(at, rows):
        out[i] = m
    return out


def run_both(scenario, **kw):
    """Run ``scenario(pkg, record, **kw)`` against each package's server
    (``record(msgs, ordered=False)`` keeps one reply) and hold every
    reply equal. Returns the port's replies."""
    def one(pkg):
        replies = []

        def record(msgs, ordered=False):
            replies.append(msgs if ordered else _sorted_rows(msgs))
            return msgs
        asyncio.run(scenario(pkg, record, **kw))
        return replies
    ref, port = one("ref"), one("port")
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"reply {i}"
    return port


async def _serve(pkg, fe, **kw):
    srv = wire(pkg).PgServer(fe, **kw)
    await srv.serve(port=0)
    return srv


def test_pgwire_end_to_end_twin():
    """:73 — CREATE SOURCE / MV over the wire, a count, a parse error
    answered with ErrorResponse then ReadyForQuery, NULL and bool."""
    async def scenario(pkg, record):
        fe = frontend(pkg, rate_limit=4, min_chunks=4)
        srv = await _serve(pkg, fe)
        try:
            c = await _Client.connect(srv.port)
            for sql in (nexmark_source("bid", 5000),
                        "CREATE MATERIALIZED VIEW m AS SELECT auction, "
                        "price FROM bid WHERE price > 1000"):
                record(await c.query(sql))
            await fe.step(4)
            msgs = record(await c.query("SELECT COUNT(*) AS n FROM m"))
            assert int(_rows(msgs)[0][0]) > 0
            msgs = record(await c.query("SELEKT 1"))
            assert msgs[0][0] == b"E" and msgs[-1][0] == b"Z"
            msgs = record(await c.query("SELECT true AS t, null AS x"))
            assert _rows(msgs) == [("t", None)]
            c.close()
        finally:
            await srv.close()
            await fe.close()

    run_both(scenario)


def test_pgwire_extended_protocol_twin():
    """:104 — Parse (a named statement with $1), Bind, Describe, Execute,
    Sync; an error inside the extended mode skips to Sync, and a simple
    query works after it."""
    async def scenario(pkg, record):
        fe = frontend(pkg, rate_limit=2, min_chunks=2)
        await fe.execute(nexmark_source("bid", 2000, chunk=256))
        await fe.execute("CREATE MATERIALIZED VIEW m AS SELECT auction, "
                         "price FROM bid")
        await fe.step(6)
        srv = await _serve(pkg, fe)
        try:
            c = await _Client.connect(srv.port)
            sql = ("SELECT auction, count(*) AS n FROM m "
                   "WHERE auction = CAST($1 AS BIGINT) GROUP BY auction")
            _ext(c, b"P", b"s1\x00" + sql.encode() + b"\x00"
                 + struct.pack(">H", 0))
            param = b"1000"
            _ext(c, b"B", b"\x00s1\x00" + struct.pack(">H", 0)
                 + struct.pack(">H", 1) + struct.pack(">i", len(param))
                 + param + struct.pack(">H", 0))
            _ext(c, b"D", b"P\x00")
            _ext(c, b"E", b"\x00" + struct.pack(">I", 0))
            _ext(c, b"S", b"")
            await c.w.drain()
            msgs = record(await c.read_until(b"Z"))
            tags = [t for t, _ in msgs]
            assert b"1" in tags and b"2" in tags and b"T" in tags
            assert len([t for t in tags if t == b"D"]) == 1
            _ext(c, b"P", b"bad\x00SELECT nope FROM m\x00"
                 + struct.pack(">H", 0))
            _ext(c, b"B", b"\x00bad\x00" + struct.pack(">HHH", 0, 0, 0))
            _ext(c, b"E", b"\x00" + struct.pack(">I", 0))
            _ext(c, b"S", b"")
            await c.w.drain()
            msgs = record(await c.read_until(b"Z"))
            assert any(t == b"E" for t, _ in msgs)
            msgs = record(await c.query("SELECT count(*) AS n FROM m"))
            assert int(_rows(msgs)[0][0]) > 0
            # a parameterless SELECT described as a statement runs once
            # (Describe caches its rows for the Bind), paged by Execute
            _ext(c, b"P", b"s2\x00SELECT auction, price FROM m "
                 b"ORDER BY price DESC, auction LIMIT 5\x00"
                 + struct.pack(">H", 0))
            _ext(c, b"D", b"Ss2\x00")
            _ext(c, b"B", b"p2\x00s2\x00" + struct.pack(">HHH", 0, 0, 0))
            _ext(c, b"E", b"p2\x00" + struct.pack(">I", 2))
            _ext(c, b"E", b"p2\x00" + struct.pack(">I", 0))
            _ext(c, b"C", b"Ss2\x00")
            _ext(c, b"S", b"")
            await c.w.drain()
            msgs = record(await c.read_until(b"Z"), ordered=True)
            tags = [t for t, _ in msgs]
            assert tags.count(b"D") == 5 and b"s" in tags and b"3" in tags
            c.close()
        finally:
            await srv.close()
            await fe.close()

    run_both(scenario)


def test_pgwire_param_substitution_is_token_aware_twin():
    """:164 — $n inside a string literal is untouched, a value holding
    $1 is never re-scanned, NULL and quotes are escaped."""
    cases = [("SELECT 'price $1', $1", ["x"]), ("SELECT $1, $2", ["a", "$1"]),
             ("SELECT $1", [None]), ("SELECT $1", ["O'Brien"])]
    for sql, params in cases:
        assert p_pgwire.PgServer._sub_params_sql(sql, params) == \
            r_pgwire.PgServer._sub_params_sql(sql, params)
    assert p_pgwire.PgServer._sub_params_sql(*cases[0]) == \
        "SELECT 'price $1', 'x'"
    for sql in ("SELECT $2 + '$9'", "SELECT 1", "SELECT $10, '$11'"):
        assert p_pgwire.PgServer._param_count(sql) == \
            r_pgwire.PgServer._param_count(sql)
    with pytest.raises(ValueError, match=r"\$3 not bound"):
        p_pgwire.PgServer._sub_params_sql("SELECT $3", ["a"])


def test_pgwire_cleartext_password_auth_twin():
    """:178 — a wrong password gets ErrorResponse and no ReadyForQuery;
    the right one reaches ReadyForQuery."""
    async def scenario(pkg, record):
        fe = frontend(pkg)
        srv = await _serve(pkg, fe, password="sekrit")
        try:
            for pw in ("wrong", "sekrit"):
                r, w = await asyncio.open_connection("127.0.0.1", srv.port)
                payload = b"user\x00u\x00\x00"
                w.write(struct.pack(">II", 8 + len(payload), 196608)
                        + payload)
                await w.drain()
                msgs = []
                hdr = await r.readexactly(5)
                ln = struct.unpack(">I", hdr[1:5])[0]
                msgs.append((hdr[0:1], await r.readexactly(ln - 4)))
                pwb = pw.encode() + b"\x00"
                w.write(b"p" + struct.pack(">I", len(pwb) + 4) + pwb)
                await w.drain()
                try:
                    while True:
                        hdr = await r.readexactly(5)
                        ln = struct.unpack(">I", hdr[1:5])[0]
                        msgs.append((hdr[0:1],
                                     await r.readexactly(ln - 4)))
                        if hdr[0:1] in (b"Z", b"E"):
                            break
                except asyncio.IncompleteReadError:
                    pass
                w.close()
                record(msgs)
        finally:
            await srv.close()
            await fe.close()

    bad, good = run_both(scenario)
    assert bad[0] == (b"R", struct.pack(">I", 3))
    assert any(t == b"E" for t, _ in bad)
    assert not any(t == b"Z" for t, _ in bad)
    assert good[-1][0] == b"Z"


def test_pgwire_extended_protocol_dml_twin():
    """:233 — a parameterized INSERT bound twice through one Sync, then
    the table read back."""
    async def scenario(pkg, record):
        fe = frontend(pkg)
        await fe.execute("CREATE TABLE t (a bigint, b varchar)")
        srv = await _serve(pkg, fe)
        try:
            c = await _Client.connect(srv.port)
            sql = "INSERT INTO t VALUES (CAST($1 AS BIGINT), $2)"
            _ext(c, b"P", b"ins\x00" + sql.encode() + b"\x00"
                 + struct.pack(">H", 0))
            for a, b in ((b"1", b"x"), (b"2", b"y")):
                _ext(c, b"B", b"\x00ins\x00" + struct.pack(">H", 0)
                     + struct.pack(">H", 2)
                     + struct.pack(">i", len(a)) + a
                     + struct.pack(">i", len(b)) + b
                     + struct.pack(">H", 0))
                _ext(c, b"E", b"\x00" + struct.pack(">I", 0))
            _ext(c, b"S", b"")
            await c.w.drain()
            msgs = record(await c.read_until(b"Z"))
            done = [p for t, p in msgs if t == b"C"]
            assert len(done) == 2 and all(b"INSERT 0 1" in p
                                          for p in done)
            msgs = record(await c.query("SELECT a, b FROM t"))
            assert sorted(_rows(msgs)) == [("1", "x"), ("2", "y")]
            c.close()
        finally:
            await srv.close()
            await fe.close()

    run_both(scenario)


# -- the text format of each type the batch engine returns ---------------------


def test_pgwire_text_format_of_every_type_twin():
    """DECIMAL, TIMESTAMP(TZ), DATE, TIME, INTERVAL, lists, BOOLEAN,
    NULL, integers, floats and strings: the same DataRow bytes and
    RowDescription OIDs from both packages."""
    ts = 1_700_000_123_456_789
    day = 19_700
    vals = [(decimal.Decimal("1.0100"), "DECIMAL"), (ts, "TIMESTAMP"),
            (ts, "TIMESTAMPTZ"), (day, "DATE"),
            (3_723_000_001, "TIME"), (True, "BOOLEAN"),
            (False, "BOOLEAN"), (None, "INT64"), (-7, "INT64"),
            (2.5, "FLOAT64"), ("O'Brien", "VARCHAR"),
            ([1, None, "a b", "", "NULL", True], "LIST")]
    for v, t in vals:
        assert p_pgwire._pg_text(v, getattr(PD, t)) == \
            r_pgwire._pg_text(v, getattr(RD, t)), (v, t)
    row = tuple(v for v, _t in vals)
    assert p_pgwire._data_row(row, [getattr(PD, t) for _v, t in vals]) == \
        r_pgwire._data_row(row, [getattr(RD, t) for _v, t in vals])
    iv_p = PInterval(months=1, days=2, usecs=3_000_000)
    iv_r = RInterval(months=1, days=2, usecs=3_000_000)
    assert p_pgwire._pg_text(iv_p, PD.INTERVAL) == \
        r_pgwire._pg_text(iv_r, RD.INTERVAL)
    assert p_pgwire._pg_text(day, PD.DATE) == \
        (datetime.date(1970, 1, 1) + datetime.timedelta(days=day)).isoformat()
    assert p_pgwire._OID.keys() == {getattr(PD, d.name)
                                    for d in r_pgwire._OID}
    for d, oid in r_pgwire._OID.items():
        assert p_pgwire._OID[getattr(PD, d.name)] == oid


def test_pgwire_typed_select_over_the_wire_twin():
    """A DECIMAL and TIMESTAMP MV, a DECIMAL SUM, an AVG, a DATE cast
    and a NULL read over the wire: RowDescription (names and OIDs) and
    DataRows byte-equal to the reference's."""
    async def scenario(pkg, record):
        fe = frontend(pkg, rate_limit=4, min_chunks=4)
        srv = await _serve(pkg, fe)
        try:
            c = await _Client.connect(srv.port)
            for sql in (nexmark_source("bid", 2000, chunk=256),
                        "CREATE MATERIALIZED VIEW m AS SELECT auction, "
                        "0.908 * price AS p, date_time FROM bid",
                        "CREATE MATERIALIZED VIEW s AS SELECT auction, "
                        "sum(0.5 * price) AS total, avg(price) AS a, "
                        "max(date_time) AS last FROM bid GROUP BY auction"):
                record(await c.query(sql))
            await fe.step(6)
            for sql, ordered in (
                    ("SELECT * FROM m ORDER BY date_time, auction, p "
                     "LIMIT 20", True),
                    ("SELECT * FROM s", False),
                    ("SELECT CAST('2024-01-02' AS DATE) AS d, "
                     "CAST('12.5' AS DECIMAL) + 1 AS x, "
                     "CAST('2024-01-02 03:04:05' AS TIMESTAMP) AS t, "
                     "null AS n, false AS f", False)):
                msgs = record(await c.query(sql), ordered=ordered)
                assert msgs[0][0] == b"T" and _rows(msgs), sql
            c.close()
        finally:
            await srv.close()
            await fe.close()

    run_both(scenario)
