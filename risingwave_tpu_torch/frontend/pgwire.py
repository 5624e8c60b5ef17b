"""pgwire: PostgreSQL wire-protocol (v3) server over asyncio.

Port of ``risingwave_tpu/frontend/pgwire.py`` over the port's
``Frontend``: the same messages, byte for byte, for the same statements.
``PgServer(fe)`` then ``await srv.serve(port=...)`` serves one session
to psql and client libraries; its MVs run where the session's do (the
card unless the session was made with ``device="cpu"``). Reference
parity: src/utils/pgwire/src/{pg_protocol.rs,pg_server.rs} — the
protocol surface psql AND client libraries need: startup
handshake (SSL probe declined, AuthenticationOk, ParameterStatus,
ReadyForQuery), 'Q' simple queries answered with RowDescription /
DataRow / CommandComplete, errors as ErrorResponse, 'X' terminate,
plus the EXTENDED protocol (Parse/Bind/Describe/Execute/Close/Sync)
that psycopg-style client libraries use: $n parameters substitute as quoted
text literals at Bind (per-bind re-plan; prepared-plan caching is a
later increment), failures skip to Sync. All values ship in text
format.
"""

from __future__ import annotations

import asyncio
import re
import struct
from typing import List, Optional, Tuple

from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.frontend.session import Frontend

_OID = {
    DataType.BOOLEAN: 16,
    DataType.INT16: 21, DataType.INT32: 23, DataType.INT64: 20,
    DataType.SERIAL: 20,
    DataType.FLOAT32: 700, DataType.FLOAT64: 701,
    DataType.DECIMAL: 1700,
    DataType.VARCHAR: 25,
    DataType.DATE: 1082, DataType.TIME: 1083,
    DataType.TIMESTAMP: 1114, DataType.TIMESTAMPTZ: 1184,
    DataType.INTERVAL: 1186, DataType.BYTEA: 17, DataType.JSONB: 3802,
}

SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102
PROTOCOL_V3 = 196608


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class PgServer:
    """Serves one Frontend session per connection's statements.

    All connections share the session's catalog and barrier loop (the
    reference shares via meta; we share in-process)."""

    def __init__(self, frontend: Frontend,
                 password: Optional[str] = None):
        self.frontend = frontend
        # cleartext password auth (pg_protocol.rs startup handshake;
        # AuthenticationCleartextPassword). None ⇒ trust (no auth).
        self.password = password
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self, host: str = "127.0.0.1", port: int = 4566):
        self._server = await asyncio.start_server(
            self._handle, host, port)
        return self._server

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection loop --------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # extended-protocol state (pg_protocol.rs): prepared statements
        # and portals are per-connection; after an error the backend
        # discards messages until Sync
        stmts: dict = {}      # name → sql
        portals: dict = {}    # name → ["rows", rows, schema, pos]|["cmd", s]
        # Describe(statement) results reusable by the following Bind.
        # PER CONNECTION (prepared statements are per-connection) and
        # invalidated whenever Parse redefines the name (a server-global
        # cache could hand one connection another connection's rows, or
        # stale rows after re-Parse of "")
        describe_cache: dict = {}
        failed = False
        try:
            if not await self._startup(reader, writer):
                return
            while True:
                hdr = await reader.readexactly(5)
                tag = hdr[0:1]
                ln = struct.unpack(">I", hdr[1:5])[0]
                payload = await reader.readexactly(ln - 4)
                if tag == b"X":
                    return
                if tag == b"S":                       # Sync
                    failed = False
                    writer.write(_ready())
                    await writer.drain()
                    continue
                if failed:
                    continue                          # skip until Sync
                if tag == b"Q":
                    sql = payload.rstrip(b"\x00").decode()
                    await self._simple_query(writer, sql)
                    continue
                try:
                    if tag == b"P":
                        self._parse_msg(payload, stmts, describe_cache)
                        writer.write(_msg(b"1", b""))  # ParseComplete
                    elif tag == b"B":
                        await self._bind_msg(payload, stmts, portals,
                                             describe_cache)
                        writer.write(_msg(b"2", b""))  # BindComplete
                    elif tag == b"D":
                        await self._describe_msg(payload, stmts, portals,
                                                 describe_cache, writer)
                    elif tag == b"E":
                        self._execute_msg(payload, portals, writer)
                    elif tag == b"C":                  # Close
                        kind = payload[0:1]
                        name, _ = self._read_cstr(payload, 1)
                        (stmts if kind == b"S" else portals).pop(
                            name, None)
                        writer.write(_msg(b"3", b""))  # CloseComplete
                    elif tag == b"H":                  # Flush
                        pass
                    else:
                        raise ValueError(
                            f"unsupported message {tag!r}")
                    await writer.drain()
                except (Exception,) as e:              # noqa: BLE001
                    writer.write(_error(str(e)))
                    await writer.drain()
                    failed = True
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    # -- extended protocol -------------------------------------------------
    _QUOTED = re.compile(r"'(?:[^']|'')*'")
    _PARAM = re.compile(r"\$(\d+)")

    @classmethod
    def _sub_params_sql(cls, sql: str, params) -> str:
        """Token-aware $n substitution: quoted regions are untouched,
        and substituted values can never be re-scanned for $n (each
        segment is processed exactly once)."""
        def sub_segment(seg: str) -> str:
            def repl(m):
                i = int(m.group(1))
                if not (1 <= i <= len(params)):
                    raise ValueError(f"parameter ${i} not bound")
                v = params[i - 1]
                return "NULL" if v is None else \
                    "'" + v.replace("'", "''") + "'"
            return cls._PARAM.sub(repl, seg)

        out = []
        at = 0
        for m in cls._QUOTED.finditer(sql):
            out.append(sub_segment(sql[at:m.start()]))
            out.append(m.group(0))
            at = m.end()
        out.append(sub_segment(sql[at:]))
        return "".join(out)

    @classmethod
    def _param_count(cls, sql: str) -> int:
        n = 0
        at = 0
        for m in cls._QUOTED.finditer(sql):
            for pm in cls._PARAM.finditer(sql[at:m.start()]):
                n = max(n, int(pm.group(1)))
            at = m.end()
        for pm in cls._PARAM.finditer(sql[at:]):
            n = max(n, int(pm.group(1)))
        return n

    @staticmethod
    def _read_cstr(payload: bytes, at: int):
        end = payload.index(b"\x00", at)
        return payload[at:end].decode(), end + 1

    def _parse_msg(self, payload: bytes, stmts: dict,
                   describe_cache: dict) -> None:
        name, at = self._read_cstr(payload, 0)
        sql, at = self._read_cstr(payload, at)
        # declared parameter-type OIDs are accepted and ignored (text
        # parameters are substituted at bind time)
        stmts[name] = sql
        describe_cache.pop(name, None)   # re-Parse invalidates

    async def _bind_msg(self, payload: bytes, stmts: dict,
                        portals: dict, describe_cache: dict) -> None:
        portal, at = self._read_cstr(payload, 0)
        stmt, at = self._read_cstr(payload, at)
        cached = describe_cache.pop(stmt, None)
        sql = stmts[stmt]
        nfmt = struct.unpack_from(">H", payload, at)[0]
        fmts = struct.unpack_from(f">{nfmt}H", payload, at + 2) \
            if nfmt else ()
        if any(f == 1 for f in fmts):
            raise ValueError(
                "binary-format parameters are not supported — bind "
                "parameters as text")
        at += 2 + 2 * nfmt
        nparams = struct.unpack_from(">H", payload, at)[0]
        at += 2
        params = []
        for _ in range(nparams):
            plen = struct.unpack_from(">i", payload, at)[0]
            at += 4
            if plen < 0:
                params.append(None)
            else:
                params.append(payload[at:at + plen].decode())
                at += plen
        # $n substitution with SQL-quoted text literals (the statement
        # re-plans per bind; prepared-plan caching is a later increment)
        if cached is not None and not params:
            portals[portal] = ["rows", cached[1], cached[2], 0]
            return
        sql = self._sub_params_sql(sql, params)
        result = await self.frontend.execute(sql)
        if isinstance(result, str):
            portals[portal] = ["cmd", result]
        else:
            schema = getattr(self.frontend, "last_select_schema", None)
            portals[portal] = ["rows", result, schema, 0]

    async def _describe_msg(self, payload: bytes, stmts: dict,
                            portals: dict, describe_cache: dict,
                            writer) -> None:
        kind = payload[0:1]
        name, _ = self._read_cstr(payload, 1)
        if kind == b"S":
            sql = stmts.get(name, "")
            nparams = self._param_count(sql)
            # parameter types are unknown (OID 0 = unspecified); the
            # COUNT must be right or count-validating clients bail
            writer.write(_msg(b"t", struct.pack(
                f">H{nparams}I", nparams, *([0] * nparams))))
            head = sql.lstrip().split(None, 1)
            is_select = bool(head) and head[0].lower() in (
                "select", "show", "explain")
            if is_select and nparams == 0:
                # parameterless SELECT: run it now for real metadata
                # and cache the rows — Bind reuses them instead of
                # executing the same query twice per round trip
                rows = await self.frontend.execute(sql)
                schema = getattr(self.frontend,
                                 "last_select_schema", None)
                describe_cache[name] = ("rows", rows, schema)
                writer.write(_row_description(rows, schema))
            else:
                # parameterized (shape unknown until Bind — portal
                # Describe returns the real RowDescription) or a
                # command: NoData
                writer.write(_msg(b"n", b""))
            return
        p = portals[name]
        if p[0] == "cmd":
            writer.write(_msg(b"n", b""))              # NoData
        else:
            writer.write(_row_description(p[1], p[2]))

    def _execute_msg(self, payload: bytes, portals: dict,
                     writer) -> None:
        name, at = self._read_cstr(payload, 0)
        # fetch-size pagination: honor the int32 max-rows
        # field — JDBC setFetchSize / psycopg server-side cursors expect
        # PortalSuspended between partial result sets
        max_rows = struct.unpack_from(">i", payload, at)[0]
        p = portals[name]
        if p[0] == "cmd":
            writer.write(_msg(b"C", _cstr(p[1].replace("_", " "))))
            return
        rows, schema, pos = p[1], p[2], p[3]
        types = ([f.data_type for f in schema]
                 if schema is not None else None)
        end = len(rows) if max_rows <= 0 else min(len(rows),
                                                  pos + max_rows)
        for row in rows[pos:end]:
            writer.write(_data_row(row, types))
        p[3] = end
        if end < len(rows):
            writer.write(_msg(b"s", b""))            # PortalSuspended
        else:
            writer.write(_msg(b"C", _cstr(f"SELECT {end - pos}")))

    async def _startup(self, reader, writer) -> bool:
        while True:
            ln, code = struct.unpack(
                ">II", await reader.readexactly(8))
            if code == SSL_REQUEST:
                writer.write(b"N")            # no TLS
                await writer.drain()
                continue
            if code == CANCEL_REQUEST:
                return False
            if code != PROTOCOL_V3:
                writer.write(_error(f"unsupported protocol {code}"))
                await writer.drain()
                return False
            await reader.readexactly(ln - 8)  # user/database params
            break
        if self.password is not None:
            # AuthenticationCleartextPassword → expect PasswordMessage
            writer.write(_msg(b"R", struct.pack(">I", 3)))
            await writer.drain()
            hdr = await reader.readexactly(5)
            if hdr[0:1] != b"p":
                writer.write(_error("expected PasswordMessage"))
                await writer.drain()
                return False
            ln = struct.unpack(">I", hdr[1:5])[0]
            pw = (await reader.readexactly(ln - 4)).rstrip(b"\x00")
            if pw.decode(errors="replace") != self.password:
                writer.write(_error("password authentication failed"))
                await writer.drain()
                return False
        out = _msg(b"R", struct.pack(">I", 0))       # AuthenticationOk
        for k, v in (("server_version", "13.0 (risingwave-tpu)"),
                     ("client_encoding", "UTF8"),
                     ("server_encoding", "UTF8"),
                     ("DateStyle", "ISO")):
            out += _msg(b"S", _cstr(k) + _cstr(v))
        out += _msg(b"K", struct.pack(">II", 0, 0))  # BackendKeyData
        out += _ready()
        writer.write(out)
        await writer.drain()
        return True

    async def _simple_query(self, writer, sql: str) -> None:
        try:
            result = await self.frontend.execute(sql)
            schema = getattr(self.frontend, "last_select_schema", None)
        except (Exception,) as e:                    # noqa: BLE001
            writer.write(_error(str(e)))
            writer.write(_ready())
            await writer.drain()
            return
        if isinstance(result, str):                  # DDL/command
            writer.write(_msg(b"C", _cstr(result.replace("_", " "))))
        else:
            writer.write(_row_description(result, schema))
            types = ([f.data_type for f in schema]
                     if schema is not None else None)
            for row in result:
                writer.write(_data_row(row, types))
            writer.write(_msg(b"C", _cstr(f"SELECT {len(result)}")))
        writer.write(_ready())
        await writer.drain()


def _ready() -> bytes:
    return _msg(b"Z", b"I")


def _error(message: str) -> bytes:
    fields = b"SERROR\x00" + b"CXX000\x00" + b"M" + _cstr(message) + b"\x00"
    return _msg(b"E", fields)


def _row_description(rows: List[tuple],
                     schema: Optional[Schema]) -> bytes:
    if schema is not None:
        cols: List[Tuple[str, int]] = [
            (f.name, _OID.get(f.data_type, 25)) for f in schema]
    else:
        width = len(rows[0]) if rows else 0
        cols = [(f"col{i}", 25) for i in range(width)]
    payload = struct.pack(">H", len(cols))
    for name, oid in cols:
        payload += _cstr(name) + struct.pack(
            ">IHIhih", 0, 0, oid, -1, -1, 0)
    return _msg(b"T", payload)


def _data_row(row: tuple,
              types: Optional[List[DataType]] = None) -> bytes:
    payload = struct.pack(">H", len(row))
    for i, v in enumerate(row):
        if v is None:
            payload += struct.pack(">i", -1)
        else:
            dt = types[i] if types is not None and i < len(types) else None
            b = _pg_text(v, dt).encode()
            payload += struct.pack(">I", len(b)) + b
    return _msg(b"D", payload)


_USECS_PER_SEC = 1_000_000
_SECS_PER_DAY = 86_400


def _fmt_usec_of_day(usecs: int) -> str:
    s, us = divmod(usecs, _USECS_PER_SEC)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    out = f"{h:02d}:{m:02d}:{sec:02d}"
    return out + (f".{us:06d}" if us else "")


def _fmt_date(days: int) -> str:
    import datetime
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))
    return d.isoformat()


def _pg_list(v) -> str:
    """array_agg output → pg array text: NULL elements literal, and
    quoting whenever the element could be misread (delimiters, quotes,
    backslashes, empty strings, or the literal word NULL)."""
    parts = []
    for x in v:
        if x is None:
            parts.append("NULL")
            continue
        # element type is unknown (LIST carries none yet): scalar
        # formatting handles bool/nested; physical time ints pass
        # through un-rendered until LIST gains an element type
        s = _pg_text(x)
        if s == "" or s.upper() == "NULL" or any(
                c in s for c in ',{}"\\ '):
            s = s.replace("\\", "\\\\").replace('"', '\\"')
            parts.append(f'"{s}"')
        else:
            parts.append(s)
    return "{" + ",".join(parts) + "}"


def _pg_text(v, dt: Optional[DataType] = None) -> str:
    """Text-format one value. Physical time types (raw ints — see
    common/types.py:119-122) are rendered ISO-8601 so psql/psycopg can
    parse them under the advertised OIDs."""
    if v is True:
        return "t"
    if v is False:
        return "f"
    if dt == DataType.LIST or isinstance(v, (tuple, list)):
        return _pg_list(v)
    if dt == DataType.DATE:
        return _fmt_date(int(v))
    if dt == DataType.TIME:
        return _fmt_usec_of_day(int(v))
    if dt in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
        usecs = int(v)
        day, of_day = divmod(usecs, _SECS_PER_DAY * _USECS_PER_SEC)
        out = f"{_fmt_date(day)} {_fmt_usec_of_day(of_day)}"
        return out + "+00" if dt == DataType.TIMESTAMPTZ else out
    return str(v)
