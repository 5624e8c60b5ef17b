"""Record parsers: external bytes → typed rows/columns.

Port of ``risingwave_tpu/connectors/parser.py`` without its epoch
phase ledger hooks (``LEDGER.phase("host_ingest")`` at :306, :335 and
:347; the ledger is ``ROADMAP.md`` queue A item 12): the parse itself,
its coercions and its error isolation are the reference's.

Reference parity: src/connector/src/parser/ — the parser layer between
raw connector payloads and typed rows (json_parser.rs, csv_parser.rs;
the Debezium/Avro family is future work). Values land in the PHYSICAL
representation the rest of the system uses (timestamps as µs ints,
DECIMAL as scaled int64 — common/types.py), so chunks built from parsed
records are indistinguishable from generated ones.

Two parse paths share the coercion rules:

- **Columnar batch path** (``build_chunk``, the source hot path): the
  whole payload batch decodes in ONE pass (JSON: one combined
  ``json.loads`` over a synthesized array; CSV: one decode + split) and
  each field coerces as ONE vectorized numpy column — no per-record
  tuples ever materialize, and the resulting ``StreamChunk`` carries
  ready numpy columns the fused preludes encode straight into raw
  int64 matrices. Malformed records are ISOLATED, not tolerated-by-
  abandoning-the-batch: a failed combined decode re-parses record-wise
  (skip-and-count, the reference's parser error tolerance) and a failed
  column coercion re-coerces that column row-wise, dropping exactly the
  offending records.
- **Row path** (``parse_records``/``parse_batch``, and the batch path's
  isolation fallback): one tuple per record via per-field coercers —
  the bit-identity oracle's off arm (``batch=False``).
"""

from __future__ import annotations

import abc
import json
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, Op, StreamChunk, next_pow2
from risingwave_tpu_torch.common.types import DataType, Schema, decimal_to_scaled

_USECS = 1_000_000


def _parse_timestamp(v) -> int:
    """ISO-8601 string or epoch number → µs since epoch."""
    if isinstance(v, (int, float)):
        # heuristic: values up to ~2100 in seconds; larger ones are
        # already µs (matches the bench generators' physical encoding)
        return int(v * _USECS) if abs(v) < 5_000_000_000 else int(v)
    import datetime
    s = str(v).replace("Z", "+00:00")
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * _USECS)


def _parse_date(v) -> int:
    import datetime
    if isinstance(v, (int, float)):
        return int(v)
    return (datetime.date.fromisoformat(str(v))
            - datetime.date(1970, 1, 1)).days


def _parse_bytea(v) -> bytes:
    if isinstance(v, dict) and "__b" in v:
        # the filelog sink's explicit bytes envelope — guessing
        # hex from a bare string would corrupt hex-LOOKING text
        return bytes.fromhex(v["__b"])
    if isinstance(v, str):
        return v.encode()
    return bytes(v)


def _parse_decimal(v) -> int:
    from decimal import Decimal
    return decimal_to_scaled(Decimal(str(v)))


def _coerce(v, dt: DataType):
    """One JSON value → physical value for `dt` (None passes through)."""
    if v is None:
        return None
    if dt in (DataType.INT16, DataType.INT32, DataType.INT64,
              DataType.SERIAL):
        return int(v)
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return float(v)
    if dt == DataType.BOOLEAN:
        return bool(v)
    if dt == DataType.DECIMAL:
        return _parse_decimal(v)
    if dt in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
        return _parse_timestamp(v)
    if dt == DataType.DATE:
        return _parse_date(v)
    if dt == DataType.BYTEA:
        return _parse_bytea(v)
    return str(v)


# -- vectorized column coercion (the batch path's per-field pass) ----------

_INT_DTS = frozenset({DataType.INT16, DataType.INT32, DataType.INT64,
                      DataType.SERIAL})
_TS_DTS = frozenset({DataType.TIMESTAMP, DataType.TIMESTAMPTZ})


def _batch_coerce(dt: DataType, nn: np.ndarray) -> np.ndarray:
    """Non-null decoded values (object array) → physical value array,
    one vectorized pass. Raises exactly where the row path's per-value
    coercer would (the caller isolates by re-coercing row-wise), and
    produces the same physical values where it wouldn't:

    - int/float/bool columns go through numpy's object cast, which
      applies ``int()``/``float()``/truth-testing per element at C
      speed — including the row path's string parses (``int("3")``)
      and its ``ValueError`` on ``int("3.5")``.
    - timestamp columns take the numeric seconds-vs-µs heuristic as
      one ``where``; string timestamps fall to ``_parse_timestamp``
      per element (the slow shapes stay row-wise by nature).
    - DECIMAL/DATE-from-string/BYTEA coerce per element (exact Decimal
      arithmetic and envelope handling have no vector form) but still
      build the column directly — no row tuples.
    """
    if dt in _INT_DTS:
        return nn.astype(np.int64)
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return nn.astype(np.float64)
    if dt == DataType.BOOLEAN:
        return nn.astype(bool)
    if dt in _TS_DTS:
        a = np.asarray(nn.tolist())
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
            return np.where(np.abs(a) < 5_000_000_000, a * _USECS, a)
        if a.dtype.kind == "f":
            if np.isnan(a).any():
                raise ValueError("NaN timestamp")   # rowwise isolates
            with np.errstate(over="ignore", invalid="ignore"):
                return np.where(np.abs(a) < 5e9,
                                a * _USECS, a).astype(np.int64)
        return np.fromiter((_parse_timestamp(v) for v in nn.tolist()),
                           dtype=np.int64, count=len(nn))
    if dt == DataType.DATE:
        a = np.asarray(nn.tolist())
        if a.dtype.kind in "iuf":
            return a.astype(np.int64)
        return np.fromiter((_parse_date(v) for v in nn.tolist()),
                           dtype=np.int64, count=len(nn))
    if dt == DataType.DECIMAL:
        return np.fromiter((_parse_decimal(v) for v in nn.tolist()),
                           dtype=np.int64, count=len(nn))
    if dt == DataType.BYTEA:
        out = np.empty(len(nn), dtype=object)
        out[:] = [_parse_bytea(v) for v in nn.tolist()]
        return out
    out = np.empty(len(nn), dtype=object)
    out[:] = [str(v) for v in nn.tolist()]
    return out


def _coerce_column(dt: DataType, vals: List
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              Optional[np.ndarray]]:
    """One decoded column (python values, None = NULL) → (physical
    values[n], validity[n] or None, bad-record mask or None).

    The vectorized pass runs first; if ANY value refuses to coerce the
    whole column re-coerces row-wise so only the offending records are
    marked bad (skip-and-count isolation) — the batch path's answer to
    the row path's per-record try/except."""
    n = len(vals)
    obj = np.empty(n, dtype=object)
    obj[:] = vals
    nulls = obj == None                    # noqa: E711  (elementwise)
    has_null = bool(nulls.any())
    nn = obj[~nulls] if has_null else obj
    if len(nn):
        try:
            phys = _batch_coerce(dt, nn)
        except (ValueError, TypeError, KeyError):
            return _coerce_column_rowwise(dt, obj, nulls)
    else:
        phys = np.zeros(0, dtype=np.dtype(dt.np_dtype)
                        if dt.is_device else object)
    if not has_null:
        return phys, None, None
    out = np.zeros(n, dtype=phys.dtype) if phys.dtype != object \
        else np.empty(n, dtype=object)
    out[~nulls] = phys
    return out, ~nulls, None


def _coerce_column_rowwise(dt: DataType, obj: np.ndarray,
                           nulls: np.ndarray
                           ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                      Optional[np.ndarray]]:
    """Row-wise isolation arm: same coercions, bad values marked."""
    n = len(obj)
    vals = np.empty(n, dtype=object)
    bad = np.zeros(n, dtype=bool)
    for i, v in enumerate(obj.tolist()):
        if v is None:
            continue
        try:
            vals[i] = _coerce(v, dt)
        except (ValueError, TypeError, KeyError):
            bad[i] = True
    ok = ~nulls & ~bad
    if dt.is_device:
        out = np.zeros(n, dtype=np.dtype(dt.np_dtype))
        if ok.any():
            out[ok] = vals[ok].astype(out.dtype)
    else:
        out = np.empty(n, dtype=object)
        out[ok] = vals[ok]
    return out, ok, (bad if bad.any() else None)


def _physical_column(dt: DataType, vals: List) -> Tuple[
        np.ndarray, Optional[np.ndarray]]:
    """Already-physical per-record values (row-path fallback) → padded-
    free (values[n], validity[n] or None) arrays."""
    obj = np.empty(len(vals), dtype=object)
    obj[:] = vals
    nulls = obj == None                    # noqa: E711
    if not nulls.any():
        return (obj.astype(np.dtype(dt.np_dtype))
                if dt.is_device else obj), None
    ok = ~nulls
    if dt.is_device:
        out = np.zeros(len(vals), dtype=np.dtype(dt.np_dtype))
        out[ok] = obj[ok].astype(out.dtype)
    else:
        out = obj.copy()
        out[nulls] = None
    return out, ok


def _chunk_from_columns(schema: Schema,
                        cols: Sequence[Tuple[np.ndarray,
                                             Optional[np.ndarray]]],
                        deletes: Optional[np.ndarray],
                        n: int) -> StreamChunk:
    """Physical column arrays → StreamChunk, padded to pow2 capacity.

    The direct constructor the batch path uses instead of
    ``from_pydict``'s list transposition — values here are PHYSICAL
    (scaled DECIMAL ints, µs timestamps), which ``from_pydict`` would
    re-scale (its contract is logical values; feeding it parsed rows
    double-scaled DECIMAL — the bug this constructor fixes for the row
    fallback too)."""
    cap = next_pow2(max(n, 1))
    out_cols: List[Column] = []
    for f, (vals, ok) in zip(schema, cols):
        dt = f.data_type
        if dt.is_device:
            arr = np.zeros(cap, dtype=np.dtype(dt.np_dtype))
        else:
            arr = np.empty(cap, dtype=object)
        arr[:n] = vals
        validity = None
        if ok is not None and not ok.all():
            validity = np.ones(cap, dtype=bool)
            validity[:n] = ok
        out_cols.append(Column(dt, arr, validity))
    vis = np.zeros(cap, dtype=bool)
    vis[:n] = True
    ops = np.full(cap, int(Op.INSERT), dtype=np.int8)
    if deletes is not None and deletes.any():
        ops[:n] = np.where(deletes, np.int8(int(Op.DELETE)),
                           np.int8(int(Op.INSERT)))
    return StreamChunk(schema, out_cols, vis, ops)


class RowParser(abc.ABC):
    """bytes-per-record → typed records (parser/ analog).

    Malformed records are SKIPPED and counted (the reference's parser
    error tolerance) — a poisoned message must not wedge the stream.
    ``batch=False`` forces the row-at-a-time path everywhere (the
    oracle's off arm; sources pass ``parse.batch`` through options).
    """

    def __init__(self, schema: Schema, batch: bool = True):
        self.schema = schema
        self.errors = 0
        self.batch = batch

    @abc.abstractmethod
    def parse_one(self, payload: bytes) -> Optional[tuple]:
        ...

    def parse_record(self, payload: bytes
                     ) -> Optional[Tuple[bool, tuple]]:
        """(is_insert, row) — formats with an op envelope (the filelog
        sink's __op) override this; plain formats are inserts."""
        row = self.parse_one(payload)
        return None if row is None else (True, row)

    def parse_records(self, payloads: Sequence[bytes]
                      ) -> List[Tuple[bool, tuple]]:
        out = []
        for p in payloads:
            try:
                rec = self.parse_record(p)
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError):
                rec = None
            if rec is None:
                self.errors += 1
            else:
                out.append(rec)
        return out

    def parse_batch(self, payloads: Sequence[bytes]) -> List[tuple]:
        """Rows only (op envelope dropped) — the plain-source shape."""
        return [r for _ins, r in self.parse_records(payloads)]

    # -- columnar batch path ------------------------------------------
    def _parse_columns(self, payloads: Sequence[bytes]) -> Optional[
            Tuple[List[Tuple[np.ndarray, Optional[np.ndarray]]],
                  Optional[np.ndarray], int]]:
        """Batch-capable subclasses return (columns, delete-mask, n);
        None means 'no batch path' and build_chunk falls back to the
        row path."""
        return None

    def build_chunk(self, payloads: Sequence[bytes]
                    ) -> Optional[StreamChunk]:
        if self.batch:
            parsed = self._parse_columns(payloads)
            if parsed is not None:
                cols, deletes, n = parsed
                if n == 0:
                    return None
                return _chunk_from_columns(self.schema, cols,
                                           deletes, n)
        recs = self.parse_records(payloads)
        if not recs:
            return None
        n = len(recs)
        cols = [
            _physical_column(f.data_type,
                             [r[i] for _ins, r in recs])
            for i, f in enumerate(self.schema)]
        deletes = None
        if not all(ins for ins, _r in recs):
            deletes = np.fromiter((not ins for ins, _r in recs),
                                  dtype=bool, count=n)
        return _chunk_from_columns(self.schema, cols, deletes, n)


class JsonRowParser(RowParser):
    """One JSON object per record (parser/json_parser.rs analog);
    missing keys read as NULL, unknown keys are ignored. A ``__op``
    envelope field ("I"/"D" — the filelog sink's changelog wire
    format) maps to the chunk op so retractions survive the wire."""

    # per-type coercers BOUND AT CONSTRUCTION: _coerce's type-dispatch
    # chain would run per field per record (1.3M calls in one ad-ctr
    # window); a prebuilt (name, coercer)
    # list keeps the per-record work at one dict.get + one call per
    # field, with the common int/float cases as bare builtins
    _FAST = {DataType.INT16: int, DataType.INT32: int,
             DataType.INT64: int, DataType.SERIAL: int,
             DataType.FLOAT32: float, DataType.FLOAT64: float,
             DataType.BOOLEAN: bool,
             DataType.TIMESTAMP: _parse_timestamp,
             DataType.TIMESTAMPTZ: _parse_timestamp}

    def __init__(self, schema: Schema, batch: bool = True):
        super().__init__(schema, batch=batch)
        self._fields = [
            (f.name,
             self._FAST.get(f.data_type)
             or (lambda v, _dt=f.data_type: _coerce(v, _dt)))
            for f in schema]

    def parse_one(self, payload: bytes) -> Optional[tuple]:
        rec = self.parse_record(payload)
        return None if rec is None else rec[1]

    @staticmethod
    def _decode_payload(payload):
        # decode BEFORE json.loads: loads on bytes runs
        # detect_encoding per record — ~1s/MM records of pure
        # overhead on the ingestion hot path.
        # Rare shapes keep the old behavior: a UTF-8 BOM strips
        # (json.loads(bytes) tolerated it) and non-UTF-8 payloads
        # (UTF-16/32) fall back to loads' own encoding detection.
        if isinstance(payload, (bytes, bytearray)):
            try:
                s = payload.decode("utf-8")
                if s.startswith("\ufeff"):
                    s = s[1:]
            except UnicodeDecodeError:
                s = payload          # loads(bytes) auto-detects
        else:
            s = payload
        return s

    def parse_record(self, payload: bytes
                     ) -> Optional[Tuple[bool, tuple]]:
        obj = json.loads(self._decode_payload(payload))
        if not isinstance(obj, dict):
            return None
        get = obj.get
        row = tuple(
            None if (v := get(name)) is None else coerce(v)
            for name, coerce in self._fields)
        return (get("__op", "I") != "D", row)

    # -- batch path -----------------------------------------------------
    def _decode_objs(self, payloads: Sequence[bytes]) -> List[dict]:
        """Whole batch → list of record dicts, ONE json.loads in the
        common case (payloads joined into a synthesized JSON array —
        the array parse IS the per-record parse, at C speed with no
        per-record Python). Any malformed/odd-encoding record fails
        the combined parse; the fallback re-parses record-wise so only
        the offenders are skipped and counted."""
        try:
            text = b"[" + b",".join(payloads) + b"]"
            objs = json.loads(text.decode("utf-8"))
            if len(objs) != len(payloads):
                # a malformed payload that PARSES as several values
                # ('{..},{..}') would mint phantom records — the row
                # path counts it as one error; isolate record-wise
                raise ValueError("record/payload count mismatch")
        except (UnicodeDecodeError, ValueError):
            objs = []
            for p in payloads:
                try:
                    obj = json.loads(self._decode_payload(p))
                except (ValueError, TypeError):
                    self.errors += 1
                    continue
                objs.append(obj)
        good = [o for o in objs if isinstance(o, dict)]
        self.errors += len(objs) - len(good)    # non-object records
        return good

    def _parse_columns(self, payloads: Sequence[bytes]):
        objs = self._decode_objs(payloads)
        if not objs:
            return [], None, 0
        n = len(objs)
        cols: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        bad: Optional[np.ndarray] = None
        for f in self.schema:
            name = f.name
            vals = [o.get(name) for o in objs]
            v, ok, b = _coerce_column(f.data_type, vals)
            cols.append((v, ok))
            if b is not None:
                bad = b if bad is None else (bad | b)
        deletes = None
        if any("__op" in o for o in objs):
            deletes = np.fromiter(
                (o.get("__op", "I") == "D" for o in objs),
                dtype=bool, count=n)
        if bad is not None:
            # drop the records whose coercion failed (skip-and-count);
            # earlier columns already built — one gather fixes them up
            self.errors += int(bad.sum())
            keep = ~bad
            n = int(keep.sum())
            cols = [(v[keep], None if ok is None else ok[keep])
                    for v, ok in cols]
            if deletes is not None:
                deletes = deletes[keep]
        return cols, deletes, n


class CsvRowParser(RowParser):
    """Positional delimited records (parser/csv_parser.rs analog);
    empty fields read as NULL. Coercers are PREBOUND per column (as
    the JSON parser's are): one call per field per record on
    the row path, one vectorized pass per column on the batch path."""

    _FAST = {DataType.INT16: int, DataType.INT32: int,
             DataType.INT64: int, DataType.SERIAL: int,
             DataType.FLOAT32: float, DataType.FLOAT64: float,
             DataType.BOOLEAN: bool,
             DataType.TIMESTAMP: _parse_timestamp,
             DataType.TIMESTAMPTZ: _parse_timestamp}

    def __init__(self, schema: Schema, delimiter: str = ",",
                 batch: bool = True):
        super().__init__(schema, batch=batch)
        self.delimiter = delimiter
        self._fields: List[Tuple[int, DataType, Callable]] = [
            (i, f.data_type,
             self._FAST.get(f.data_type)
             or (lambda v, _dt=f.data_type: _coerce(v, _dt)))
            for i, f in enumerate(self.schema)]

    def parse_one(self, payload: bytes) -> Optional[tuple]:
        parts = payload.decode().rstrip("\r\n").split(self.delimiter)
        if len(parts) < len(self.schema):
            return None
        return tuple(
            None if parts[i] == "" else coerce(parts[i])
            for i, _dt, coerce in self._fields)

    def _parse_columns(self, payloads: Sequence[bytes]):
        try:
            lines = [p.decode().rstrip("\r\n").split(self.delimiter)
                     for p in payloads]
        except UnicodeDecodeError:
            # some record isn't decodable: isolate it record-wise
            lines = []
            for p in payloads:
                try:
                    lines.append(p.decode().rstrip("\r\n")
                                 .split(self.delimiter))
                except UnicodeDecodeError:
                    self.errors += 1
        width = len(self.schema)
        short = [ln for ln in lines if len(ln) < width]
        if short:
            self.errors += len(short)
            lines = [ln for ln in lines if len(ln) >= width]
        if not lines:
            return [], None, 0
        n = len(lines)
        cols: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        bad: Optional[np.ndarray] = None
        for i, f in enumerate(self.schema):
            vals = [None if (v := ln[i]) == "" else v for ln in lines]
            v, ok, b = _coerce_column(f.data_type, vals)
            cols.append((v, ok))
            if b is not None:
                bad = b if bad is None else (bad | b)
        if bad is not None:
            self.errors += int(bad.sum())
            keep = ~bad
            n = int(keep.sum())
            cols = [(v[keep], None if ok is None else ok[keep])
                    for v, ok in cols]
        return cols, None, n


def make_parser(fmt: str, schema: Schema, options=None) -> RowParser:
    fmt = (fmt or "json").lower()
    opts = options or {}
    batch = str(opts.get("parse.batch", "true")).lower() not in (
        "false", "0", "off")
    if fmt == "json":
        return JsonRowParser(schema, batch=batch)
    if fmt == "csv":
        delim = opts.get("csv.delimiter", ",")
        return CsvRowParser(schema, delim, batch=batch)
    raise ValueError(f"unknown source format {fmt!r}")
