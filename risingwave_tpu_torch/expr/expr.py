"""Vectorized expressions over host chunks.

Port of the traceable subset of ``risingwave_tpu/expr/expr.py``
(reference parity: src/expr/src/expr/mod.rs:74): column refs, literals,
``BinaryOp`` (comparisons, + - * / % with the DECIMAL scale, Kleene
AND/OR), ``UnaryOp``, ``Cast``, ``Case``, ``tumble_start`` /
``tumble_end`` and ``extract_epoch``, evaluated on numpy. ``eval``
returns a ``Column`` covering the chunk's full capacity; padding rows
compute values that are never read.

- Nulls: SQL three-valued logic through optional validity arrays;
  arithmetic propagates NULL, AND/OR are Kleene.
- DECIMAL is a scaled int64 (``DECIMAL_SCALE``): * and / rescale with
  truncation toward zero, + - and comparisons are plain int64 ops.
- A zero divisor gives NULL (the reference's streaming divergence from
  the SQL error).

The same trees also run on the card: ``ops/fused.py`` compiles them into
an expression program that ``csrc/fused.cu`` interprets per row. The
host-typed half (VARCHAR casts and the string and date functions
``lower`` ... ``date_trunc``, ref :684-828) runs on the host only, as
the reference's does: those are projection-side functions over object
arrays, and the fusion rule refuses programs that hold them.
"""

from __future__ import annotations

import decimal
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from risingwave_tpu_torch.common.chunk import Column, DataChunk
from risingwave_tpu_torch.common.types import (
    DECIMAL_SCALE, DataType, DecimalOverflowError, Interval, _SCALED_MAX,
    decimal_to_scaled, scaled_to_decimal,
)

# -- type inference ---------------------------------------------------------

_NUMERIC_ORDER = [
    DataType.INT16, DataType.INT32, DataType.INT64,
    DataType.DECIMAL, DataType.FLOAT32, DataType.FLOAT64,
]


def promote_numeric(lt: DataType, rt: DataType) -> DataType:
    """Binary numeric result type: later in _NUMERIC_ORDER wins."""
    if lt == rt:
        return lt
    for t in (lt, rt):
        if t not in _NUMERIC_ORDER:
            raise TypeError(f"not numeric: {t}")
    return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(lt),
                              _NUMERIC_ORDER.index(rt))]


_TIME_TYPES = (DataType.DATE, DataType.TIME, DataType.TIMESTAMP,
               DataType.TIMESTAMPTZ)
_INT_TYPES = (DataType.INT16, DataType.INT32, DataType.INT64,
              DataType.SERIAL)


def _promote_comparison(lt: DataType, rt: DataType) -> DataType:
    """Comparison common type: numerics promote; a time type compares
    against integer literals in its physical domain (days / µs), and
    TIMESTAMP against TIMESTAMPTZ (same µs domain). Mixed-unit time
    comparisons (DATE vs TIMESTAMP) are rejected."""
    ts_pair = {DataType.TIMESTAMP, DataType.TIMESTAMPTZ}
    if lt in ts_pair and rt in ts_pair:
        return DataType.TIMESTAMP
    if lt in _TIME_TYPES and rt in _TIME_TYPES:
        raise TypeError(
            f"cannot compare {lt.value} with {rt.value} — cast one "
            "side explicitly")
    for a, b in ((lt, rt), (rt, lt)):
        if a in _TIME_TYPES and b in _INT_TYPES:
            return a
    return promote_numeric(lt, rt)


def _parse_timestamp_us(s: str) -> int:
    import datetime
    s = s.strip().replace("T", " ")
    dt = datetime.datetime.fromisoformat(s)
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    epoch = datetime.datetime(1970, 1, 1)
    return int((dt - epoch).total_seconds() * 1_000_000)


def _cast_one_string(v, dst: DataType):
    if v is None:
        return 0
    if dst in (DataType.INT16, DataType.INT32, DataType.INT64,
               DataType.SERIAL):
        return int(v)
    if dst in (DataType.FLOAT32, DataType.FLOAT64):
        return float(v)
    if dst == DataType.DECIMAL:
        return decimal_to_scaled(decimal.Decimal(v))
    if dst == DataType.BOOLEAN:
        return v.strip().lower() in ("t", "true", "1", "yes", "on")
    if dst in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
        return _parse_timestamp_us(v)
    if dst == DataType.DATE:
        import datetime
        return (datetime.date.fromisoformat(v.strip())
                - datetime.date(1970, 1, 1)).days
    if dst == DataType.TIME:
        import datetime
        t = datetime.time.fromisoformat(v.strip())
        return ((t.hour * 60 + t.minute) * 60 + t.second) * 1_000_000 \
            + t.microsecond
    raise TypeError(f"cannot cast string to {dst}")


def _format_to_string(v, src: DataType) -> str:
    """pg text-out for physical values (round-trips _cast_one_string)."""
    import datetime
    if src == DataType.DECIMAL:
        return str(scaled_to_decimal(v))
    if src == DataType.BOOLEAN:
        return "true" if v else "false"
    if src in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
        us = int(v)
        base = datetime.datetime(1970, 1, 1) + \
            datetime.timedelta(microseconds=us)
        out = base.isoformat(sep=" ")
        return out + "+00:00" if src == DataType.TIMESTAMPTZ else out
    if src == DataType.DATE:
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=int(v))).isoformat()
    if src == DataType.TIME:
        us = int(v)
        s_, rem = divmod(us, 1_000_000)
        h, r2 = divmod(s_, 3600)
        m, sec = divmod(r2, 60)
        out = f"{h:02d}:{m:02d}:{sec:02d}"
        return out + (f".{rem:06d}" if rem else "")
    return str(v)


def _cast_values(vals, src: DataType, dst: DataType):
    """Cast of a value array. VARCHAR casts parse or format per element
    (pg text-in / text-out); casts to DECIMAL detect overflow of the
    scaled int64 domain and raise."""
    if src == dst:
        return vals
    if src == DataType.VARCHAR:
        out = [_cast_one_string(v, dst) for v in vals.tolist()]
        return np.asarray(out, dtype=dst.np_dtype)
    if dst == DataType.VARCHAR:
        lst = [_format_to_string(v, src) for v in vals.tolist()]
        out = np.empty(len(lst), dtype=object)
        out[:] = lst
        return out
    if not (src.is_device and dst.is_device):
        raise TypeError(f"cannot cast {src.value} to {dst.value}")
    if dst == DataType.DECIMAL:
        lim = _SCALED_MAX // DECIMAL_SCALE
        if src in (DataType.FLOAT32, DataType.FLOAT64):
            f = np.asarray(vals, dtype=np.float64)
            bad = ~np.isfinite(f) | (np.abs(f) > float(lim))
            if bad.any():
                raise DecimalOverflowError(
                    f"cast to DECIMAL overflows the int64 fixed-point "
                    f"domain (|value| must stay under {lim}): "
                    f"{f[bad][0]!r}")
            return np.rint(vals * DECIMAL_SCALE).astype(np.int64)
        v64 = np.asarray(vals).astype(np.int64)
        bad = (v64 > lim) | (v64 < -lim)
        if bad.any():
            raise DecimalOverflowError(
                f"cast to DECIMAL overflows the int64 fixed-point "
                f"domain (|value| must stay under {lim}): "
                f"{int(v64[bad][0])}")
        return vals.astype(np.int64) * np.int64(DECIMAL_SCALE)
    if src == DataType.DECIMAL:
        # decimal → float: divide in the destination float dtype
        return vals.astype(dst.dtype) / np.asarray(DECIMAL_SCALE,
                                                   dtype=dst.dtype)
    return vals.astype(dst.dtype)


def _merge_validity(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _div_trunc(num, den):
    """Integer division truncating toward zero (SQL numeric semantics)."""
    q = num // den
    rem = num % den
    neg = (num < 0) != (den < 0)
    return np.where(neg & (rem != 0), q + 1, q)


# -- expression nodes ---------------------------------------------------------


class Expression:
    """Base: vectorized ``eval(chunk) -> Column``."""

    return_type: DataType

    def eval(self, chunk: DataChunk) -> Column:
        raise NotImplementedError

    # -- operator sugar for plan construction ---------------------------
    def __add__(self, other):  return BinaryOp("+", self, _wrap(other))
    def __sub__(self, other):  return BinaryOp("-", self, _wrap(other))
    def __mul__(self, other):  return BinaryOp("*", self, _wrap(other))
    def __truediv__(self, other): return BinaryOp("/", self, _wrap(other))
    def __mod__(self, other):  return BinaryOp("%", self, _wrap(other))
    def __eq__(self, other):   return BinaryOp("=", self, _wrap(other))  # type: ignore[override]
    def __ne__(self, other):   return BinaryOp("<>", self, _wrap(other))  # type: ignore[override]
    def __lt__(self, other):   return BinaryOp("<", self, _wrap(other))
    def __le__(self, other):   return BinaryOp("<=", self, _wrap(other))
    def __gt__(self, other):   return BinaryOp(">", self, _wrap(other))
    def __ge__(self, other):   return BinaryOp(">=", self, _wrap(other))
    def __and__(self, other):  return BinaryOp("and", self, _wrap(other))
    def __or__(self, other):   return BinaryOp("or", self, _wrap(other))
    def __invert__(self):      return UnaryOp("not", self)
    def __neg__(self):         return UnaryOp("neg", self)
    __hash__ = object.__hash__


def _wrap(v) -> "Expression":
    return v if isinstance(v, Expression) else Literal.infer(v)


class InputRef(Expression):
    """Column reference by index (expr_input_ref.rs analog)."""

    def __init__(self, index: int, data_type: DataType):
        self.index = index
        self.return_type = data_type

    def eval(self, chunk: DataChunk) -> Column:
        c = chunk.columns[self.index]
        assert c.data_type == self.return_type, (c.data_type,
                                                 self.return_type)
        return c

    def __repr__(self):
        return f"${self.index}:{self.return_type.name.lower()}"


class Literal(Expression):
    """Constant (expr_literal.rs analog); broadcast at eval."""

    def __init__(self, value, data_type: DataType):
        self.value = value
        self.return_type = data_type

    @staticmethod
    def infer(v) -> "Literal":
        if isinstance(v, bool):
            return Literal(v, DataType.BOOLEAN)
        if isinstance(v, int):
            return Literal(v, DataType.INT64)
        if isinstance(v, float):
            return Literal(v, DataType.FLOAT64)
        if isinstance(v, str):
            return Literal(v, DataType.VARCHAR)
        if isinstance(v, Interval):
            return Literal(v, DataType.INTERVAL)
        if v is None:
            return Literal(None, DataType.INT64)
        if isinstance(v, decimal.Decimal):
            return Literal(v, DataType.DECIMAL)
        raise TypeError(f"cannot infer literal type of {v!r}")

    def _physical(self):
        if self.return_type == DataType.DECIMAL and self.value is not None:
            return decimal_to_scaled(self.value)
        return self.value

    def eval(self, chunk: DataChunk) -> Column:
        cap = chunk.capacity
        dt = self.return_type
        if self.value is None:
            vals = (np.zeros(cap, dtype=dt.np_dtype) if dt.is_device
                    else np.full(cap, None, dtype=object))
            return Column(dt, vals, np.zeros(cap, dtype=bool))
        if dt.is_device:
            return Column(dt, np.full(cap, self._physical(),
                                      dtype=dt.np_dtype))
        return Column(dt, np.full(cap, self.value, dtype=object))

    def __repr__(self):
        return f"{self.value!r}:{self.return_type.name.lower()}"


def lit(v, data_type: Optional[DataType] = None) -> Literal:
    if data_type is DataType.DECIMAL and not hasattr(v, "as_tuple"):
        v = decimal.Decimal(str(v)) if v is not None else None
    return Literal.infer(v) if data_type is None else Literal(v, data_type)


_CMP_OPS = {"=", "<>", "<", "<=", ">", ">="}
_ARITH_OPS = {"+", "-", "*", "/", "%"}
_LOGIC_OPS = {"and", "or"}
_FLOATS = (DataType.FLOAT32, DataType.FLOAT64)


class BinaryOp(Expression):
    """Arithmetic / comparison / logical binary op (expr_binary_*)."""

    def __init__(self, op: str, left: Expression, right: Expression):
        assert op in _CMP_OPS | _ARITH_OPS | _LOGIC_OPS, op
        self.op = op
        self.left = left
        self.right = right
        lt, rt = left.return_type, right.return_type
        if op in _LOGIC_OPS:
            assert lt == DataType.BOOLEAN and rt == DataType.BOOLEAN
            self.return_type = DataType.BOOLEAN
            self._common = DataType.BOOLEAN
        elif op in _CMP_OPS:
            self._common = lt if lt == rt \
                else _promote_comparison(lt, rt)
            self.return_type = DataType.BOOLEAN
        else:
            self._common = lt if lt == rt else promote_numeric(lt, rt)
            if op == "/" and self._common in (
                    DataType.INT16, DataType.INT32, DataType.INT64):
                self._common = DataType.DECIMAL  # SQL: int/int is exact-ish
            self.return_type = self._common

    def eval(self, chunk: DataChunk) -> Column:
        lc = self.left.eval(chunk)
        rc = self.right.eval(chunk)
        if self.op in _LOGIC_OPS:
            return self._eval_logic(lc, rc)
        if not self._common.is_device:
            return self._eval_host_cmp(chunk, lc, rc)
        lv = _cast_values(lc.values, lc.data_type, self._common)
        rv = _cast_values(rc.values, rc.data_type, self._common)
        validity = _merge_validity(lc.validity, rc.validity)
        op = self.op
        if op in _CMP_OPS:
            fn = {"=": np.equal, "<>": np.not_equal, "<": np.less,
                  "<=": np.less_equal, ">": np.greater,
                  ">=": np.greater_equal}[op]
            return Column(DataType.BOOLEAN, fn(lv, rv), validity)
        with np.errstate(over="ignore", divide="ignore",
                         invalid="ignore"):
            if op == "+":
                out = lv + rv
            elif op == "-":
                out = lv - rv
            elif op == "*":
                if self._common == DataType.DECIMAL:
                    out = _div_trunc(lv * rv, np.int64(DECIMAL_SCALE))
                else:
                    out = lv * rv
            elif op == "%":
                zero = rv == 0
                safe = np.where(zero, np.ones_like(rv), rv)
                if self._common in _FLOATS:
                    out = np.fmod(lv, safe)  # truncated, sign of dividend
                else:
                    # SQL truncated modulo: a - trunc(a/b)*b
                    out = lv - _div_trunc(lv, safe) * safe
                validity = _merge_validity(validity, ~zero)
            else:  # "/"
                zero = rv == 0
                safe = np.where(zero, np.ones_like(rv), rv)
                if self._common == DataType.DECIMAL:
                    out = _div_trunc(lv * np.int64(DECIMAL_SCALE), safe)
                else:
                    out = lv / safe
                validity = _merge_validity(validity, ~zero)
        return Column(self.return_type, out, validity)

    def _eval_host_cmp(self, chunk: DataChunk, lc: Column,
                       rc: Column) -> Column:
        """Comparisons over host columns (varchar etc.): numpy object ops
        on the present slots only."""
        if self.op not in _CMP_OPS:
            raise TypeError(
                f"operator {self.op!r} unsupported for host type "
                f"{self._common}; only comparisons are")
        cap = chunk.capacity
        lv, rv = np.asarray(lc.values), np.asarray(rc.values)
        validity = _merge_validity(lc.validity, rc.validity)
        lnull = lv == None  # noqa: E711  (elementwise)
        rnull = rv == None  # noqa: E711
        vis = np.asarray(chunk.visibility)
        if validity is not None:
            vis = vis & np.asarray(validity)
        ok = vis & ~lnull & ~rnull
        import operator as _op
        fn = {"=": _op.eq, "<>": _op.ne, "<": _op.lt, "<=": _op.le,
              ">": _op.gt, ">=": _op.ge}[self.op]
        res = np.zeros(cap, dtype=bool)
        idx = np.flatnonzero(ok)
        if idx.size:
            res[idx] = np.asarray(fn(lv[idx], rv[idx]), dtype=bool)
        null_any = lnull | rnull
        if null_any.any():
            nv = ~null_any
            validity = nv if validity is None \
                else (np.asarray(validity) & nv)
        return Column(DataType.BOOLEAN, res, validity)

    def _eval_logic(self, lc: Column, rc: Column) -> Column:
        lv, rv = lc.values, rc.values
        ln = lc.validity if lc.validity is not None else np.ones_like(lv)
        rn = rc.validity if rc.validity is not None else np.ones_like(rv)
        if self.op == "and":
            # Kleene: false AND null = false; true AND null = null
            out = lv & rv
            validity = ((ln & rn) | (ln & ~lv) | (rn & ~rv))
        else:
            out = lv | rv
            validity = ((ln & rn) | (ln & lv) | (rn & rv))
        if lc.validity is None and rc.validity is None:
            validity = None
        return Column(DataType.BOOLEAN, out, validity)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def and_(*exprs: Expression) -> Expression:
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryOp("and", out, e)
    return out


def or_(*exprs: Expression) -> Expression:
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryOp("or", out, e)
    return out


class UnaryOp(Expression):
    def __init__(self, op: str, child: Expression):
        assert op in ("not", "neg", "is_null", "is_not_null"), op
        self.op = op
        self.child = child
        self.return_type = (DataType.BOOLEAN if op in
                            ("not", "is_null", "is_not_null")
                            else child.return_type)

    def eval(self, chunk: DataChunk) -> Column:
        c = self.child.eval(chunk)
        if self.op == "not":
            return Column(DataType.BOOLEAN, ~c.values, c.validity)
        if self.op == "neg":
            with np.errstate(over="ignore"):
                return Column(c.data_type, -c.values, c.validity)
        cap = chunk.capacity
        present = (np.ones(cap, dtype=bool) if c.validity is None
                   else c.validity)
        vals = present if self.op == "is_not_null" else ~present
        return Column(DataType.BOOLEAN, vals, None)

    def __repr__(self):
        return f"{self.op}({self.child!r})"


class Cast(Expression):
    """Explicit type conversion (expr_cast analog; DECIMAL scaled-int64 →
    float divides out the scale)."""

    def __init__(self, child: Expression, to: DataType):
        self.child = child
        self.return_type = to

    def eval(self, chunk: DataChunk) -> Column:
        c = self.child.eval(chunk)
        if c.data_type == self.return_type:
            return c
        validity = c.validity
        if not c.data_type.is_device:
            # host columns carry NULL as the None object: derive the mask
            # here or NULL would cast to 0 / false / the epoch
            vals_l = np.asarray(c.values).tolist()
            nulls = np.fromiter((v is None for v in vals_l), dtype=bool,
                                count=len(vals_l))
            if nulls.any():
                ok = ~nulls
                validity = ok if validity is None \
                    else np.asarray(validity) & ok
        with np.errstate(invalid="ignore", over="ignore"):
            vals = _cast_values(c.values, c.data_type, self.return_type)
        return Column(self.return_type, vals, validity)

    def __repr__(self):
        return f"cast({self.child!r} as {self.return_type.value})"


# -- function registry ----------------------------------------------------------

_FUNCTIONS: Dict[str, Callable[..., Column]] = {}


def register_function(name: str):
    def deco(fn):
        _FUNCTIONS[name] = fn
        return fn
    return deco


class FuncCall(Expression):
    """Named scalar function over evaluated child columns."""

    def __init__(self, name: str, args: Sequence[Expression],
                 return_type: DataType):
        if name not in _FUNCTIONS:
            raise NotImplementedError(f"function {name} is not ported")
        self.name = name
        self.args = list(args)
        self.return_type = return_type

    def eval(self, chunk: DataChunk) -> Column:
        cols = [a.eval(chunk) for a in self.args]
        return _FUNCTIONS[self.name](self.return_type, *cols)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def _window_usecs(window: Column):
    """Interval-literal column → scalar µs, or None for a NULL literal."""
    if window.data_type != DataType.INTERVAL:
        return window.values
    iv = next((v for v in window.values if v is not None), None)
    return None if iv is None else np.int64(iv.exact_usecs())


@register_function("tumble_start")
def _tumble_start(rt: DataType, ts: Column, window: Column) -> Column:
    """Window start for TUMBLE(ts, interval): ts - ts % window_usecs
    (floor modulo). The window must be a month-free interval literal;
    NULL yields NULL."""
    w = _window_usecs(window)
    if w is None:
        return Column(rt, np.zeros_like(ts.values),
                      np.zeros(ts.values.shape[0], dtype=bool))
    return Column(rt, ts.values - (ts.values % w), ts.validity)


@register_function("tumble_end")
def _tumble_end(rt: DataType, ts: Column, window: Column) -> Column:
    w = _window_usecs(window)
    if w is None:
        return Column(rt, np.zeros_like(ts.values),
                      np.zeros(ts.values.shape[0], dtype=bool))
    return Column(rt, ts.values - (ts.values % w) + w, ts.validity)


@register_function("extract_epoch")
def _extract_epoch(rt: DataType, ts: Column) -> Column:
    """EXTRACT(EPOCH FROM ts): µs timestamp → seconds (DECIMAL), dividing
    before the decimal scale is applied (µs × 10^4 overflows int64)."""
    whole = ts.values // np.int64(1_000_000)
    frac_us = ts.values % np.int64(1_000_000)
    secs = (whole * np.int64(DECIMAL_SCALE)
            + frac_us * np.int64(DECIMAL_SCALE) // np.int64(1_000_000))
    return Column(rt, secs, ts.validity)


def tumble_start(ts: Expression, window: Interval) -> FuncCall:
    return FuncCall("tumble_start", [ts, Literal(window, DataType.INTERVAL)],
                    ts.return_type)


def tumble_end(ts: Expression, window: Interval) -> FuncCall:
    return FuncCall("tumble_end", [ts, Literal(window, DataType.INTERVAL)],
                    ts.return_type)


class Case(Expression):
    """CASE WHEN …: branchless select over evaluated branches."""

    def __init__(self, whens: Sequence[tuple], else_: Expression):
        self.whens = list(whens)
        self.else_ = else_
        self.return_type = else_.return_type
        for _, v in self.whens:
            assert v.return_type == self.return_type

    def eval(self, chunk: DataChunk) -> Column:
        out = self.else_.eval(chunk)
        vals, validity = out.values, out.validity
        cap = chunk.capacity
        taken = np.zeros(cap, dtype=bool)
        for cond, value in self.whens:
            cc = cond.eval(chunk)
            cv = cc.values & (cc.validity if cc.validity is not None
                              else np.ones(cap, dtype=bool)) & ~taken
            vc = value.eval(chunk)
            vals = np.where(cv, vc.values, vals)
            if validity is not None or vc.validity is not None:
                lval = validity if validity is not None \
                    else np.ones(cap, dtype=bool)
                rval = vc.validity if vc.validity is not None \
                    else np.ones(cap, dtype=bool)
                validity = np.where(cv, rval, lval)
            taken = taken | cv
        return Column(self.return_type, vals, validity)

    def __repr__(self):
        return f"case({self.whens!r}, else={self.else_!r})"


# -- scalar function library (vector_op/ analog, host-typed) -----------------
# VARCHAR columns are host object arrays; these run vectorized python
# passes (they are projection-side, not kernel-side). TIMESTAMP is µs
# since epoch (int64, device). NULL in → NULL out, elementwise.

def _host_unary(rt, col, fn):
    vals = np.asarray(col.values)
    ok = np.ones(len(vals), dtype=bool) if col.validity is None \
        else np.asarray(col.validity).copy()
    out = np.empty(len(vals), dtype=object)
    for i in np.flatnonzero(ok):
        v = vals[i]
        if v is None:
            ok[i] = False
            continue
        out[i] = fn(v)
    return Column(rt, out, None if ok.all() else ok)


def _scalar_of(col: Column):
    """First non-null value of a (literal) column, or None."""
    vals = np.asarray(col.values)
    if col.validity is not None:
        idx = np.flatnonzero(np.asarray(col.validity))
        return vals[idx[0]] if len(idx) else None
    return vals[0] if len(vals) else None


@register_function("lower")
def _fn_lower(rt, s: Column) -> Column:
    return _host_unary(rt, s, lambda v: str(v).lower())


@register_function("upper")
def _fn_upper(rt, s: Column) -> Column:
    return _host_unary(rt, s, lambda v: str(v).upper())


@register_function("char_length")
def _fn_char_length(rt, s: Column) -> Column:
    vals = np.asarray(s.values)
    ok = np.ones(len(vals), dtype=bool) if s.validity is None \
        else np.asarray(s.validity).copy()
    out = np.zeros(len(vals), dtype=np.int64)
    for i in np.flatnonzero(ok):
        if vals[i] is None:
            ok[i] = False
        else:
            out[i] = len(str(vals[i]))
    return Column(rt, out, None if ok.all() else ok)


_FUNCTIONS["length"] = _FUNCTIONS["char_length"]   # pg alias


@register_function("substr")
def _fn_substr(rt, s: Column, start: Column, *ln: Column) -> Column:
    st = _scalar_of(start)
    n = _scalar_of(ln[0]) if ln else None
    if st is None:
        return _host_unary(rt, s, lambda v: None)
    # pg window semantics: the window is [start, start+len) in 1-based
    # positions BEFORE clamping — substr('hello', 0, 3) = 'he'
    raw_lo = int(st) - 1
    hi = None if n is None else raw_lo + max(int(n), 0)
    lo = max(raw_lo, 0)
    if hi is not None and hi <= lo:
        return _host_unary(rt, s, lambda v: "")
    return _host_unary(rt, s, lambda v: str(v)[lo:hi])


@register_function("split_part")
def _fn_split_part(rt, s: Column, delim: Column, idx: Column) -> Column:
    d, k = _scalar_of(delim), _scalar_of(idx)
    if d is None or k is None or str(d) == "":
        return _host_unary(rt, s, lambda v: None)
    k = int(k)
    if k == 0:
        raise ValueError("split_part position must not be zero")

    def part(v):
        parts = str(v).split(str(d))
        i = k - 1 if k > 0 else len(parts) + k   # negative: from end
        return parts[i] if 0 <= i < len(parts) else ""
    return _host_unary(rt, s, part)


@register_function("replace")
def _fn_replace(rt, s: Column, old: Column, new: Column) -> Column:
    o, n = _scalar_of(old), _scalar_of(new)
    if o is None or n is None:
        return _host_unary(rt, s, lambda v: None)
    return _host_unary(rt, s, lambda v: str(v).replace(str(o), str(n)))


@register_function("concat")
def _fn_concat(rt, *cols: Column) -> Column:
    n = max(len(np.asarray(c.values)) for c in cols)
    out = np.empty(n, dtype=object)
    for i in range(n):
        parts = []
        for c in cols:
            vals = np.asarray(c.values)
            okc = c.validity
            if okc is not None and not np.asarray(okc)[i]:
                continue                 # pg concat skips NULLs
            v = vals[i]
            if v is not None:
                parts.append(str(v))
        out[i] = "".join(parts)
    return Column(rt, out, None)


# to_char format → strftime (the subset the nexmark corpus uses; the
# reference's to_char lives in expr/src/vector_op/to_char.rs)
_TO_CHAR_MAP = [("YYYY", "%Y"), ("MM", "%m"), ("DD", "%d"),
                ("HH24", "%H"), ("MI", "%M"), ("SS", "%S")]


@register_function("to_char")
def _fn_to_char(rt, ts: Column, fmt: Column) -> Column:
    import datetime
    f = _scalar_of(fmt)
    if f is None:
        return _host_unary(rt, ts, lambda v: None)
    sf = str(f)
    for a, b in _TO_CHAR_MAP:
        sf = sf.replace(a, b)
    epoch = datetime.datetime(1970, 1, 1,
                              tzinfo=datetime.timezone.utc)

    def conv(v):
        return (epoch + datetime.timedelta(
            microseconds=int(v))).strftime(sf)
    return _host_unary(rt, ts, conv)


_DATE_PART_DIV = {
    "second": (1_000_000, 60), "minute": (60_000_000, 60),
    "hour": (3_600_000_000, 24),
}


@register_function("date_part")
def _fn_date_part(rt, field: Column, ts: Column) -> Column:
    import datetime
    f = _scalar_of(field)
    f = str(f).lower() if f is not None else ""
    vals = np.asarray(ts.values)
    ok = np.ones(len(vals), dtype=bool) if ts.validity is None \
        else np.asarray(ts.validity)
    if f in _DATE_PART_DIV:
        div, mod = _DATE_PART_DIV[f]
        out = (vals.astype(np.int64) // div) % mod
        return Column(rt, out.astype(np.int64),
                      None if ok.all() else np.asarray(ok))
    epoch = datetime.datetime(1970, 1, 1,
                              tzinfo=datetime.timezone.utc)
    attr = {"year": "year", "month": "month", "day": "day"}.get(f)
    if attr is None:
        raise ValueError(f"date_part field {f!r} unsupported")
    out = np.zeros(len(vals), dtype=np.int64)
    for i in np.flatnonzero(ok):
        out[i] = getattr(epoch + datetime.timedelta(
            microseconds=int(vals[i])), attr)
    return Column(rt, out, None if ok.all() else np.asarray(ok))


_TRUNC_US = {"second": 1_000_000, "minute": 60_000_000,
             "hour": 3_600_000_000, "day": 86_400_000_000}


@register_function("date_trunc")
def _fn_date_trunc(rt, field: Column, ts: Column) -> Column:
    f = _scalar_of(field)
    f = str(f).lower() if f is not None else ""
    unit = _TRUNC_US.get(f)
    if unit is None:
        raise ValueError(f"date_trunc field {f!r} unsupported")
    vals = np.asarray(ts.values).astype(np.int64)
    out = vals - vals % unit
    ok = ts.validity
    return Column(rt, out, None if ok is None else np.asarray(ok))
