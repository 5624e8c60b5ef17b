"""Binder: AST expressions → typed Expression trees over a scope.

Reference parity: src/frontend/src/binder/ — name resolution against
the catalog, type derivation, aggregate-call extraction (the reference
splits these across binder + logical agg planning; here the bind pass
returns both the bound scalar expression and any extracted AggCalls).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from risingwave_tpu_torch.common.types import DataType, Field, Interval, Schema
from risingwave_tpu_torch.expr.expr import (
    BinaryOp, Case, Expression, FuncCall, InputRef, Literal,
    UnaryOp, lit, tumble_end, tumble_start,
)
from risingwave_tpu_torch.frontend import ast
from risingwave_tpu_torch.ops.hash_agg import AggKind
from risingwave_tpu_torch.stream.executors.hash_agg import AggCall


class BindError(ValueError):
    pass


@dataclass
class Scope:
    """Visible columns: (qualifier, name) → (index, type)."""

    schema: Schema
    qualifiers: List[Optional[str]]     # per column: its table alias

    @staticmethod
    def of(schema: Schema, alias: Optional[str] = None) -> "Scope":
        return Scope(schema, [alias] * len(schema))

    def concat(self, other: "Scope") -> "Scope":
        return Scope(Schema(list(self.schema) + list(other.schema)),
                     self.qualifiers + other.qualifiers)

    def find(self, name: str, table: Optional[str]) -> Tuple[int, DataType]:
        hits = []
        for i, f in enumerate(self.schema):
            if f.name != name:
                continue
            if table is not None and self.qualifiers[i] != table:
                continue
            hits.append((i, f.data_type))
        if not hits:
            raise BindError(f"column {name!r} not found"
                            + (f" in {table!r}" if table else ""))
        if len(hits) > 1:
            raise BindError(f"column {name!r} is ambiguous")
        return hits[0]


_AGG_KINDS = {"count": AggKind.COUNT, "sum": AggKind.SUM,
              "min": AggKind.MIN, "max": AggKind.MAX,
              "approx_count_distinct": AggKind.APPROX_COUNT_DISTINCT}


class Binder:
    """Binds scalar expressions; collects aggregate calls on demand."""

    def __init__(self, scope: Scope, allow_aggs: bool = False):
        self.scope = scope
        self.allow_aggs = allow_aggs
        self.agg_calls: List[AggCall] = []
        # bound input EXPRESSION per call (None for count(*)) — aggs
        # over arbitrary expressions pre-project through these
        self.agg_inputs: List[Optional[object]] = []
        # bound agg call → position (dedup: COUNT(*) used twice = one)
        self._agg_index: Dict[Tuple, int] = {}
        # window (OVER) calls: all items share ONE window spec in v1
        # (the reference plans one OverWindow node per distinct window)
        self.window_calls: List[object] = []      # expr.window.WindowCall
        self.window_partition: Optional[List[int]] = None
        self.window_order: Optional[List[Tuple[int, bool]]] = None

    def _register(self, call: AggCall, key: Tuple,
                  input_expr=None) -> int:
        if key not in self._agg_index:
            self._agg_index[key] = len(self.agg_calls)
            self.agg_calls.append(call)
            self.agg_inputs.append(input_expr)
        return self._agg_index[key]

    def agg_out_type(self, j: int) -> DataType:
        """Output type of registered agg call j — computable at bind
        time from the bound input expression (the executor later
        derives the identical type from the pre-agg schema; both go
        through agg_result_type)."""
        from risingwave_tpu_torch.stream.executors.hash_agg import (
            agg_result_type,
        )
        call, in_expr = self.agg_calls[j], self.agg_inputs[j]
        t = None if in_expr is None else in_expr.return_type
        try:
            return agg_result_type(call.kind, t)
        except TypeError as e:
            raise BindError(str(e))

    # returns (Expression | ("agg", index), ...)
    def bind(self, e: ast.Expr) -> Expression:
        out = self._bind(e)
        if isinstance(out, tuple):
            raise BindError("aggregate not allowed here")
        return out

    def bind_projection(self, e: ast.Expr):
        """Bind a projection item: Expression, ('agg', call_index) or
        ('win', call_index)."""
        if isinstance(e, ast.Over):
            return self._bind_over(e)
        return self._bind(e)

    _WINDOW_KINDS = ("row_number", "rank", "dense_rank", "lag", "lead",
                     "sum", "count", "min", "max", "first_value",
                     "last_value")

    def _bind_over(self, e: ast.Over):
        from risingwave_tpu_torch.expr.window import WindowCall, WindowFuncKind

        if getattr(e.call, "filter_where", None) is not None:
            raise BindError(
                "FILTER (WHERE ...) on window functions is not "
                "supported yet")
        name = e.call.name
        if name == "avg":
            raise BindError("avg() OVER is not supported yet — use "
                            "sum()/count() OVER")
        if name not in self._WINDOW_KINDS:
            raise BindError(f"{name}() is not a window function")
        if e.call.distinct:
            raise BindError(
                f"{name}(DISTINCT ...) OVER is not supported")
        kind = WindowFuncKind(name)

        def col_idx(a: ast.Expr, what: str) -> int:
            b = self.bind(a)
            if not isinstance(b, InputRef):
                raise BindError(
                    f"window {what} must be a plain column (got "
                    f"{a!r})")
            return b.index

        partition = [col_idx(a, "PARTITION BY") for a in e.partition_by]
        order = [(col_idx(a, "ORDER BY"), desc)
                 for a, desc in e.order_by]
        if not order:
            raise BindError("window functions need ORDER BY in OVER()")
        if self.window_partition is None:
            self.window_partition = partition
            self.window_order = order
        elif (self.window_partition != partition
              or self.window_order != order):
            raise BindError(
                "all window functions in one SELECT must share the "
                "same PARTITION BY / ORDER BY (for now)")
        input_idx = None
        offset = 1
        if kind.needs_input:
            if kind == WindowFuncKind.COUNT and (e.call.star
                                                 or not e.call.args):
                input_idx = None             # count(*): counts rows
            else:
                if not e.call.args:
                    raise BindError(f"{name}() OVER needs an argument")
                input_idx = col_idx(e.call.args[0], "argument")
                if kind in (WindowFuncKind.SUM, WindowFuncKind.MIN,
                            WindowFuncKind.MAX):
                    dt = self.scope.schema[input_idx].data_type
                    if not dt.is_device:
                        raise BindError(
                            f"{name}() OVER needs a numeric/time "
                            f"argument (got {dt.name})")
                if kind in (WindowFuncKind.LAG, WindowFuncKind.LEAD) \
                        and len(e.call.args) > 2:
                    raise BindError(
                        f"{name}() default-value argument is not "
                        "supported yet")
                if len(e.call.args) > 1 and kind not in (
                        WindowFuncKind.LAG, WindowFuncKind.LEAD):
                    raise BindError(
                        f"{name}() OVER takes one argument")
                if kind in (WindowFuncKind.LAG, WindowFuncKind.LEAD) \
                        and len(e.call.args) > 1:
                    off = e.call.args[1]
                    try:
                        offset = int(off.value) if (
                            isinstance(off, ast.Lit)
                            and off.kind == "number") else None
                    except ValueError:
                        offset = None
                    if offset is None:
                        raise BindError(
                            f"{name}() offset must be an integer "
                            "literal")
        self.window_calls.append(
            WindowCall(kind, input_idx=input_idx, offset=offset))
        return ("win", len(self.window_calls) - 1)

    def _bind(self, e: ast.Expr):
        if isinstance(e, ast.Lit):
            return _bind_lit(e)
        if isinstance(e, ast.IntervalLit):
            return Literal(Interval(usecs=e.usecs), DataType.INTERVAL)
        if isinstance(e, ast.ColRef):
            idx, dt = self.scope.find(e.name, e.table)
            return InputRef(idx, dt)
        if isinstance(e, ast.Un):
            child = self.bind(e.child)
            return UnaryOp("not" if e.op == "not" else "neg", child)
        if isinstance(e, ast.Bin):
            left, right = self.bind(e.left), self.bind(e.right)
            return BinaryOp(e.op, left, right)
        if isinstance(e, ast.Call):
            return self._bind_call(e)
        if isinstance(e, ast.CastExpr):
            from risingwave_tpu_torch.common.types import DataType as _DT
            from risingwave_tpu_torch.expr.expr import Cast
            try:
                to = _DT.from_sql(e.type_name)
            except KeyError:
                raise BindError(f"unknown type {e.type_name!r}")
            return Cast(self.bind(e.child), to)
        raise BindError(f"unsupported expression {e!r}")

    def _bind_call(self, e: ast.Call):
        if getattr(e, "filter_where", None) is not None:
            e = _rewrite_filter_clause(e)
        name = e.name
        if name == "avg":
            # AVG rewrites to SUM/COUNT at bind time (the reference's
            # logical_agg does the same rewrite in the optimizer)
            if not self.allow_aggs:
                raise BindError("aggregate avg() not allowed here")
            if e.star or not e.args:
                raise BindError("avg(*) is not valid")
            arg = self.bind(e.args[0])
            # avg(DISTINCT x) = sum(DISTINCT x) / count(DISTINCT x):
            # both calls dedup over the same value multiset
            d = e.distinct
            akey = repr(arg)
            sj = self._register(
                AggCall(AggKind.SUM, None, distinct=d),
                ("sum", akey, d), input_expr=arg)
            cj = self._register(
                AggCall(AggKind.COUNT, None, distinct=d),
                ("count", akey, d), input_expr=arg)
            return ("avg", sj, cj)
        if name in ("string_agg", "array_agg"):
            if not self.allow_aggs:
                raise BindError(f"aggregate {name}() not allowed here")
            if e.star or not e.args:
                raise BindError(f"{name}() needs an argument")
            if e.distinct:
                raise BindError(
                    f"{name}(DISTINCT ...) is not supported yet")
            arg = self.bind(e.args[0])
            delimiter = ","
            if name == "string_agg":
                if len(e.args) != 2 or not (
                        isinstance(e.args[1], ast.Lit)
                        and e.args[1].kind == "string"):
                    raise BindError(
                        "string_agg(expr, 'delimiter') needs a string "
                        "literal delimiter")
                delimiter = str(e.args[1].value)
            elif len(e.args) != 1:
                raise BindError("array_agg() takes one argument")
            kind = AggKind.STRING_AGG if name == "string_agg" \
                else AggKind.ARRAY_AGG
            call = AggCall(kind, None, delimiter=delimiter)
            return ("agg", self._register(
                call, (name, repr(arg), delimiter), input_expr=arg))
        if name in _AGG_KINDS:
            if not self.allow_aggs:
                raise BindError(f"aggregate {name}() not allowed here")
            if e.star or not e.args:
                if name != "count":
                    raise BindError(f"{name}(*) is not valid")
                call = AggCall(AggKind.COUNT, None)
                key = ("count_star",)
            else:
                arg = self.bind(e.args[0])
                # MIN/MAX(DISTINCT) ≡ MIN/MAX — drop the flag there
                distinct = e.distinct and name in ("count", "sum")
                call = AggCall(_AGG_KINDS[name], None,
                               distinct=distinct)
                return ("agg", self._register(
                    call, (name, repr(arg), distinct), input_expr=arg))
            return ("agg", self._register(call, key))
        if name in ("tumble_start", "tumble_end"):
            ts = self.bind(e.args[0])
            iv = e.args[1]
            if not isinstance(iv, ast.IntervalLit):
                raise BindError(f"{name} needs an INTERVAL literal")
            mk = tumble_start if name == "tumble_start" else tumble_end
            return mk(ts, Interval(usecs=iv.usecs))
        if name == "case":
            return _bind_case(self.bind, e.args)
        # generic registered scalar function (sig/ analog: name →
        # arity + return type; the expr registry holds the kernel)
        sig = _SCALAR_SIGS.get(name)
        if sig is None:
            raise BindError(f"unknown function {name!r}")
        lo, hi, rt = sig
        if not (lo <= len(e.args) <= hi):
            raise BindError(
                f"{name}() takes {lo}"
                + (f"..{hi}" if hi != lo else "")
                + f" arguments, got {len(e.args)}")
        args = [self.bind(a) for a in e.args]
        _check_scalar_args(name, e.args, args)
        return FuncCall(name, args, rt)


def _bind_case(bind, args_ast):
    """CASE binding with NULL-branch unification: a bare NULL branch
    (incl. the implicit ELSE NULL) adopts the case's value type — a
    raw NULL literal binds INT64 and would fail Case's same-type
    invariant for varchar/decimal branches."""
    from risingwave_tpu_torch.expr.expr import Case, Literal

    args = [bind(a) for a in args_ast]
    whens = list(zip(args[:-1:2], args[1:-1:2]))
    else_ = args[-1]
    vals = [v for _c, v in whens] + [else_]
    vt = next((v.return_type for v in vals
               if not (isinstance(v, Literal) and v.value is None)),
              None)
    if vt is not None:
        def unify(v):
            if isinstance(v, Literal) and v.value is None \
                    and v.return_type != vt:
                return Literal(None, vt)
            return v
        whens = [(c, unify(v)) for c, v in whens]
        else_ = unify(else_)
    return Case(whens, else_)


def _rewrite_filter_clause(e):
    """Aggregate FILTER (WHERE c) → CASE rewrite (pg semantics:
    count(*) counts matches; sum/min/max/avg see NULL for
    non-matches, so empty matches yield NULL — except count, 0)."""
    fw = e.filter_where
    if e.name == "count" and (e.star or not e.args):
        return ast.Call("sum", [ast.Call(
            "case", [fw, ast.Lit(1, "number"), ast.Lit(0, "number")])])
    if e.name in ("sum", "min", "max", "avg") and e.args \
            and not e.distinct:
        return ast.Call(e.name, [ast.Call(
            "case", [fw, e.args[0], ast.Lit(None, "null")])])
    raise BindError(
        "FILTER (WHERE ...) is supported for count(*)/sum/min/max/avg"
        " (without DISTINCT)")


# scalar signatures: name → (min args, max args, return type)
_SCALAR_SIGS = {
    "lower": (1, 1, DataType.VARCHAR),
    "upper": (1, 1, DataType.VARCHAR),
    "char_length": (1, 1, DataType.INT64),
    "length": (1, 1, DataType.INT64),
    "substr": (2, 3, DataType.VARCHAR),
    "split_part": (3, 3, DataType.VARCHAR),
    "replace": (3, 3, DataType.VARCHAR),
    "concat": (1, 64, DataType.VARCHAR),
    "to_char": (2, 2, DataType.VARCHAR),
    "date_part": (2, 2, DataType.INT64),
    "date_trunc": (2, 2, DataType.TIMESTAMP),
    "extract_epoch": (1, 1, DataType.DECIMAL),
}

_DATE_FIELDS = {"second", "minute", "hour", "year", "month", "day"}
_TRUNC_FIELDS = {"second", "minute", "hour", "day"}


# argument positions the kernels treat as SCALARS (evaluated once for
# the whole chunk) — they must be constants, or row 0's value would
# silently apply to every row
_CONST_ARG_POSITIONS = {
    "substr": (1, 2), "split_part": (1, 2), "replace": (1, 2),
    "to_char": (1,), "date_part": (0,), "date_trunc": (0,),
}


def _check_scalar_args(name, raw_args, bound) -> None:
    """Bind-time validation: scalar-treated argument positions must be
    literals, and a bad field name or position must fail the
    statement, not crash-loop the deployed actor at eval time."""
    from risingwave_tpu_torch.expr.expr import Literal

    for i in _CONST_ARG_POSITIONS.get(name, ()):
        if i < len(bound) and not isinstance(bound[i], Literal):
            raise BindError(
                f"{name}() argument {i + 1} must be a constant")

    def lit_of(i):
        b = bound[i]
        return b.value if isinstance(b, Literal) else None

    if name in ("date_part", "date_trunc"):
        f = lit_of(0)
        if f is not None:
            allowed = _DATE_FIELDS if name == "date_part" \
                else _TRUNC_FIELDS
            if str(f).lower() not in allowed:
                raise BindError(
                    f"{name} field {f!r} unsupported (one of "
                    f"{sorted(allowed)})")
    if name == "split_part":
        k = lit_of(2)
        if k is not None and int(k) == 0:
            raise BindError("split_part position must not be zero")


def _bind_lit(e: ast.Lit) -> Literal:
    if e.kind == "number":
        text = str(e.value)
        if "." in text:
            return lit(text, DataType.DECIMAL)
        return lit(int(text), DataType.INT64)
    if e.kind == "string":
        return lit(str(e.value), DataType.VARCHAR)
    if e.kind == "bool":
        return lit(bool(e.value), DataType.BOOLEAN)
    return Literal(None, DataType.INT64)       # bare NULL


_AGG_NAMES = set(_AGG_KINDS) | {"avg", "string_agg", "array_agg"}


def contains_agg(e: ast.Expr) -> bool:
    """AST walk: does the expression contain an aggregate call?
    OVER windows are opaque (their calls are window functions)."""
    if isinstance(e, ast.Over):
        return False
    if isinstance(e, ast.Call):
        return e.name in _AGG_NAMES or any(contains_agg(a)
                                           for a in e.args)
    if isinstance(e, ast.Bin):
        return contains_agg(e.left) or contains_agg(e.right)
    if isinstance(e, ast.Un):
        return contains_agg(e.child)
    if isinstance(e, ast.CastExpr):
        return contains_agg(e.child)
    return False


def contains_colref(e: ast.Expr) -> bool:
    if isinstance(e, ast.ColRef):
        return True
    if isinstance(e, ast.Over):
        return True
    if isinstance(e, ast.Call):
        return any(contains_colref(a) for a in e.args)
    if isinstance(e, ast.Bin):
        return contains_colref(e.left) or contains_colref(e.right)
    if isinstance(e, ast.Un):
        return contains_colref(e.child)
    if isinstance(e, ast.CastExpr):
        return contains_colref(e.child)
    return False


class PostAggBinder:
    """Binds a post-aggregation expression (SELECT item or HAVING)
    into an Expression over the agg OUTPUT row: group-expression
    matches become column refs 0..g-1, aggregate calls become refs
    g+j, and scalar operators recurse (the reference folds this into
    LogicalAgg planning, logical_agg.rs rewrite_with_agg_calls).

    Registers agg calls on the shared `binder` as it goes — run every
    post-agg bind BEFORE constructing the HashAggExecutor."""

    def __init__(self, binder: Binder, group_reprs: List[str]):
        self.binder = binder
        self.group_reprs = group_reprs
        self.g = len(group_reprs)

    def bind(self, e: ast.Expr):
        from risingwave_tpu_torch.expr.expr import Cast
        # aggregate call at this node → agg output column(s)
        if isinstance(e, ast.Call) and e.name in _AGG_NAMES:
            b = self.binder._bind_call(e)
            if isinstance(b, tuple) and b[0] == "agg":
                j = b[1]
                return InputRef(self.g + j, self.binder.agg_out_type(j))
            if isinstance(b, tuple) and b[0] == "avg":
                _tag, sj, cj = b
                s = Cast(InputRef(self.g + sj,
                                  self.binder.agg_out_type(sj)),
                         DataType.FLOAT64)
                c = Cast(InputRef(self.g + cj,
                                  self.binder.agg_out_type(cj)),
                         DataType.FLOAT64)
                return BinaryOp("/", s, c)
            return b
        # whole expression matches a GROUP BY expression → group col
        try:
            plain = Binder(self.binder.scope).bind(e)
        except BindError:
            plain = None
        if plain is not None:
            r = repr(plain)
            if r in self.group_reprs:
                i = self.group_reprs.index(r)
                return InputRef(i, plain.return_type)
            if not contains_colref(e):
                return plain           # constant — valid anywhere
        # recurse: some subtree must be grouped or aggregated
        if isinstance(e, ast.Bin):
            return BinaryOp(e.op, self.bind(e.left), self.bind(e.right))
        if isinstance(e, ast.Un):
            return UnaryOp("not" if e.op == "not" else "neg",
                           self.bind(e.child))
        if isinstance(e, ast.CastExpr):
            from risingwave_tpu_torch.expr.expr import Cast
            try:
                to = DataType.from_sql(e.type_name)
            except KeyError:
                raise BindError(f"unknown type {e.type_name!r}")
            return Cast(self.bind(e.child), to)
        if isinstance(e, ast.Call):
            if getattr(e, "filter_where", None) is not None:
                # anything reaching here is NOT an aggregate (those
                # bound through the whole-expression pass) — pg:
                # "FILTER specified, but <fn> is not an aggregate"
                raise BindError(
                    f"FILTER specified, but {e.name}() is not an "
                    "aggregate function")
            if e.name == "case":
                return _bind_case(self.bind, e.args)
            sig = _SCALAR_SIGS.get(e.name)
            if sig is None:
                raise BindError(f"unknown function {e.name!r}")
            args = [self.bind(a) for a in e.args]
            _check_scalar_args(e.name, e.args, args)
            return FuncCall(e.name, args, sig[2])
        raise BindError(
            f"expression {e!r} is neither grouped nor aggregated")


def expr_name(e: ast.Expr, fallback: str) -> str:
    """Default output column name (pg-ish)."""
    if isinstance(e, ast.ColRef):
        return e.name
    if isinstance(e, ast.Call):
        return e.name
    return fallback
