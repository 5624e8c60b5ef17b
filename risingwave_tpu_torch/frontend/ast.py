"""SQL AST nodes (sqlparser-rs analog, scaled to the supported surface).

Copied from ``risingwave_tpu/frontend/ast.py`` unchanged (pure
Python: the port keeps its own copy rather than import the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


# -- expressions ---------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Lit(Expr):
    value: object            # int | float-string | str | bool | None
    kind: str                # "number" | "string" | "bool" | "null"


@dataclass
class IntervalLit(Expr):
    usecs: int


@dataclass
class ColRef(Expr):
    name: str
    table: Optional[str] = None


@dataclass
class Bin(Expr):
    op: str
    left: Expr
    right: Expr


@dataclass
class Un(Expr):
    op: str                  # "not" | "neg"
    child: Expr


@dataclass
class Call(Expr):
    name: str                # lowercased
    args: List[Expr]
    star: bool = False       # count(*)
    distinct: bool = False   # count(DISTINCT x) etc.
    # aggregate FILTER (WHERE cond) clause (pg); bound as a CASE
    # rewrite in the binder
    filter_where: object = None


@dataclass
class CastExpr(Expr):
    child: Expr
    type_name: str           # lowercased SQL type name


@dataclass
class Over(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ...)."""

    call: Call
    partition_by: List[Expr]
    order_by: List[Tuple[Expr, bool]]    # (expr, desc)


@dataclass
class Explain:
    select: "Select"


# -- statements ----------------------------------------------------------


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class Tumble:
    """TUMBLE(source, time_col, INTERVAL ...) — streaming window source."""

    table: TableRef
    time_col: str
    window_usecs: int
    alias: Optional[str] = None


@dataclass
class Hop:
    """HOP(source, time_col, INTERVAL slide, INTERVAL size)."""

    table: TableRef
    time_col: str
    slide_usecs: int
    size_usecs: int
    alias: Optional[str] = None


@dataclass
class TableFn:
    """FROM-clause table function: generate_series(...) etc."""

    name: str
    args: List[Expr]
    alias: Optional[str] = None


@dataclass
class Subquery:
    """Derived table: FROM (SELECT ...) alias."""

    select: "Select"
    alias: str


FromItem = object            # TableRef | Tumble | Hop | TableFn | Subquery


@dataclass
class Join:
    item: FromItem
    on: Expr
    kind: str = "inner"   # inner|left|right|full (OUTER implied)
    # JOIN ... FOR SYSTEM_TIME AS OF PROCTIME(): probe the right side
    # as a versioned table at process time (temporal join)
    temporal: bool = False


@dataclass
class Select:
    projections: List[Tuple[Expr, Optional[str]]]   # (expr, alias)
    from_item: Optional[FromItem]
    joins: List[Join] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    having: Optional[Expr] = None


@dataclass
class CreateSource:
    name: str
    options: Dict[str, str]            # WITH (connector='nexmark', ...)
    # explicit (col_name, sql_type) list for external connectors
    columns: Optional[List[Tuple[str, str]]] = None


@dataclass
class CreateMaterializedView:
    name: str
    select: Select
    # EMIT ON WINDOW CLOSE: results emit once, when the watermark
    # passes the window column (default: emit-on-update changelog)
    emit_on_window_close: bool = False


@dataclass
class CreateSink:
    name: str
    select: Select
    options: Dict[str, str]
    # CREATE SINK ... FROM <mv> sugar: the select above is the
    # synthesized SELECT * FROM <mv>; the name is kept for catalog
    # dependency tracking and mode derivation off the MV's own
    # append-only proof
    from_mv: Optional[str] = None
    # AS APPEND-ONLY asserted by the user: the planner must PROVE the
    # input append-only or refuse (force='true' in options overrides —
    # retractions then fail loudly at the sink, never silently drop).
    # None = derive the mode automatically
    append_only: Optional[bool] = None


@dataclass
class DropSink:
    name: str
    if_exists: bool = False


@dataclass
class DropMaterializedView:
    name: str
    if_exists: bool = False


@dataclass
class DropSource:
    name: str
    if_exists: bool = False


@dataclass
class AlterParallelism:
    """ALTER MATERIALIZED VIEW name SET PARALLELISM = n."""

    name: str
    parallelism: int


@dataclass
class CreateTable:
    name: str
    columns: List[Tuple[str, str]]     # (col_name, sql type)
    pk_cols: List[str]                 # PRIMARY KEY columns ([] = none)


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class Insert:
    table: str
    rows: List[List["Expr"]]           # VALUES rows (expressions)
    select: Optional[Select] = None    # INSERT INTO t SELECT ...


@dataclass
class Delete:
    table: str
    where: Optional["Expr"] = None


@dataclass
class Update:
    table: str
    sets: List[Tuple[str, "Expr"]]     # SET col = expr
    where: Optional["Expr"] = None


@dataclass
class Show:
    what: str    # "tables" | "materialized views" | "sources" |
    #              "sinks" | "all" (session vars) | "var:<name>"


@dataclass
class SetVar:
    """SET <name> = <value> — session configuration
    (src/common/src/session_config/ analog)."""

    name: str
    value: object


@dataclass
class Flush:
    pass
