"""Hand-written recursive-descent SQL parser.

Reference parity: src/sqlparser/src/parser.rs:157 — same architecture
(tokenizer + recursive descent with precedence climbing), original
implementation scoped to the supported statement surface. Streaming
extensions: TUMBLE(...) table function, INTERVAL literals.

Copied from ``risingwave_tpu/frontend/parser.py`` unchanged but for
its imports (pure Python: the port keeps its own copy).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from risingwave_tpu_torch.frontend import ast

_TOKEN_RE = re.compile(r"""
      (?P<ws>\s+)
    | (?P<comment>--[^\n]*)
    | (?P<number>\d+(?:\.\d+)?)
    | (?P<string>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op><>|<=|>=|!=|\|\||[+\-*/%(),.;=<>])
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit", "offset",
    "as", "and", "or", "not", "join", "inner", "on", "create", "drop",
    "show", "materialized", "view", "views", "source", "sources", "table",
    "tables", "with", "interval", "tumble", "hop", "asc", "desc",
    "null", "true",
    "false", "if", "exists", "flush", "second", "seconds", "minute",
    "minutes", "hour", "hours", "day", "days", "millisecond",
    "milliseconds", "case", "when", "then", "else", "end", "cast",
    "sink", "sinks", "left", "right", "full", "outer", "distinct",
    "explain", "over", "partition", "alter", "set", "parallelism",
    "for", "emit", "window", "close", "insert", "into", "values",
    "delete", "update", "primary", "key", "having", "between",
}

# keywords that can never start a primary expression (a column named
# "second" still works: non-reserved keywords fall through to idents)
RESERVED = {
    "select", "from", "where", "group", "by", "order", "limit", "offset",
    "as", "and", "or", "not", "join", "inner", "on", "create", "drop",
    "when", "then", "else", "end", "with", "having",
}

_INTERVAL_UNITS = {
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
    "millisecond": 1_000, "milliseconds": 1_000,
}


class ParseError(ValueError):
    pass


class Tokenizer:
    def __init__(self, sql: str):
        self.tokens: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(sql):
            m = _TOKEN_RE.match(sql, pos)
            if not m:
                raise ParseError(f"bad character at {sql[pos:pos+10]!r}")
            pos = m.end()
            kind = m.lastgroup
            if kind in ("ws", "comment"):
                continue
            text = m.group()
            if kind == "ident" and text.lower() in KEYWORDS:
                self.tokens.append(("kw", text.lower()))
            else:
                self.tokens.append((kind, text))


class Parser:
    """One statement per parse() call; `;` tolerated."""

    def __init__(self, sql: str):
        self.toks = Tokenizer(sql).tokens
        self.i = 0

    # -- token helpers ---------------------------------------------------
    def _peek(self, k: int = 0) -> Tuple[str, str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("eof", "")

    def _next(self) -> Tuple[str, str]:
        t = self._peek()
        self.i += 1
        return t

    def _kw(self, *words: str) -> bool:
        """Consume keywords if they match (lookahead, all-or-nothing)."""
        for k, w in enumerate(words):
            kind, text = self._peek(k)
            if kind != "kw" or text != w:
                return False
        self.i += len(words)
        return True

    def _expect_kw(self, *words: str) -> None:
        if not self._kw(*words):
            raise ParseError(
                f"expected {' '.join(words).upper()} at {self._peek()}")

    def _expect_op(self, op: str) -> None:
        kind, text = self._next()
        if kind != "op" or text != op:
            raise ParseError(f"expected {op!r}, got {text!r}")

    def _op(self, op: str) -> bool:
        kind, text = self._peek()
        if kind == "op" and text == op:
            self.i += 1
            return True
        return False

    def _ident(self) -> str:
        kind, text = self._next()
        if kind == "ident":
            return text.lower()
        if kind == "kw":          # non-reserved use of a keyword
            return text
        raise ParseError(f"expected identifier, got {text!r}")

    def _string(self) -> str:
        kind, text = self._next()
        if kind != "string":
            raise ParseError(f"expected string literal, got {text!r}")
        return text[1:-1].replace("''", "'")

    # -- entry -----------------------------------------------------------
    def parse(self):
        stmt = self._statement()
        self._op(";")
        if self._peek()[0] != "eof":
            raise ParseError(f"trailing tokens at {self._peek()}")
        return stmt

    def _statement(self):
        if self._kw("alter", "materialized", "view"):
            name = self._ident()
            self._expect_kw("set")
            self._expect_kw("parallelism")
            self._expect_op("=")
            kind, text = self._next()
            if kind != "number" or int(text) < 1:
                raise ParseError(
                    f"PARALLELISM must be a positive integer, "
                    f"got {text!r}")
            return ast.AlterParallelism(name, int(text))
        if self._kw("create", "source"):
            return self._create_source()
        if self._kw("create", "table"):
            return self._create_table()
        if self._kw("drop", "table"):
            if_exists = self._kw("if", "exists")
            return ast.DropTable(self._ident(), if_exists)
        if self._kw("insert"):
            self._expect_kw("into")
            name = self._ident()
            if self._peek() == ("kw", "select"):
                return ast.Insert(name, [], select=self._select())
            self._expect_kw("values")
            rows = []
            while True:
                self._expect_op("(")
                row = [self._expr()]
                while self._op(","):
                    row.append(self._expr())
                self._expect_op(")")
                rows.append(row)
                if not self._op(","):
                    break
            return ast.Insert(name, rows)
        if self._kw("delete"):
            self._expect_kw("from")
            name = self._ident()
            where = self._expr() if self._kw("where") else None
            return ast.Delete(name, where)
        if self._kw("update"):
            name = self._ident()
            self._expect_kw("set")
            sets = []
            while True:
                col = self._ident()
                self._expect_op("=")
                sets.append((col, self._expr()))
                if not self._op(","):
                    break
            where = self._expr() if self._kw("where") else None
            return ast.Update(name, sets, where)
        if self._kw("create", "materialized", "view"):
            name = self._ident()
            self._expect_kw("as")
            sel = self._select()
            eowc = False
            if self._kw("emit"):
                self._expect_kw("on")
                self._expect_kw("window")
                self._expect_kw("close")
                eowc = True
            return ast.CreateMaterializedView(
                name, sel, emit_on_window_close=eowc)
        if self._kw("create", "sink"):
            name = self._ident()
            from_mv = None
            append_only = None
            if self._kw("from"):
                # CREATE SINK s FROM mv [AS APPEND-ONLY] WITH (...) —
                # sugar for SELECT * FROM mv; the MV name is kept so
                # the planner can derive the mode from the MV's own
                # append-only proof
                from_mv = self._ident()
                sel = ast.Select(
                    projections=[(ast.ColRef("*"), None)],
                    from_item=ast.TableRef(from_mv))
                if self._kw("as"):
                    # "append"/"only" are plain idents; the hyphen in
                    # APPEND-ONLY is an op token (APPEND ONLY also
                    # accepted)
                    kind, text = self._next()
                    if kind != "ident" or text.lower() != "append":
                        raise ParseError(
                            f"expected APPEND-ONLY, got {text!r}")
                    self._op("-")
                    kind, text = self._next()
                    if kind != "ident" or text.lower() != "only":
                        raise ParseError(
                            f"expected APPEND-ONLY, got {text!r}")
                    append_only = True
            else:
                self._expect_kw("as")
                sel = self._select()
            self._expect_kw("with")
            self._expect_op("(")
            options = {}
            while True:
                key = self._ident()
                while self._op("."):
                    key += "." + self._ident()
                self._expect_op("=")
                kind, _text = self._peek()
                options[key] = (self._string() if kind == "string"
                                else self._next()[1])
                if not self._op(","):
                    break
            self._expect_op(")")
            return ast.CreateSink(name, sel, options,
                                  from_mv=from_mv,
                                  append_only=append_only)
        if self._kw("drop", "sink"):
            if_exists = self._kw("if", "exists")
            return ast.DropSink(self._ident(), if_exists)
        if self._kw("drop", "materialized", "view"):
            if_exists = self._kw("if", "exists")
            return ast.DropMaterializedView(self._ident(), if_exists)
        if self._kw("drop", "source"):
            if_exists = self._kw("if", "exists")
            return ast.DropSource(self._ident(), if_exists)
        if self._kw("show", "tables"):
            return ast.Show("tables")
        if self._kw("show", "materialized", "views"):
            return ast.Show("materialized views")
        if self._kw("show", "sources"):
            return ast.Show("sources")
        if self._kw("show", "sinks"):
            return ast.Show("sinks")
        if self._kw("show"):
            # SHOW <session variable> ("all" is an ident — SHOW ALL
            # arrives as var:all and lists every variable)
            return ast.Show("var:" + self._ident())
        if self._kw("set"):
            name = self._ident()
            if not self._op("="):
                kind, text = self._next()
                if not (kind in ("kw", "ident")
                        and text.lower() == "to"):
                    raise ParseError(
                        f"expected = or TO after SET, got {text!r}")
            kind, text = self._next()
            if kind == "number":
                value = int(text) if "." not in text else float(text)
            elif kind == "string":
                # string tokens are quote-delimited with '' escapes
                # (same rule as _string())
                value = text[1:-1].replace("''", "'")
            elif kind in ("kw", "ident"):
                low = text.lower()
                value = {"true": True, "false": False,
                         "on": True, "off": False,
                         "default": None}.get(low, text)
            else:
                raise ParseError(f"bad SET value {text!r}")
            return ast.SetVar(name.lower(), value)
        if self._kw("flush"):
            return ast.Flush()
        if self._kw("explain"):
            return ast.Explain(self._select())
        if self._peek() == ("kw", "select"):
            return self._select()
        raise ParseError(f"unsupported statement at {self._peek()}")

    def _create_table(self) -> ast.CreateTable:
        name = self._ident()
        self._expect_op("(")
        columns, pk_cols = [], []
        while True:
            col = self._ident()
            words = [self._next()[1].lower()]
            while self._peek()[0] in ("ident", "kw") and \
                    self._peek()[1].lower() in (
                        "with", "time", "zone", "precision",
                        "varying"):
                words.append(self._next()[1].lower())
            columns.append((col, " ".join(words)))
            if self._kw("primary"):
                self._expect_kw("key")
                pk_cols.append(col)
            if not self._op(","):
                break
        self._expect_op(")")
        return ast.CreateTable(name, columns, pk_cols)

    def _create_source(self) -> ast.CreateSource:
        name = self._ident()
        columns = None
        if self._op("("):
            # explicit schema: (col type, ...) — external connectors
            # cannot infer one (the generators carry fixed schemas)
            columns = []
            while True:
                col = self._ident()
                words = [self._next()[1].lower()]
                while self._peek()[0] in ("ident", "kw") and \
                        self._peek()[1].lower() in (
                            "with", "time", "zone", "precision",
                            "varying"):
                    words.append(self._next()[1].lower())
                columns.append((col, " ".join(words)))
                if not self._op(","):
                    break
            self._expect_op(")")
        self._expect_kw("with")
        self._expect_op("(")
        options = {}
        while True:
            key = self._ident()
            while self._op("."):
                key += "." + self._ident()
            self._expect_op("=")
            kind, text = self._peek()
            if kind == "string":
                options[key] = self._string()
            elif kind == "number":
                options[key] = self._next()[1]
            else:
                raise ParseError(f"bad WITH value {text!r}")
            if not self._op(","):
                break
        self._expect_op(")")
        return ast.CreateSource(name, options, columns=columns)

    # -- SELECT ----------------------------------------------------------
    def _select(self) -> ast.Select:
        self._expect_kw("select")
        projections = [self._projection()]
        while self._op(","):
            projections.append(self._projection())
        from_item = None
        joins: List[ast.Join] = []
        if self._kw("from"):
            from_item = self._from_item()
            while True:
                kind = None
                if self._kw("join") or self._kw("inner", "join"):
                    kind = "inner"
                else:
                    for k in ("left", "right", "full"):
                        if self._kw(k, "outer", "join") \
                                or self._kw(k, "join"):
                            kind = k
                            break
                if kind is None:
                    break
                item = self._from_item()
                temporal = False
                if self._kw("for"):
                    # FOR SYSTEM_TIME AS OF PROCTIME()
                    if self._ident().lower() != "system_time":
                        raise ParseError(
                            "expected SYSTEM_TIME after FOR")
                    self._expect_kw("as")
                    if self._ident().lower() != "of":
                        raise ParseError("expected OF after AS")
                    if self._ident().lower() != "proctime":
                        raise ParseError(
                            "only AS OF PROCTIME() is supported")
                    self._expect_op("(")
                    self._expect_op(")")
                    temporal = True
                self._expect_kw("on")
                joins.append(ast.Join(item, self._expr(), kind,
                                      temporal=temporal))
        where = self._expr() if self._kw("where") else None
        group_by: List[ast.Expr] = []
        if self._kw("group", "by"):
            group_by.append(self._expr())
            while self._op(","):
                group_by.append(self._expr())
        having = self._expr() if self._kw("having") else None
        order_by: List[Tuple[ast.Expr, bool]] = []
        if self._kw("order", "by"):
            while True:
                e = self._expr()
                desc = bool(self._kw("desc"))
                if not desc:
                    self._kw("asc")
                order_by.append((e, desc))
                if not self._op(","):
                    break
        limit = offset = None
        if self._kw("limit"):
            limit = int(self._next()[1])
        if self._kw("offset"):
            offset = int(self._next()[1])
        return ast.Select(projections, from_item, joins, where, group_by,
                          order_by, limit, offset, having=having)

    def _projection(self) -> Tuple[ast.Expr, Optional[str]]:
        if self._op("*"):
            return (ast.ColRef("*"), None)
        e = self._expr()
        alias = None
        if self._kw("as"):
            alias = self._ident()
        elif self._peek()[0] == "ident":
            alias = self._ident()
        return (e, alias)

    def _from_item(self):
        if self._peek() == ("op", "(") and \
                self._peek(1) == ("kw", "select"):
            # derived table: FROM (SELECT ...) alias
            self._expect_op("(")
            sel = self._select()
            self._expect_op(")")
            if self._kw("as"):
                alias = self._ident()
            elif self._peek()[0] == "ident":
                alias = self._ident()
            else:
                raise ParseError(
                    "subquery in FROM must have an alias")
            return ast.Subquery(sel, alias)
        if self._kw("tumble"):
            self._expect_op("(")
            table = ast.TableRef(self._ident())
            self._expect_op(",")
            time_col = self._ident()
            self._expect_op(",")
            iv = self._expr()
            if not isinstance(iv, ast.IntervalLit):
                raise ParseError("TUMBLE needs an INTERVAL literal")
            self._expect_op(")")
            alias = self._ident() if self._kw("as") else None
            return ast.Tumble(table, time_col, iv.usecs, alias)
        if self._kw("hop"):
            self._expect_op("(")
            table = ast.TableRef(self._ident())
            self._expect_op(",")
            time_col = self._ident()
            self._expect_op(",")
            slide = self._expr()
            self._expect_op(",")
            size = self._expr()
            if not (isinstance(slide, ast.IntervalLit)
                    and isinstance(size, ast.IntervalLit)):
                raise ParseError("HOP needs two INTERVAL literals")
            self._expect_op(")")
            alias = self._ident() if self._kw("as") else None
            return ast.Hop(table, time_col, slide.usecs, size.usecs,
                           alias)
        name = self._ident()
        if self._op("("):
            # FROM-clause table function: generate_series(a, b [, s])
            args = []
            if not self._op(")"):
                args.append(self._expr())
                while self._op(","):
                    args.append(self._expr())
                self._expect_op(")")
            fn_alias = self._ident() if self._kw("as") else None
            return ast.TableFn(name.lower(), args, fn_alias)
        alias = None
        if self._kw("as"):
            alias = self._ident()
        elif self._peek()[0] == "ident":
            alias = self._ident()
        return ast.TableRef(name, alias)

    # -- expressions (precedence climbing) -------------------------------
    def _expr(self) -> ast.Expr:
        return self._or_expr()

    def _or_expr(self) -> ast.Expr:
        e = self._and_expr()
        while self._kw("or"):
            e = ast.Bin("or", e, self._and_expr())
        return e

    def _and_expr(self) -> ast.Expr:
        e = self._not_expr()
        while self._kw("and"):
            e = ast.Bin("and", e, self._not_expr())
        return e

    def _not_expr(self) -> ast.Expr:
        if self._kw("not"):
            return ast.Un("not", self._not_expr())
        return self._cmp_expr()

    _CMP = {"=", "<>", "!=", "<", "<=", ">", ">="}

    def _cmp_expr(self) -> ast.Expr:
        e = self._add_expr()
        if self._kw("between"):
            # e BETWEEN lo AND hi ⇒ e >= lo AND e <= hi
            lo = self._add_expr()
            self._expect_kw("and")
            hi = self._add_expr()
            return ast.Bin("and", ast.Bin(">=", e, lo),
                           ast.Bin("<=", e, hi))
        kind, text = self._peek()
        if kind == "op" and text in self._CMP:
            self.i += 1
            op = "<>" if text == "!=" else text
            return ast.Bin(op, e, self._add_expr())
        return e

    def _add_expr(self) -> ast.Expr:
        e = self._mul_expr()
        while True:
            if self._op("+"):
                e = ast.Bin("+", e, self._mul_expr())
            elif self._op("-"):
                e = ast.Bin("-", e, self._mul_expr())
            elif self._op("||"):
                e = ast.Bin("||", e, self._mul_expr())
            else:
                return e

    def _mul_expr(self) -> ast.Expr:
        e = self._unary_expr()
        while True:
            if self._op("*"):
                e = ast.Bin("*", e, self._unary_expr())
            elif self._op("/"):
                e = ast.Bin("/", e, self._unary_expr())
            elif self._op("%"):
                e = ast.Bin("%", e, self._unary_expr())
            else:
                return e

    def _unary_expr(self) -> ast.Expr:
        if self._op("-"):
            return ast.Un("neg", self._unary_expr())
        return self._primary()

    def _primary(self) -> ast.Expr:
        kind, text = self._peek()
        if kind == "number":
            self.i += 1
            return ast.Lit(text, "number")
        if kind == "string":
            return ast.Lit(self._string(), "string")
        if self._kw("null"):
            return ast.Lit(None, "null")
        if self._kw("true"):
            return ast.Lit(True, "bool")
        if self._kw("false"):
            return ast.Lit(False, "bool")
        if self._kw("interval"):
            text = self._string()
            n = int(text.strip())
            unit = self._next()[1].lower()
            if unit not in _INTERVAL_UNITS:
                raise ParseError(f"bad interval unit {unit!r}")
            return ast.IntervalLit(n * _INTERVAL_UNITS[unit])
        if self._kw("case"):
            return self._case()
        if self._kw("cast"):
            self._expect_op("(")
            e = self._expr()
            self._expect_kw("as")
            words = [self._next()[1].lower()]
            # multi-word type names (timestamp with time zone, etc.)
            while self._peek()[0] in ("ident", "kw") and \
                    self._peek()[1].lower() in ("with", "time", "zone",
                                                "precision", "varying"):
                words.append(self._next()[1].lower())
            self._expect_op(")")
            return ast.CastExpr(e, " ".join(words))
        if self._op("("):
            e = self._expr()
            self._expect_op(")")
            return e
        if kind == "kw" and text in RESERVED:
            raise ParseError(f"unexpected keyword {text!r}")
        if kind in ("ident", "kw"):
            name = self._ident()
            if self._op("("):           # function call
                if self._op("*"):
                    self._expect_op(")")
                    call = ast.Call(name.lower(), [], star=True)
                else:
                    distinct = self._kw("distinct")
                    args = []
                    if not self._op(")"):
                        args.append(self._expr())
                        while self._op(","):
                            args.append(self._expr())
                        self._expect_op(")")
                    call = ast.Call(name.lower(), args,
                                    distinct=distinct)
                nk, nt = self._peek()
                if nk in ("ident", "kw") and nt.lower() == "filter":
                    self._next()
                    self._expect_op("(")
                    self._expect_kw("where")
                    call.filter_where = self._expr()
                    self._expect_op(")")
                if self._kw("over"):
                    return self._over(call)
                return call
            if self._op("."):
                col = self._ident()
                return ast.ColRef(col, table=name)
            return ast.ColRef(name)
        raise ParseError(f"unexpected token {text!r}")

    def _over(self, call: ast.Call) -> ast.Expr:
        """OVER ( [PARTITION BY e, ...] [ORDER BY e [ASC|DESC], ...] )
        — explicit frame clauses are not supported yet."""
        self._expect_op("(")
        partition: list = []
        order: list = []
        if self._kw("partition"):
            self._expect_kw("by")
            partition.append(self._expr())
            while self._op(","):
                partition.append(self._expr())
        if self._kw("order"):
            self._expect_kw("by")
            while True:
                e = self._expr()
                desc = False
                if self._kw("desc"):
                    desc = True
                else:
                    self._kw("asc")
                order.append((e, desc))
                if not self._op(","):
                    break
        self._expect_op(")")
        return ast.Over(call, partition, order)

    def _case(self) -> ast.Expr:
        whens = []
        while self._kw("when"):
            cond = self._expr()
            self._expect_kw("then")
            whens.append((cond, self._expr()))
        else_ = self._expr() if self._kw("else") else ast.Lit(None, "null")
        self._expect_kw("end")
        # represented as nested Call for binder simplicity
        return ast.Call("case", [c for w in whens for c in w] + [else_])


def parse(sql: str):
    return Parser(sql).parse()


def parse_many(sql: str) -> list:
    """Split on top-level ';' → [(statement text, parsed stmt)].

    The text rides along so callers (the session's DDL log) can persist
    exactly what was executed.
    """
    out = []
    for part in _split_statements(sql):
        if part.strip():
            out.append((part.strip(), parse(part)))
    return out


def _split_statements(sql: str) -> List[str]:
    parts, cur, in_str = [], [], False
    i = 0
    while i < len(sql):
        c = sql[i]
        if in_str:
            cur.append(c)
            if c == "'":
                in_str = False
        elif c == "'":
            in_str = True
            cur.append(c)
        elif c == ";":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts
