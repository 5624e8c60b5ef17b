"""Random fused runs for holding the expression program to its oracles.

``chip_smoke.py`` holds ``csrc/fused.cu`` to the plain version on the
card with these, and the CPU tests hold the plain version to the
reference's traced functions and to the numpy ``chain_body``. A case is a
neutral description (nested tuples), so the same tree can be built from
the port's expression classes or from the reference's (``build`` takes
the module): every opcode of the program appears, over every device
type, on chunks with NULLs, U-/U+ pairs, invisible rows and — with
``edges`` — the values where semantics are easy to get wrong: INT64_MIN
and the int16/int32 limits (wrap), negative timestamps and operands
(floor division and modulo), zero divisors (NULL), NaN, ±inf, -0.0 and
out-of-range floats (saturating casts).

``EDGE_CASES`` are the shapes at the edges of ``csrc/fused.cu``'s tiles
(32, 64 or 128 rows in a ring, with K + 1 halo rows each side): four
predicates (the widest halo), 32 outputs, U-/U+ pairs and noop pairs
straddling every tile edge and the ring's wrap, hop expansion whose
copies cross tile edges, ``seg`` rings shorter and longer than a tile, one
row, and a row count that is no multiple of the tile. Each has a CPU size
and a larger card size that reaches the 64- and 128-row tiles.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

# the case schema: one column per device type, plus a host column
COLS = [("b", "BOOLEAN"), ("s", "INT16"), ("i", "INT32"), ("l", "INT64"),
        ("f", "FLOAT32"), ("d", "FLOAT64"), ("m", "DECIMAL"),
        ("t", "TIMESTAMP"), ("v", "VARCHAR")]
_NUM = ["INT16", "INT32", "INT64", "DECIMAL", "FLOAT32", "FLOAT64"]
_INT = ["INT16", "INT32", "INT64"]
_FLOAT = ["FLOAT32", "FLOAT64"]
_CMP = ["=", "<>", "<", "<=", ">", ">="]
_TYPED = {name: i for i, (_n, name) in enumerate(COLS[:-1])}


class _Gen:
    """Typed random expression descriptions. With ``xla_safe`` the trees
    avoid the shapes where the reference's traced function is not the
    operations as written (ROADMAP.md queue C): no float + or - over a
    product, a division or a DECIMAL promotion (XLA:CPU contracts them
    into one FMA), no float division of or by a division (XLA's
    simplifier reassociates the chain), and integer / and % and DECIMAL
    * over column leaves only (a wrapped product feeding a division is
    where XLA's code assumes no signed overflow). With ``numpy_safe``
    they avoid where the program is the traced function and not numpy's
    interpretive path: float division by a constant and DECIMAL → float
    (a reciprocal product), float → int casts (saturating), and int →
    DECIMAL promotion of anything but a column (the host path detects
    overflow)."""

    def __init__(self, rng: np.random.Generator, depth: int,
                 xla_safe: bool = False, numpy_safe: bool = False):
        self.rng = rng
        self.depth = depth
        self.xla_safe = xla_safe
        self.numpy_safe = numpy_safe

    def addend(self, t: str, d: int):
        """An operand of a float + or -."""
        e = self.gen(t, d)
        if self.xla_safe and _fma_shaped(e):
            return self.leaf(t)
        return e

    def dividend(self, t: str, d: int):
        """An operand of a / or %: no division chain for floats, a leaf
        for integers and DECIMAL."""
        if (self.xla_safe or self.numpy_safe) and t not in _FLOAT:
            return self.leaf(t)
        e = self.gen(t, d)
        if self.xla_safe and _div_shaped(e):
            return self.leaf(t)
        return e

    def intop(self, op: str, a: str, b: str, d: int):
        if op in ("%", "/") or (op == "*" and "DECIMAL" in (a, b)):
            return ("bin", op, self.dividend(a, d), self.dividend(b, d))
        if self.numpy_safe and "DECIMAL" in (a, b) and a != b:
            return ("bin", op, self.leaf(a), self.leaf(b))
        return ("bin", op, self.gen(a, d), self.gen(b, d))

    def pick(self, xs):
        return xs[int(self.rng.integers(0, len(xs)))]

    def leaf(self, t: str):
        r = self.rng.random()
        if r < 0.7:
            return ("ref", _TYPED[t], t)
        if r < 0.8:
            return ("lit", None, t)
        vals = {"BOOLEAN": [True, False], "INT16": [0, -1, 7, -32768],
                "INT32": [0, 3, -5, 2147483647], "INT64": [0, -1, 13, -7],
                "FLOAT32": [0.0, -2.5, 1e30], "FLOAT64": [-0.0, 0.5, 3e9],
                "DECIMAL": ["0.908", "-3.5", "0"],
                "TIMESTAMP": [0, -1_500_000, 1_436_918_400_000_000]}[t]
        return ("lit", self.pick(vals), t)

    def num(self, t: str, d: int):
        rng = self.rng
        r = rng.random()
        if t in _INT:
            if r < 0.45:
                return self.intop(self.pick(["+", "-", "*", "%"]), t, t, d)
            if r < 0.55:
                return ("un", "neg", self.gen(t, d))
            if r < 0.8:
                src = self.pick(["BOOLEAN"] + _INT +
                                ([] if self.numpy_safe else _FLOAT))
                return ("cast", self.gen(src, d), t)
            return self.case(t, d)
        if t == "DECIMAL":
            if r < 0.3:
                return self.intop(self.pick(["+", "-", "*", "%", "/"]),
                                  "DECIMAL", "DECIMAL", d)
            if r < 0.5:
                # int → DECIMAL promotion on one side
                it = self.pick(_INT)
                a, b = ("DECIMAL", it) if rng.random() < 0.5 \
                    else (it, "DECIMAL")
                return self.intop(self.pick(["*", "+", "-"]), a, b, d)
            if r < 0.65:
                it = self.pick(_INT)
                return self.intop("/", it, it, d)
            if r < 0.8:
                return ("func", "extract_epoch", [self.gen("TIMESTAMP", d)],
                        "DECIMAL")
            return self.case(t, d)
        # floats
        if r < 0.4:
            op = self.pick(["+", "-", "*", "/", "%"])
            if op in ("+", "-"):
                return ("bin", op, self.addend(t, d), self.addend(t, d))
            if op in ("/", "%"):
                if self.numpy_safe:
                    return ("bin", op, self.dividend(t, d),
                            ("ref", _TYPED[t], t))
                return ("bin", op, self.dividend(t, d),
                        self.dividend(t, d))
            return ("bin", op, self.gen(t, d), self.gen(t, d))
        if r < 0.55:
            # promotion from an int, a DECIMAL or the narrower float
            op = self.pick(["+", "*", "-"])
            others = _INT + (["FLOAT32"] if t == "FLOAT64" else [])
            if not (self.xla_safe and op != "*") and not self.numpy_safe:
                others = others + ["DECIMAL"]
            other = self.pick(others)
            if op == "*":
                a, b = self.gen(t, d), self.gen(other, d)
            else:
                a, b = self.addend(t, d), self.addend(other, d)
            return ("bin", op, *((a, b) if rng.random() < 0.5 else (b, a)))
        if r < 0.65:
            return ("un", "neg", self.gen(t, d))
        if r < 0.85:
            src = self.pick(_INT + ["BOOLEAN"] + _FLOAT +
                            ([] if self.numpy_safe else ["DECIMAL"]))
            return ("cast", self.gen(src, d), t)
        return self.case(t, d)

    def case(self, t: str, d: int):
        whens = [(self.gen("BOOLEAN", d), self.gen(t, d))
                 for _ in range(int(self.rng.integers(1, 3)))]
        return ("case", whens, self.gen(t, d))

    def boolean(self, d: int):
        r = self.rng.random()
        if r < 0.45:
            a = self.pick(_NUM + ["TIMESTAMP", "BOOLEAN"])
            if a == "TIMESTAMP":
                b = self.pick(["TIMESTAMP", "INT64"])
            elif a == "BOOLEAN":
                b = "BOOLEAN"
            elif a == "DECIMAL":
                b = self.pick(_INT + ["DECIMAL"])   # no float→DECIMAL
            else:
                b = self.pick([x for x in _NUM if x != "DECIMAL"]
                              if a in _FLOAT else _NUM)
            if self.numpy_safe and "DECIMAL" in (a, b) and a != b:
                # int → DECIMAL promotion of a column only
                return ("bin", self.pick(_CMP), self.leaf(a), self.leaf(b))
            return ("bin", self.pick(_CMP), self.gen(a, d), self.gen(b, d))
        if r < 0.65:
            return ("bin", self.pick(["and", "or"]), self.gen("BOOLEAN", d),
                    self.gen("BOOLEAN", d))
        if r < 0.75:
            return ("un", "not", self.gen("BOOLEAN", d))
        if r < 0.9:
            return ("un", self.pick(["is_null", "is_not_null"]),
                    self.gen(self.pick(_NUM + ["TIMESTAMP", "BOOLEAN"]), d))
        if r < 0.95:
            return ("cast", self.gen(self.pick(_INT + _FLOAT), d),
                    "BOOLEAN")
        return self.case("BOOLEAN", d)

    def gen(self, t: str, d: int):
        if d >= self.depth or self.rng.random() < 0.25:
            return self.leaf(t)
        d += 1
        if t == "BOOLEAN":
            return self.boolean(d)
        if t == "TIMESTAMP":
            r = self.rng.random()
            if r < 0.5:
                return ("func", self.pick(["tumble_start", "tumble_end"]),
                        [self.gen("TIMESTAMP", d),
                         ("interval", int(self.pick([7, 10_000_000, 1])))],
                        "TIMESTAMP")
            if r < 0.7:
                return ("bin", self.pick(["+", "-"]),
                        self.gen("TIMESTAMP", d), self.gen("TIMESTAMP", d))
            return self.case("TIMESTAMP", d)
        return self.num(t, d)


def _fma_shaped(e) -> bool:
    """A product, division, DECIMAL-derived value, or a float cast /
    negation / CASE of one: what XLA:CPU may fuse into an FMA."""
    k = e[0]
    if k == "bin":
        return e[1] in ("*", "/")
    if k == "cast":
        return e[2] in ("FLOAT32", "FLOAT64") and (
            _fma_shaped(e[1]) or _returns(e[1]) == "DECIMAL")
    if k == "un" and e[1] == "neg":
        return _fma_shaped(e[2])
    if k == "case":
        return any(_fma_shaped(v) for _c, v in e[1]) or _fma_shaped(e[2])
    return False


def _div_shaped(e) -> bool:
    """A division, or a cast / negation / CASE of one."""
    k = e[0]
    if k == "bin":
        return e[1] == "/"
    if k == "cast":
        return _div_shaped(e[1])
    if k == "un" and e[1] == "neg":
        return _div_shaped(e[2])
    if k == "case":
        return any(_div_shaped(v) for _c, v in e[1]) or _div_shaped(e[2])
    return False


def _returns(e) -> str:
    """The type name a description returns (what the casts need)."""
    k = e[0]
    if k in ("ref", "lit"):
        return e[2]
    if k == "cast":
        return e[2]
    if k == "func":
        return e[3]
    if k == "case":
        return _returns(e[2])
    if k == "un":
        return "BOOLEAN" if e[1] != "neg" else _returns(e[2])
    if e[1] in _CMP or e[1] in ("and", "or"):
        return "BOOLEAN"
    lt, rt = _returns(e[2]), _returns(e[3])
    if lt == rt:
        t = lt
    else:
        order = _NUM
        t = order[max(order.index(lt), order.index(rt))] \
            if lt in order and rt in order else lt
    if e[1] == "/" and t in _INT:
        return "DECIMAL"
    return t


def random_exprs(seed: int, n_out: int = 6, n_pred: int = 2,
                 depth: int = 3, xla_safe: bool = False,
                 numpy_safe: bool = False) -> Tuple[List, List]:
    """(predicate descriptions, output descriptions) over COLS. Outputs
    cover every device type in turn and one host passthrough."""
    rng = np.random.default_rng(seed)
    g = _Gen(rng, depth, xla_safe, numpy_safe)
    types = [t for _n, t in COLS[:-1]]
    outs = [g.gen(types[(seed + j) % len(types)], 0) for j in range(n_out)]
    outs.append(("ref", len(COLS) - 1, "VARCHAR"))
    preds = [g.gen("BOOLEAN", 0) for _ in range(n_pred)]
    return preds, outs


def build(desc, E, DataType, Interval):
    """A description → an expression of module `E` (the port's
    ``expr.expr`` or the reference's), with its DataType and Interval."""
    kind = desc[0]
    if kind == "ref":
        return E.InputRef(desc[1], DataType[desc[2]])
    if kind == "lit":
        v, t = desc[1], DataType[desc[2]]
        if t == DataType.DECIMAL and v is not None:
            return E.lit(v, DataType.DECIMAL)
        return E.Literal(v, t)
    if kind == "bin":
        return E.BinaryOp(desc[1], build(desc[2], E, DataType, Interval),
                          build(desc[3], E, DataType, Interval))
    if kind == "un":
        return E.UnaryOp(desc[1], build(desc[2], E, DataType, Interval))
    if kind == "cast":
        return E.Cast(build(desc[1], E, DataType, Interval),
                      DataType[desc[2]])
    if kind == "case":
        return E.Case([(build(c, E, DataType, Interval),
                        build(v, E, DataType, Interval))
                       for c, v in desc[1]],
                      build(desc[2], E, DataType, Interval))
    if kind == "func":
        args = []
        for a in desc[2]:
            if a[0] == "interval":
                args.append(E.Literal(Interval(usecs=a[1]),
                                      DataType.INTERVAL))
            else:
                args.append(build(a, E, DataType, Interval))
        return E.FuncCall(desc[1], args, DataType[desc[3]])
    raise ValueError(desc)


_I64 = np.iinfo(np.int64)


# subnormal floats and values whose products are subnormal: IEEE keeps
# them (numpy, the reference's interpretive path, and the port's program
# and kernel); XLA:CPU flushes them to zero, so the traced-reference
# checks leave them out (ROADMAP.md queue C, declared deviations)
SUBNORMAL_F32 = [1e-40, -1e-40, 1e-20]
SUBNORMAL_F64 = [1e-310, -1e-310, 1e-160]


def column_values(n: int, seed: int, edges: bool,
                  subnormals: bool = False) -> List[Tuple]:
    """(values, validity) per COLS column for n rows. Without ``edges``
    the values stay where numpy's interpretive path agrees with the
    traced one (no DECIMAL overflow on promotion, no NaN or
    out-of-range float casts). With ``subnormals`` (edges only) the
    float edge lists also hold subnormal values."""
    rng = np.random.default_rng(seed)
    sub32 = SUBNORMAL_F32 if subnormals and edges else []
    sub64 = SUBNORMAL_F64 if subnormals and edges else []

    def pick_edges(vals, edge_list, share=0.15):
        if not edges:
            return vals
        m = rng.random(n) < share
        vals = vals.copy()
        vals[m] = rng.choice(np.asarray(edge_list, dtype=vals.dtype),
                             int(m.sum()))
        return vals

    def pick_subnormals(vals, sub, share=0.1):
        if not sub:
            return vals
        m = rng.random(n) < share
        vals = vals.copy()
        vals[m] = rng.choice(np.asarray(sub, dtype=vals.dtype), int(m.sum()))
        return vals

    out = []
    out.append((rng.random(n) < 0.5, None))
    s = rng.integers(-300, 300, n).astype(np.int16)
    out.append((pick_edges(s, [-32768, 32767, -1, 0]), None))
    i = rng.integers(-10**5, 10**5, n).astype(np.int32)
    out.append((pick_edges(i, [-2**31, 2**31 - 1, -1, 0]), None))
    big = 10**13 if not edges else 10**17
    lv = rng.integers(-big, big, n).astype(np.int64)
    lv = np.where(rng.random(n) < 0.2, rng.integers(-3, 4, n), lv)
    out.append((pick_edges(lv, [_I64.min, _I64.max, -1, 0, 1]), None))
    f = (rng.standard_normal(n) * 100).astype(np.float32)
    f = np.where(rng.random(n) < 0.1, np.float32(0), f)
    f = pick_edges(f, [np.nan, np.inf, -np.inf, -0.0, 3e38, 1e10, -1e10])
    out.append((pick_subnormals(f, sub32), None))
    d = rng.standard_normal(n) * 1e4
    d = np.where(rng.random(n) < 0.1, 0.0, d)
    d = pick_edges(d, [np.nan, np.inf, -np.inf, -0.0, 1e300, 1e19, -1e19,
                       9.3e18])
    out.append((pick_subnormals(d, sub64), None))
    m = rng.integers(-10**9, 10**9, n).astype(np.int64)
    out.append((pick_edges(m, [_I64.min, -1, 0, 10**18]), None))
    t = 1_436_918_400_000_000 + rng.integers(-10**9, 10**9, n)
    t = np.where(rng.random(n) < 0.3, rng.integers(-10**8, 10**8, n), t)
    out.append((pick_edges(t.astype(np.int64), [_I64.min + 10**7, -1, 0,
                                                -10_000_001]), None))
    v = np.empty(n, dtype=object)
    v[:] = [f"v{int(x) % 4}" for x in rng.integers(0, 100, n)]
    out.append((v, None))
    res = []
    for vals, _ok in out:
        ok = rng.random(n) > 0.12
        res.append((vals, ok))
    return res


def chunk_meta(n: int, seed: int, separators: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(vis bool, ops int8) of n rows: inserts and deletes, U-/U+ pairs
    (half of them with equal halves), invisible rows, and `separators`
    always-invisible rows with op 0 spread through the chunk."""
    rng = np.random.default_rng(seed + 101)
    vis = rng.random(n) > 0.1
    ops = np.where(rng.random(n) < 0.15, 2, 1).astype(np.int8)
    for i in range(0, n - 1, 5):
        if rng.random() < 0.6:
            ops[i], ops[i + 1] = 3, 4
            vis[i] = vis[i + 1] = rng.random() < 0.9
    for i in rng.choice(n, separators, replace=False) if separators else ():
        vis[i] = False
        ops[i] = 0
    return vis, ops


def pair_copy(cols: List[Tuple], ops: np.ndarray, seed: int) -> None:
    """Make half the U-/U+ pairs equal in every column (noop pairs the
    projection drop must find), in place."""
    rng = np.random.default_rng(seed + 7)
    for i in np.flatnonzero(ops[:-1] == 3):
        if ops[i + 1] == 4 and rng.random() < 0.5:
            for vals, ok in cols:
                vals[i + 1] = vals[i]
                ok[i + 1] = ok[i]


def port_case(seed: int, n: int, edges: bool, separators: int = 0,
              n_pred: int = 2, xla_safe: bool = False,
              numpy_safe: bool = False, subnormals: bool = False,
              n_out: int = 6):
    """A random filter→project run of the port over COLS and one chunk of
    n rows: (FusedStages, StreamChunk); ``subnormals`` as in
    ``column_values``."""
    from risingwave_tpu_torch.common.chunk import Column, StreamChunk
    from risingwave_tpu_torch.common.types import (
        DataType, Field, Interval, Schema,
    )
    from risingwave_tpu_torch.expr import expr as E
    from risingwave_tpu_torch.ops.fused import FusedStage, FusedStages
    preds, outs = random_exprs(seed, n_out=n_out, n_pred=n_pred,
                               xla_safe=xla_safe, numpy_safe=numpy_safe)
    schema = Schema([Field(nm, DataType[t]) for nm, t in COLS])
    stages = [FusedStage("filter", "FilterExecutor",
                         exprs=(build(p, E, DataType, Interval),))
              for p in preds]
    stages.append(FusedStage(
        "project", "ProjectExecutor",
        exprs=tuple(build(o, E, DataType, Interval) for o in outs),
        names=tuple(f"o{j}" for j in range(len(outs)))))
    fs = FusedStages(schema, stages)
    cols = column_values(n, seed, edges, subnormals)
    vis, ops = chunk_meta(n, seed, separators)
    pair_copy(cols, ops, seed)
    chunk = StreamChunk(schema, [Column(DataType[t], v, ok) for (_nm, t),
                                 (v, ok) in zip(COLS, cols)], vis, ops)
    return fs, chunk


class EdgeCase(NamedTuple):
    seed: int
    n: int                # rows on the CPU
    card_n: int           # rows on the card: reaches the 64/128-row tiles
    n_pred: int = 2
    n_out: int = 6
    seg: int = 0          # agg_prelude rings of seg rows (0: the range)
    hop: bool = False     # a hop window (3 copies) before the filters
    pairs: bool = False   # U-/U+ pairs across every tile edge and wrap


EDGE_TILE = 32            # the smallest tile: every tile edge is on it
HOP = dict(slide_usecs=10_000_000, size_usecs=30_000_000)
# seeds whose predicates keep a sixth of the rows or more visible after
# every filter, on the CPU's and the card's values, so that degradation
# and the noop-pair drop meet visible pairs
EDGE_CASES = {
    "four_preds": EdgeCase(136, 300, 36_000, n_pred=4, pairs=True),
    "outputs_32": EdgeCase(132, 200, 4_000, n_out=32),
    "pairs_at_edges": EdgeCase(104, 256, 20_000, pairs=True),
    "hop_across_tiles": EdgeCase(105, 45, 3_001, hop=True, pairs=True),
    "seg_small": EdgeCase(107, 256, 4_096, seg=8, pairs=True),
    "seg_large": EdgeCase(114, 512, 32_768, seg=256, pairs=True),
    "one_row": EdgeCase(124, 1, 1),
    "ragged": EdgeCase(117, 1_000, 40_001, pairs=True),
}


def edge_exprs(case: EdgeCase, xla_safe: bool) -> Tuple[List, List]:
    """The case's (predicates, outputs); with a hop window the outputs
    also read window_start and window_end."""
    preds, outs = random_exprs(case.seed, n_out=case.n_out,
                               n_pred=case.n_pred, xla_safe=xla_safe)
    if case.hop:
        outs = outs + [("ref", len(COLS), "TIMESTAMP"),
                       ("ref", len(COLS) + 1, "TIMESTAMP")]
    return preds, outs


def edge_stages(case: EdgeCase, E, DataType, Interval, FusedStage,
                FusedStages, Schema, Field, xla_safe: bool = False):
    """The case's FusedStages, built from either package's classes (the
    port's, or the reference's for the CPU parity tests)."""
    preds, outs = edge_exprs(case, xla_safe)
    schema = Schema([Field(nm, DataType[t]) for nm, t in COLS])
    stages = []
    if case.hop:
        stages.append(FusedStage("hop_window", "HopWindowExecutor",
                                 time_col=_TYPED["TIMESTAMP"], **HOP))
    stages += [FusedStage("filter", "FilterExecutor",
                          exprs=(build(p, E, DataType, Interval),))
               for p in preds]
    stages.append(FusedStage(
        "project", "ProjectExecutor",
        exprs=tuple(build(o, E, DataType, Interval) for o in outs),
        names=tuple(f"o{j}" for j in range(len(outs)))))
    return FusedStages(schema, stages)


def edge_pairs(case: EdgeCase, n: int) -> List[Tuple[int, int]]:
    """Raw row pairs (a, b), b a's successor in its ring: every ring's
    wrap (its last row, then its first) and every tile edge inside a
    ring. With a hop window the ring is the expanded range, whose copies
    follow one another: raw row n - 1's successor is row 0."""
    ring = case.seg or n
    out = []
    for rs in range(0, n, ring):
        if ring > 1:
            out.append((rs + ring - 1, rs))
        out += [(e - 1, e) for e in range(rs + EDGE_TILE, rs + ring,
                                          EDGE_TILE)]
    return out


def edge_case(name: str, on_card: bool, edges: bool,
              xla_safe: bool = False, subnormals: bool = False):
    """(FusedStages, StreamChunk, seg) of the port for case `name`, at
    its card size or its CPU size. Forced pairs are visible U-/U+ pairs,
    every second one equal in every column (a noop pair)."""
    from risingwave_tpu_torch.common.chunk import Column, StreamChunk
    from risingwave_tpu_torch.common.types import (
        DataType, Field, Interval, Schema,
    )
    from risingwave_tpu_torch.expr import expr as E
    from risingwave_tpu_torch.ops.fused import FusedStage, FusedStages
    case = EDGE_CASES[name]
    n = case.card_n if on_card else case.n
    fs = edge_stages(case, E, DataType, Interval, FusedStage, FusedStages,
                     Schema, Field, xla_safe)
    cols = column_values(n, case.seed, edges, subnormals)
    vis, ops = chunk_meta(n, case.seed, separators=n // 64)
    pair_copy(cols, ops, case.seed)
    if case.pairs:
        for k, (a, b) in enumerate(edge_pairs(case, n)):
            ops[a], ops[b] = 3, 4
            vis[a] = vis[b] = True
            if k % 2:
                for vals, ok in cols:
                    vals[b] = vals[a]
                    ok[b] = ok[a]
    schema = Schema([Field(nm, DataType[t]) for nm, t in COLS])
    chunk = StreamChunk(schema, [Column(DataType[t], v, ok) for (_nm, t),
                                 (v, ok) in zip(COLS, cols)], vis, ops)
    return fs, chunk, case.seg


def edge_programs(name: str, fs) -> dict:
    """entry point -> its program for edge case `name` (a ``seg`` ring
    only for agg_prelude; no join prelude over a hop window)."""
    from risingwave_tpu_torch.ops import fused as F
    case = EDGE_CASES[name]
    g, calls, specs = agg_plan(fs, case.seed)
    out = {"agg_prelude": F.compile_program(
        fs, F.MODE_AGG, group_indices=g, agg_calls=calls, specs=specs)}
    if not case.seg:
        out["fused_chain"] = F.compile_program(fs, F.MODE_CHAIN)
    if not case.seg and not case.hop:
        keys, pays = join_plan(fs, case.seed)
        out["join_prelude"] = F.compile_program(
            fs, F.MODE_JOIN, key_indices=keys, pay_indices=pays)
    return out


def call_entry(entry: str, prog, raw, host_same=None, counts=None,
               seg: int = 0):
    """Entry point `entry` ("fused_chain", "agg_prelude" or
    "join_prelude") through its wrapper. ``host_same`` reaches the chain
    step only, ``counts`` the chain step and the agg prelude, ``seg`` the
    agg prelude only."""
    from risingwave_tpu_torch.ops import fused as F
    if entry == "fused_chain":
        return F.fused_chain(prog, raw, host_same, counts)
    if entry == "agg_prelude":
        return F.agg_prelude(prog, raw, counts, seg=seg)
    return F.join_prelude(prog, raw)


def run_both(entry: str, prog, raw, host_same=None, seg: int = 0,
             call=call_entry):
    """Entry point `entry` through `call` (``call_entry``'s signature; by
    default this build's wrapper) and through the plain program, on the
    same tensors: ((out, counts), (out, counts)), counts None for the
    join prelude."""
    import torch

    from risingwave_tpu_torch.ops import fused as F
    ck = None if entry == "join_prelude" else torch.zeros(
        prog.n_counts, dtype=torch.int64, device=raw.device)
    cp = None if ck is None else ck.clone()
    if entry != "fused_chain":
        host_same = None
    if entry != "agg_prelude":
        seg = 0
    got = call(entry, prog, raw, host_same, ck, seg)
    want = F.run_program_plain(prog, raw, host_same, cp, seg=seg)
    return (got, ck), (want, cp)


def agg_plan(fs, seed: int):
    """A group-by over fs's output: (group indices, AggCalls, AggSpecs)
    covering every device call kind the encode section has."""
    from risingwave_tpu_torch.ops.hash_agg import AggKind
    from risingwave_tpu_torch.stream.executors.hash_agg import AggCall
    rng = np.random.default_rng(seed + 3)
    dev = [j for j, f in enumerate(fs.out_schema)
           if f.data_type.is_device]
    ints = [j for j in dev if np.dtype(
        fs.out_schema[j].data_type.np_dtype).kind in "iub"]
    floats = [j for j in dev if j not in ints]
    group = [int(rng.choice(dev))]
    calls = [AggCall(AggKind.COUNT), AggCall(AggKind.COUNT, dev[-1])]
    if ints:
        calls += [AggCall(AggKind.SUM, int(rng.choice(ints))),
                  AggCall(AggKind.MAX, int(rng.choice(ints)))]
    if floats:
        calls += [AggCall(AggKind.SUM, int(rng.choice(floats))),
                  AggCall(AggKind.MIN, int(rng.choice(floats)))]
    specs = [c.spec(fs.out_schema) for c in calls]
    return group, calls, specs


def join_plan(fs, seed: int):
    """Join keys and payload columns over fs's output: (key indices,
    payload indices = every device column)."""
    rng = np.random.default_rng(seed + 5)
    dev = [j for j, f in enumerate(fs.out_schema)
           if f.data_type.is_device]
    keys = sorted(int(k) for k in rng.choice(dev, 2, replace=False))
    return keys, dev


def mismatch(prog, got: np.ndarray, want: np.ndarray,
             nan_rows) -> float:
    """Largest |got - want| over an entry point's output (int64 view),
    where a NaN compares equal to a NaN whatever its bits: float lanes of
    rows whose output column is NaN (``nan_rows[out-schema position]``,
    bool per row; None: every lane bit for bit) are compared as NaN-ness
    only. 0 means bit for bit equal."""
    from risingwave_tpu_torch.ops import fused as F
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    skip = np.zeros(got.shape, dtype=bool)
    w = prog.words
    floats = (F.T_F32, F.T_F64)
    if prog.mode == F.MODE_CHAIN:
        for j, t in enumerate(prog.out_types):
            if t in floats:
                a = got[:, 2 * j].view(np.float64)
                b = want[:, 2 * j].view(np.float64)
                both = np.isnan(a) & np.isnan(b)
                skip[:, 2 * j] = both
    else:
        at = 0
        enc_at = int(w[F.H_ENC])
        for i in range(int(w[F.H_NENC])):
            e, o = int(w[enc_at + 2 * i]), int(w[enc_at + 2 * i + 1])
            n_l = F._E_LANES[e]
            if nan_rows is not None and \
                    e in (F.E_KEY, F.E_PAY, F.E_ORDER, F.E_SUM_FLOAT) and \
                    prog.out_types[o] in floats:
                rows = np.asarray(nan_rows[prog.out_pos[o]])
                n_rows = got.shape[0]
                rows = np.resize(rows, n_rows)
                skip[rows, at:at + n_l - (1 if e in (F.E_KEY, F.E_PAY)
                                          else 0)] = True
            at += n_l
    diff = np.abs(got - want)
    diff[skip] = 0
    return float(diff.max(initial=0))


def nan_rows_of(fs, chunk, device=None):
    """Per out-schema position, the rows whose output value is NaN (the
    plain chain program on the CPU): what ``mismatch`` compares as
    NaN-ness only."""
    import torch
    from risingwave_tpu_torch.ops import fused as F
    prog = F.compile_program(fs, F.MODE_CHAIN)
    raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols))
    mat = F.run_program_plain(prog, raw).numpy()
    cols, _v, _o = F.decode_chain_output(prog, fs, mat)
    out = {}
    for j, c in enumerate(cols):
        if c is not None and c.values.dtype.kind == "f":
            out[j] = np.isnan(c.values)
    return out

