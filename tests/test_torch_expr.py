"""The port's expressions against the reference's, op by op.

Every op of the traceable subset (``risingwave_tpu_torch/expr/expr.py``)
over the case schema of ``ops/fused_cases.py`` (one column per device
type), on chunks with NULLs and edge values: INT64_MIN and the
int16/int32 limits, negative timestamps and operands, zero divisors,
NaN, ±inf, -0.0 and out-of-range floats. Two pairs are held equal:

- the port's numpy ``eval`` against the reference's numpy ``eval`` (the
  interpretive path), bit for bit — including the DECIMAL overflow
  detection, which raises in both;
- the port's compiled program (``ops/fused.py``, the plain version of
  the card's kernels) against the reference's traced function
  (``build_chain_step`` under jit), bit for bit with a NaN equal to a
  NaN. The declared deviations of ROADMAP.md queue C have their own
  tests at the end.
"""

import decimal

import numpy as np
import pytest
import torch

import risingwave_tpu.expr.expr as RE
import risingwave_tpu.ops.fused as RF
from risingwave_tpu.common.chunk import Column as RColumn
from risingwave_tpu.common.chunk import StreamChunk as RChunk
from risingwave_tpu.common.types import DataType as RD
from risingwave_tpu.common.types import DecimalOverflowError as RDecErr
from risingwave_tpu.common.types import Field as RField
from risingwave_tpu.common.types import Interval as RInterval
from risingwave_tpu.common.types import Schema as RSchema
from risingwave_tpu_torch.common.chunk import Column, StreamChunk
from risingwave_tpu_torch.common.types import (
    DataType, DecimalOverflowError, Field, Interval, Schema,
)
from risingwave_tpu_torch.expr import expr as E
from risingwave_tpu_torch.ops import fused as F
from risingwave_tpu_torch.ops import fused_cases as FC

torch.set_num_threads(2)

N = 96


def r(i):
    name = FC.COLS[i][1]
    return ("ref", i, name)


B, S, I, L, F32, F64, M, T = (r(i) for i in range(8))


def lit(v, t):
    return ("lit", v, t)


def b(op, x, y):
    return ("bin", op, x, y)


# name → expression description over FC.COLS
OPS = {
    "add_i16": b("+", S, S), "sub_i16": b("-", S, lit(-32768, "INT16")),
    "mul_i16": b("*", S, S), "add_i32": b("+", I, I), "mul_i32": b("*", I, I),
    "add_i64": b("+", L, L), "sub_i64": b("-", L, L), "mul_i64": b("*", L, L),
    "neg_i16": ("un", "neg", S), "neg_i32": ("un", "neg", I),
    "neg_i64": ("un", "neg", L),
    "mod_i16": b("%", S, lit(-7, "INT16")), "mod_i32": b("%", I, I),
    "mod_i64": b("%", L, L), "mod_i64_zero": b("%", L, lit(0, "INT64")),
    "mod_i64_minus1": b("%", L, lit(-1, "INT64")),
    "div_i32_decimal": b("/", I, I), "div_i16_decimal": b("/", S, S),
    "dec_add": b("+", M, M), "dec_sub": b("-", M, lit("0.908", "DECIMAL")),
    "dec_mul_lit": b("*", lit("0.908", "DECIMAL"), M),
    "dec_div": b("/", M, M), "dec_mod": b("%", M, M),
    "dec_mul_i16": b("*", M, S),
    "f32_add": b("+", F32, F32), "f32_sub": b("-", F32, F32),
    "f32_mul": b("*", F32, F32), "f32_div": b("/", F32, F32),
    "f32_mod": b("%", F32, F32), "f64_add": b("+", F64, F64),
    "f64_mul": b("*", F64, F64), "f64_div": b("/", F64, F64),
    "f64_mod": b("%", F64, F64),
    "f64_div_const": b("/", F64, lit(3.0, "FLOAT64")),
    "f32_div_const": b("/", F32, lit(-2.5, "FLOAT32")),
    "f64_div_zero_const": b("/", F64, lit(0.0, "FLOAT64")),
    "neg_f32": ("un", "neg", F32), "neg_f64": ("un", "neg", F64),
    "promote_i64_f32": b("*", L, F32), "promote_i16_f64": b("-", F64, S),
    "promote_dec_f64": b("*", M, F64), "promote_f32_f64": b("*", F32, F64),
    "cmp_eq_i16_i64": b("=", S, L), "cmp_lt_i32": b("<", I, I),
    "cmp_le_f32_f64": b("<=", F32, F64), "cmp_ne_f64": b("<>", F64, F64),
    "cmp_gt_dec_i64": b(">", M, L), "cmp_ge_ts_i64": b(">=", T, L),
    "cmp_ts": b("<", T, T), "cmp_bool": b("=", B, B),
    "cmp_dec_f32": b("<", M, F32),
    "and": b("and", B, b("<", S, lit(0, "INT16"))),
    "or": b("or", B, b(">", I, lit(0, "INT32"))),
    "and_null_lit": b("and", B, lit(None, "BOOLEAN")),
    "or_null_lit": b("or", B, lit(None, "BOOLEAN")),
    "not": ("un", "not", B), "is_null": ("un", "is_null", F64),
    "is_not_null": ("un", "is_not_null", M),
    "cast_f32_i16": ("cast", F32, "INT16"), "cast_f32_i32": ("cast", F32,
                                                             "INT32"),
    "cast_f64_i64": ("cast", F64, "INT64"), "cast_f64_i16": ("cast", F64,
                                                             "INT16"),
    "cast_f64_bool": ("cast", F64, "BOOLEAN"),
    "cast_f64_f32": ("cast", F64, "FLOAT32"),
    "cast_f32_f64": ("cast", F32, "FLOAT64"),
    "cast_i64_f32": ("cast", L, "FLOAT32"), "cast_i64_f64": ("cast", L,
                                                             "FLOAT64"),
    "cast_i64_i16": ("cast", L, "INT16"), "cast_i64_i32": ("cast", L,
                                                           "INT32"),
    "cast_i16_i64": ("cast", S, "INT64"), "cast_bool_i32": ("cast", B,
                                                            "INT32"),
    "cast_i32_bool": ("cast", I, "BOOLEAN"),
    "cast_dec_f64": ("cast", M, "FLOAT64"), "cast_dec_f32": ("cast", M,
                                                             "FLOAT32"),
    "case": ("case", [(b("<", S, lit(0, "INT16")), L),
                      (B, lit(None, "INT64"))], b("+", L, lit(1, "INT64"))),
    "case_null_cond": ("case", [(lit(None, "BOOLEAN"), F64)], F64),
    "tumble_start": ("func", "tumble_start", [T, ("interval", 10_000_000)],
                     "TIMESTAMP"),
    "tumble_end": ("func", "tumble_end", [T, ("interval", 7)], "TIMESTAMP"),
    "extract_epoch": ("func", "extract_epoch", [T], "DECIMAL"),
    "null_literal": b("+", L, lit(None, "INT64")),
}


def _schemas():
    return (Schema([Field(n, DataType[t]) for n, t in FC.COLS]),
            RSchema([RField(n, RD[t]) for n, t in FC.COLS]))


def _chunks(seed, edges):
    ps, rs = _schemas()
    cols = FC.column_values(N, seed, edges)
    vis, ops = FC.chunk_meta(N, seed)
    pc = StreamChunk(ps, [Column(DataType[t], v, ok) for (_n, t), (v, ok)
                          in zip(FC.COLS, cols)], vis, ops)
    rc = RChunk(rs, [RColumn(RD[t], v, ok) for (_n, t), (v, ok)
                     in zip(FC.COLS, cols)], vis, ops)
    return pc, rc


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _eq(x, ok_x, y, ok_y, nan_equal=False):
    """Validity equal, values bit for bit where valid."""
    ok_x = np.ones(N, bool) if ok_x is None else np.asarray(ok_x)
    ok_y = np.ones(N, bool) if ok_y is None else np.asarray(ok_y)
    np.testing.assert_array_equal(ok_x, ok_y)
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    same = _bits(x) == _bits(y)
    if nan_equal and x.dtype.kind == "f":
        same |= np.isnan(x) & np.isnan(y)
    bad = np.flatnonzero(ok_x & ~same)
    assert not len(bad), (bad[:4], x[bad[:4]], y[bad[:4]])


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_numpy_eval_matches_reference(name, edges):
    pc, rc = _chunks(3, edges)
    pe = FC.build(OPS[name], E, DataType, Interval)
    re_ = FC.build(OPS[name], RE, RD, RInterval)
    assert pe.return_type.value == re_.return_type.value
    with np.errstate(all="ignore"):
        try:
            want = re_.eval(rc)
        except RDecErr:
            with pytest.raises(DecimalOverflowError):
                pe.eval(pc)
            return
        got = pe.eval(pc)
    _eq(got.values, got.validity, want.values, want.validity)


def _program_column(desc, chunk):
    """The compiled program (plain version) of one output column."""
    ps, _rs = _schemas()
    fs = F.FusedStages(ps, [F.FusedStage(
        "project", "ProjectExecutor",
        exprs=(FC.build(desc, E, DataType, Interval),), names=("o",))])
    assert fs.fusable_reason() is None, fs.fusable_reason()
    prog = F.compile_program(fs, F.MODE_CHAIN)
    raw = torch.from_numpy(F.encode_raw_chunk(chunk, fs.ref_cols))
    cols, _v, _o = F.decode_chain_output(
        prog, fs, F.fused_chain(prog, raw).numpy())
    return cols[0]


def _traced_column(desc, chunk):
    """The reference's traced function of one output column."""
    _ps, rs = _schemas()
    fs = RF.FusedStages(rs, [RF.FusedStage(
        "project", "ProjectExecutor",
        exprs=(FC.build(desc, RE, RD, RInterval),), names=("o",))])
    assert fs.fusable_reason() is None
    step = RF.build_chain_step(fs)
    vals = tuple(np.asarray(chunk.columns[i].values) for i in fs.ref_cols)
    oks = tuple(np.asarray(chunk.columns[i].validity) for i in fs.ref_cols)
    fv, fo, _vis, _ops, _sr = step(vals, oks, np.asarray(chunk.visibility),
                                   np.asarray(chunk.ops),
                                   np.ones(N, dtype=bool))
    return np.asarray(fv[0]), np.asarray(fo[0])


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("name", sorted(OPS))
def test_program_matches_traced_reference(name, edges):
    pc, rc = _chunks(5, edges)
    got = _program_column(OPS[name], pc)
    want, want_ok = _traced_column(OPS[name], rc)
    _eq(got.values, got.validity, want, want_ok, nan_equal=True)


def test_edge_values_reach_the_ops():
    """The edge data really holds the values the semantics turn on."""
    cols = FC.column_values(N, 5, True)
    assert (cols[3][0] == np.iinfo(np.int64).min).any()
    assert np.isnan(cols[5][0]).any() and np.isinf(cols[5][0]).any()
    assert (cols[7][0] < 0).any()
    assert (cols[2][0] == np.iinfo(np.int32).min).any()


def test_float_to_int_casts_saturate_like_xla():
    """NaN → 0 and out-of-range → the type's limit (XLA's convert); the
    numpy interpretive path gives x86's INT_MIN instead, as the
    reference's numpy path does."""
    ps, _rs = _schemas()
    vals = np.array([np.nan, 1e30, -1e30, 3e9, -3e9, 40000.7, -2.5, 0.0],
                    dtype=np.float64)
    n = len(vals)
    cols = FC.column_values(n, 1, False)
    cols[5] = (vals, np.ones(n, bool))
    chunk = StreamChunk(ps, [Column(DataType[t], v, ok) for (_n, t), (v, ok)
                             in zip(FC.COLS, cols)], np.ones(n, bool),
                        np.ones(n, np.int8))
    want = {"INT64": [0, 2**63 - 1, -2**63, 3_000_000_000, -3_000_000_000,
                      40000, -2, 0],
            "INT32": [0, 2**31 - 1, -2**31, 2**31 - 1, -2**31, 40000, -2,
                      0],
            "INT16": [0, 32767, -32768, 32767, -32768, 32767, -2, 0],
            "BOOLEAN": [True, True, True, True, True, True, True, False]}
    for t, exp in want.items():
        got = _program_column(("cast", F64, t), chunk)
        assert got.values.tolist() == exp, (t, got.values)


# -- declared deviations (ROADMAP.md queue C) -------------------------------


def _one_row_chunk(**vals):
    ps, _rs = _schemas()
    cols = FC.column_values(1, 0, False)
    for name, v in vals.items():
        i = [n for n, _t in FC.COLS].index(name)
        cols[i] = (np.asarray([v], dtype=cols[i][0].dtype),
                   np.ones(1, bool))
    return StreamChunk(ps, [Column(DataType[t], v, ok) for (_n, t), (v, ok)
                            in zip(FC.COLS, cols)], np.ones(1, bool),
                       np.ones(1, np.int8))


def test_deviation_wrapped_product_feeding_a_division():
    """A product that wraps int32 feeds a modulo: the port keeps numpy's
    wrapped value (-87097 % wrap(87097²) = -87097). XLA's compiled code
    assumes the product does not overflow and gives another value."""
    desc = b("%", ("un", "neg", I), b("*", I, I))
    got = _program_column(desc, _one_row_chunk(i=87097))
    i = np.array([87097], dtype=np.int32)
    with np.errstate(all="ignore"):
        sq = i * i
        want = -i - (-i // sq) * sq
    assert got.values.tolist() == want.tolist() == [-87097]


def test_deviation_no_fused_multiply_add():
    """x * y + z rounds twice on the port (numpy's rounding; the kernel is
    built with -fmad=false); XLA on the CPU contracts it into one FMA."""
    x, y, z = 1.0 + 2.0 ** -30, 1.0 - 2.0 ** -30, -1.0
    desc = b("+", b("*", F64, F64), lit(z, "FLOAT64"))
    chunk = _one_row_chunk(d=x)
    got = _program_column(desc, chunk)
    assert got.values.tolist() == [x * x + z] == [2.0 ** -29]
    # one rounding would keep the 2^-60 term
    assert got.values[0] != 2.0 ** -29 + 2.0 ** -60


def test_deviation_division_chain_as_written():
    """(a / b) / c divides twice on the port, as written; XLA's
    simplifier rewrites the chain to a / (b * c). A division by a
    constant IS the reciprocal product, as XLA computes it."""
    a, c = 0.1, 3.0
    chain = b("/", b("/", F64, F64), F64)
    got = _program_column(chain, _one_row_chunk(d=a))
    assert got.values.tolist() == [(a / a) / a]
    const = _program_column(b("/", F64, lit(c, "FLOAT64")),
                            _one_row_chunk(d=a))
    assert const.values.tolist() == [a * (1.0 / c)]
    dec = _program_column(("cast", M, "FLOAT64"), _one_row_chunk(m=7))
    assert dec.values.tolist() == [7.0 * (1.0 / 10000.0)]


def test_decimal_product_and_currency_rate():
    """q1's 0.908 * price: a DECIMAL product truncated toward zero."""
    desc = b("*", lit("0.908", "DECIMAL"), L)
    got = _program_column(desc, _one_row_chunk(l=-1234567))
    exact = decimal.Decimal("0.908") * -1234567
    assert got.values.tolist() == [int(exact * 10000)]
