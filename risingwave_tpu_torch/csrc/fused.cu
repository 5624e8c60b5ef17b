// Fused filter/project preludes: one expression-program interpreter, three
// entry points (risingwave_tpu_torch/ops/fused.py).
//
//   rw_fused_chain   B18  ops/fused.py:839 build_chain_step (chain_body
//                         :697, hop :776, noop-pair drop :809)
//   rw_agg_prelude   B19  ops/fused.py:877 build_agg_prelude
//   rw_join_prelude  B20  ops/fused.py:930 build_join_prelude
//   (references are to risingwave_tpu/)
//
// Design. ops/fused.py compiles a composed filter/project run at plan time
// into a flat int64 program: a header, a column table (which raw column or
// hop synthesis feeds each body column), one postfix sub-program per
// predicate and per output column (typed opcodes, 4 words each) and an
// encode section. Every thread runs the same program on its own row, so a
// warp does not diverge on the program; the program is copied to shared
// memory once per block. Values are 64-bit words with a validity bit:
// ints sign-extended from their width (arithmetic in uint64, then
// sign-extended again, as numpy and XLA wrap), bool 0/1, f32 as float bits
// in the low word, f64 as double bits. Float arithmetic uses the _rn
// intrinsics and the library is built with -fmad=false: no contraction.
// A float division by a constant is x * (1 / c), and DECIMAL → float
// multiplies by 1 / 10^4: XLA's algebraic simplifier rewrites the
// reference's traced divisions so, and the port is held to that function.
//
// Neighbour rows. Filter pair degradation and the noop-pair drop read rows
// i-1 and i+1, rolled with wrap-around over the (hop-expanded) row range as
// xp.roll does. A thread recomputes what it needs of its neighbours: the
// ops of rows i-1-K .. i+1+K for K composed predicates, and the output
// columns of i-1 / i+1 only when an update pair makes their equality
// matter. Batched raw matrices carry an always-invisible separator row per
// chunk, so no pair spans two chunks. With a segment length (agg_prelude
// over the row blocks of a sharded step, risingwave_tpu/parallel/agg.py:337
// _build_raw_step, where each shard runs the prelude on its own block), the
// rows roll inside their own segment of `seg` rows, not over the whole
// range.
//
// Stage counts: per counter, __syncthreads_count over the block and one
// atomicAdd on unsigned long long per block — exact and order-free.
//
// Bound: bytes (raw matrix read once + output written once).
#include "common.cuh"

namespace {

enum Hdr {
  H_MODE = 0, H_NREF, H_NBODY, H_UNITS, H_HOP_TS, H_SLIDE, H_SIZE, H_WM_TS,
  H_WM_THR, H_NPRED, H_NOUT, H_DROP, H_COLTAB, H_PREDTAB, H_OUTTAB, H_ENC,
  H_NENC, H_OUTW, H_NCOUNT, H_LEN
};
enum Mode { MODE_CHAIN = 0, MODE_AGG = 1, MODE_JOIN = 2 };
enum Typ { T_BOOL = 0, T_I16, T_I32, T_I64, T_F32, T_F64 };
enum ColKind { C_RAW = 0, C_WSTART, C_WEND, C_NONE };
enum OpCode {
  OP_COL = 0, OP_CONST, OP_CAST, OP_INT2DEC, OP_DEC2F, OP_ADD, OP_SUB,
  OP_MUL, OP_DECMUL, OP_FDIV, OP_DECDIV, OP_MOD, OP_CMP, OP_AND, OP_OR,
  OP_NOT, OP_NEG, OP_ISNULL, OP_ISNOTNULL, OP_CASE_BEGIN, OP_CASE_WHEN,
  OP_CASE_END, OP_TUMBLE_START, OP_TUMBLE_END, OP_EXTRACT_EPOCH
};
enum Enc {
  E_KEY = 0, E_SIGN, E_VIS, E_SUM_INT, E_SUM_FLOAT, E_ORDER, E_VALID, E_PAY
};
enum RowOp { OP_INSERT = 1, OP_DELETE = 2, OP_UD = 3, OP_UI = 4 };

constexpr int kMaxStack = 16;
constexpr int kMaxPred = 4;
constexpr int kMaxOut = 32;
constexpr int kMaxCounts = 3 + kMaxPred;
constexpr int kWin = 2 * kMaxPred + 3;
constexpr int kRawMeta = 2;
constexpr int kThreads = 256;
constexpr int64_t kDec = 10000;
constexpr int kProgMax = 4096;

struct Val {
  uint64_t b;
  bool ok;
};

struct Ctx {
  const int64_t* p;     // the program (shared memory)
  const int64_t* raw;   // int64[n, w]
  long long n;          // raw rows
  int w;
  long long m;          // rows after hop expansion: n * units
  long long seg;        // rows of one roll segment (m: the whole range)
  const int8_t* host_same;
};

__device__ __forceinline__ double as_f64(uint64_t b) {
  return __longlong_as_double(static_cast<long long>(b));
}
__device__ __forceinline__ uint64_t f64_bits(double d) {
  return static_cast<uint64_t>(__double_as_longlong(d));
}
__device__ __forceinline__ float as_f32(uint64_t b) {
  return __int_as_float(static_cast<int>(static_cast<uint32_t>(b)));
}
__device__ __forceinline__ uint64_t f32_bits(float f) {
  return static_cast<uint64_t>(static_cast<uint32_t>(__float_as_int(f)));
}
__device__ __forceinline__ double widen(uint64_t b, int t) {
  return t == T_F32 ? static_cast<double>(as_f32(b)) : as_f64(b);
}
__device__ __forceinline__ bool is_float(int t) {
  return t == T_F32 || t == T_F64;
}

// sign-extend from the width of t (bool: nonzero → 1)
__device__ __forceinline__ uint64_t sext(uint64_t x, int t) {
  switch (t) {
    case T_BOOL: return x != 0 ? 1u : 0u;
    case T_I16:
      return static_cast<uint64_t>(static_cast<int64_t>(
          static_cast<int16_t>(static_cast<uint16_t>(x))));
    case T_I32:
      return static_cast<uint64_t>(static_cast<int64_t>(
          static_cast<int32_t>(static_cast<uint32_t>(x))));
    default: return x;
  }
}

// numpy / jnp floor division and modulo (b != 0; INT64_MIN // -1 wraps)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  if (b == -1) return static_cast<int64_t>(0ull - static_cast<uint64_t>(a));
  int64_t q = a / b;
  const int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int64_t floormod(int64_t a, int64_t b) {
  if (b == -1) return 0;
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// the reference's _div_trunc, built from the floor ops as it is
__device__ __forceinline__ int64_t div_trunc(int64_t num, int64_t den) {
  const int64_t q = floordiv(num, den);
  const int64_t rem = floormod(num, den);
  const bool neg = (num < 0) != (den < 0);
  return (neg && rem != 0)
             ? static_cast<int64_t>(static_cast<uint64_t>(q) + 1u)
             : q;
}

// saturating float → int of width t (XLA's convert): NaN → 0
__device__ __forceinline__ uint64_t f2i(double d, int t) {
  if (t == T_BOOL) return d != 0.0 ? 1u : 0u;
  if (isnan(d)) return 0;
  const double tr = trunc(d);
  const int bits = t == T_I16 ? 16 : t == T_I32 ? 32 : 64;
  const double hi = ldexp(1.0, bits - 1);
  if (tr >= hi) {
    return bits == 64 ? static_cast<uint64_t>(INT64_MAX)
                      : static_cast<uint64_t>((1LL << (bits - 1)) - 1);
  }
  if (tr < -hi) {
    return bits == 64 ? static_cast<uint64_t>(INT64_MIN)
                      : static_cast<uint64_t>(-(1LL << (bits - 1)));
  }
  return static_cast<uint64_t>(static_cast<int64_t>(tr));
}

__device__ uint64_t cast_val(uint64_t b, int ts, int td) {
  if (is_float(ts)) {
    const double d = widen(b, ts);
    if (td == T_F64) return f64_bits(d);
    if (td == T_F32) return f32_bits(__double2float_rn(d));
    return f2i(d, td);
  }
  const int64_t x = static_cast<int64_t>(b);
  if (td == T_F64) return f64_bits(__ll2double_rn(x));
  if (td == T_F32) return f32_bits(__ll2float_rn(x));
  return sext(b, td);
}

// a raw-matrix body column c of (expanded) row r
__device__ Val load_raw(const Ctx& C, const int64_t* ct, long long r) {
  const int k = static_cast<int>(ct[1]);
  const int t = static_cast<int>(ct[2]);
  const int64_t* row = C.raw + (r % C.n) * C.w + kRawMeta + 2 * k;
  const uint64_t word = static_cast<uint64_t>(row[0]);
  Val v;
  v.ok = row[1] != 0;
  if (t == T_F64) {
    v.b = word;
  } else if (t == T_F32) {
    v.b = f32_bits(__double2float_rn(as_f64(word)));
  } else {
    v.b = sext(word, t);
  }
  return v;
}

// body column c of (expanded) row r: a raw column, or a hop window column
// floor(ts / slide) * slide - copy * slide (+ size for window_end)
__device__ Val load_col(const Ctx& C, int c, long long r) {
  const int64_t* ct = C.p + C.p[H_COLTAB] + 3 * c;
  const int kind = static_cast<int>(ct[0]);
  if (kind == C_RAW) return load_raw(C, ct, r);
  const int64_t* tt = C.p + C.p[H_COLTAB] + 3 * C.p[H_HOP_TS];
  const Val ts = load_raw(C, tt, r);
  const int64_t slide = C.p[H_SLIDE];
  const uint64_t copy = static_cast<uint64_t>(r / C.n);
  uint64_t ws = static_cast<uint64_t>(
                    floordiv(static_cast<int64_t>(ts.b), slide)) *
                    static_cast<uint64_t>(slide) -
                copy * static_cast<uint64_t>(slide);
  if (kind == C_WEND) ws += static_cast<uint64_t>(C.p[H_SIZE]);
  Val v;
  v.b = ws;
  v.ok = true;
  return v;
}

__device__ __forceinline__ bool cmp_val(int code, uint64_t a, uint64_t b,
                                        int t) {
  if (is_float(t)) {
    const double x = widen(a, t), y = widen(b, t);
    switch (code) {
      case 0: return x == y;
      case 1: return x != y;
      case 2: return x < y;
      case 3: return x <= y;
      case 4: return x > y;
      default: return x >= y;
    }
  }
  const int64_t x = static_cast<int64_t>(a), y = static_cast<int64_t>(b);
  switch (code) {
    case 0: return x == y;
    case 1: return x != y;
    case 2: return x < y;
    case 3: return x <= y;
    case 4: return x > y;
    default: return x >= y;
  }
}

__device__ uint64_t arith(int op, uint64_t a, uint64_t b, int t) {
  if (t == T_F32) {
    const float x = as_f32(a), y = as_f32(b);
    float z;
    if (op == OP_ADD) z = __fadd_rn(x, y);
    else if (op == OP_SUB) z = __fsub_rn(x, y);
    else z = __fmul_rn(x, y);
    return f32_bits(z);
  }
  if (t == T_F64) {
    const double x = as_f64(a), y = as_f64(b);
    double z;
    if (op == OP_ADD) z = __dadd_rn(x, y);
    else if (op == OP_SUB) z = __dsub_rn(x, y);
    else z = __dmul_rn(x, y);
    return f64_bits(z);
  }
  uint64_t z;
  if (op == OP_ADD) z = a + b;
  else if (op == OP_SUB) z = a - b;
  else z = a * b;
  return sext(z, t);
}

// one postfix sub-program at (expanded) row r
__device__ Val run(const Ctx& C, int start, int n_insn, long long r) {
  Val st[kMaxStack];
  int sp = 0;
  for (int i = 0; i < n_insn; ++i) {
    const int64_t* I = C.p + start + 4 * i;
    const int op = static_cast<int>(I[0]);
    const int a = static_cast<int>(I[1]);
    switch (op) {
      case OP_COL:
        st[sp++] = load_col(C, a, r);
        break;
      case OP_CONST:
        st[sp].b = static_cast<uint64_t>(I[1]);
        st[sp].ok = I[2] != 0;
        ++sp;
        break;
      case OP_CAST:
        st[sp - 1].b = cast_val(st[sp - 1].b, a, static_cast<int>(I[2]));
        break;
      case OP_INT2DEC:
        st[sp - 1].b = st[sp - 1].b * static_cast<uint64_t>(kDec);
        break;
      case OP_DEC2F: {
        const int64_t x = static_cast<int64_t>(st[sp - 1].b);
        st[sp - 1].b =
            a == T_F32
                ? f32_bits(__fmul_rn(__ll2float_rn(x),
                                     __fdiv_rn(1.0f,
                                               static_cast<float>(kDec))))
                : f64_bits(__dmul_rn(__ll2double_rn(x),
                                     __ddiv_rn(1.0,
                                               static_cast<double>(kDec))));
        break;
      }
      case OP_ADD:
      case OP_SUB:
      case OP_MUL: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        x.b = arith(op, x.b, y.b, a);
        x.ok = x.ok && y.ok;
        break;
      }
      case OP_DECMUL: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        x.b = static_cast<uint64_t>(
            div_trunc(static_cast<int64_t>(x.b * y.b), kDec));
        x.ok = x.ok && y.ok;
        break;
      }
      case OP_FDIV: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        const bool recip = I[2] != 0;    // constant divisor
        if (a == T_F32) {
          const float d = as_f32(y.b);
          const bool zero = d == 0.0f;
          const float safe = zero ? 1.0f : d;
          x.b = f32_bits(recip ? __fmul_rn(as_f32(x.b),
                                           __fdiv_rn(1.0f, safe))
                               : __fdiv_rn(as_f32(x.b), safe));
          x.ok = x.ok && y.ok && !zero;
        } else {
          const double d = as_f64(y.b);
          const bool zero = d == 0.0;
          const double safe = zero ? 1.0 : d;
          x.b = f64_bits(recip ? __dmul_rn(as_f64(x.b), __ddiv_rn(1.0, safe))
                               : __ddiv_rn(as_f64(x.b), safe));
          x.ok = x.ok && y.ok && !zero;
        }
        break;
      }
      case OP_DECDIV: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        const int64_t d = static_cast<int64_t>(y.b);
        const bool zero = d == 0;
        x.b = static_cast<uint64_t>(
            div_trunc(static_cast<int64_t>(x.b * static_cast<uint64_t>(kDec)),
                      zero ? 1 : d));
        x.ok = x.ok && y.ok && !zero;
        break;
      }
      case OP_MOD: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        bool zero;
        if (a == T_F32) {
          const float d = as_f32(y.b);
          zero = d == 0.0f;
          x.b = f32_bits(fmodf(as_f32(x.b), zero ? 1.0f : d));
        } else if (a == T_F64) {
          const double d = as_f64(y.b);
          zero = d == 0.0;
          x.b = f64_bits(fmod(as_f64(x.b), zero ? 1.0 : d));
        } else {
          const int64_t d = static_cast<int64_t>(y.b);
          zero = d == 0;
          const int64_t safe = zero ? 1 : d;
          const uint64_t q = static_cast<uint64_t>(
              div_trunc(static_cast<int64_t>(x.b), safe));
          const uint64_t prod = sext(q * static_cast<uint64_t>(safe), a);
          x.b = sext(x.b - prod, a);
        }
        x.ok = x.ok && y.ok && !zero;
        break;
      }
      case OP_CMP: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        x.b = cmp_val(a, x.b, y.b, static_cast<int>(I[2])) ? 1u : 0u;
        x.ok = x.ok && y.ok;
        break;
      }
      case OP_AND:
      case OP_OR: {
        const Val y = st[--sp];
        Val& x = st[sp - 1];
        const bool lv = x.b != 0, rv = y.b != 0, ln = x.ok, rn = y.ok;
        if (op == OP_AND) {
          x.b = (lv && rv) ? 1u : 0u;
          x.ok = (ln && rn) || (ln && !lv) || (rn && !rv);
        } else {
          x.b = (lv || rv) ? 1u : 0u;
          x.ok = (ln && rn) || (ln && lv) || (rn && rv);
        }
        break;
      }
      case OP_NOT:
        st[sp - 1].b = st[sp - 1].b == 0 ? 1u : 0u;
        break;
      case OP_NEG:
        if (a == T_F32) st[sp - 1].b ^= 0x80000000ull;
        else if (a == T_F64) st[sp - 1].b ^= 0x8000000000000000ull;
        else st[sp - 1].b = sext(0ull - st[sp - 1].b, a);
        break;
      case OP_ISNULL:
      case OP_ISNOTNULL: {
        const bool present = st[sp - 1].ok;
        st[sp - 1].b = (op == OP_ISNOTNULL) == present ? 1u : 0u;
        st[sp - 1].ok = true;
        break;
      }
      case OP_CASE_BEGIN:
        st[sp].b = 0;
        st[sp].ok = true;
        ++sp;
        break;
      case OP_CASE_WHEN: {
        const Val val = st[--sp];
        const Val cond = st[--sp];
        Val& taken = st[sp - 1];
        Val& acc = st[sp - 2];
        const bool cv = cond.b != 0 && cond.ok && taken.b == 0;
        if (cv) {
          acc.b = val.b;
          acc.ok = val.ok;
          taken.b = 1;
        }
        break;
      }
      case OP_CASE_END:
        --sp;
        break;
      case OP_TUMBLE_START:
      case OP_TUMBLE_END: {
        const int64_t x = static_cast<int64_t>(st[sp - 1].b);
        const int64_t w = I[1];
        uint64_t z = static_cast<uint64_t>(x) -
                     static_cast<uint64_t>(floormod(x, w));
        if (op == OP_TUMBLE_END) z += static_cast<uint64_t>(w);
        st[sp - 1].b = z;
        break;
      }
      case OP_EXTRACT_EPOCH: {
        const int64_t x = static_cast<int64_t>(st[sp - 1].b);
        const int64_t us = 1000000;
        const uint64_t whole = static_cast<uint64_t>(floordiv(x, us));
        const uint64_t frac = static_cast<uint64_t>(floormod(x, us));
        st[sp - 1].b =
            whole * static_cast<uint64_t>(kDec) +
            static_cast<uint64_t>(floordiv(
                static_cast<int64_t>(frac * static_cast<uint64_t>(kDec)),
                us));
        break;
      }
      default:
        break;
    }
  }
  return st[0];
}

__device__ __forceinline__ Val run_out(const Ctx& C, int j, long long r) {
  const int64_t* ot = C.p + C.p[H_OUTTAB] + 3 * j;
  return run(C, static_cast<int>(ot[0]), static_cast<int>(ot[1]), r);
}

__device__ __forceinline__ int out_type(const Ctx& C, int j) {
  return static_cast<int>(C.p[C.p[H_OUTTAB] + 3 * j + 2]);
}

// predicate bits of row r: bit k = pred k is TRUE (not NULL)
__device__ unsigned pred_bits(const Ctx& C, long long r) {
  unsigned bits = 0;
  const int np = static_cast<int>(C.p[H_NPRED]);
  const int64_t* pt = C.p + C.p[H_PREDTAB];
  for (int k = 0; k < np; ++k) {
    const Val v = run(C, static_cast<int>(pt[2 * k]),
                      static_cast<int>(pt[2 * k + 1]), r);
    if (v.b != 0 && v.ok) bits |= 1u << k;
  }
  return bits;
}

// row i + d, rolled inside the segment that holds row i
__device__ __forceinline__ long long wrap_row(const Ctx& C, long long i,
                                              long long d) {
  const long long base = i - i % C.seg;
  long long r = (i - base + d) % C.seg;
  if (r < 0) r += C.seg;
  return base + r;
}

// visibility before the predicates: raw vis, the hop's NULL-timestamp
// mask and (with `wm`) the watermark late mask
__device__ void base_vis(const Ctx& C, long long r, bool& vis_in,
                         bool& vis_wm) {
  const long long s = r % C.n;
  bool v = C.raw[s * C.w + 1] != 0;
  const int hop_ts = static_cast<int>(C.p[H_HOP_TS]);
  if (hop_ts >= 0) v = v && load_col(C, hop_ts, r).ok;
  vis_in = v;
  const int wm_ts = static_cast<int>(C.p[H_WM_TS]);
  if (wm_ts >= 0 && v) {
    const Val ts = load_col(C, wm_ts, r);
    const Val thr = load_col(C, static_cast<int>(C.p[H_WM_THR]), r);
    if (ts.ok && static_cast<int64_t>(ts.b) < static_cast<int64_t>(thr.b))
      v = false;
  }
  vis_wm = v;
}

__device__ __forceinline__ int raw_op(const Ctx& C, long long r) {
  return static_cast<int>(C.raw[(r % C.n) * C.w]);
}

// output columns of rows a and b equal (values and validities), and the
// host passthrough columns too
__device__ bool same_rows(const Ctx& C, long long a, long long b) {
  if (C.host_same != nullptr && C.host_same[a % C.n] == 0) return false;
  const int nout = static_cast<int>(C.p[H_NOUT]);
  for (int j = 0; j < nout; ++j) {
    const Val x = run_out(C, j, a);
    const Val y = run_out(C, j, b);
    const bool eq = cmp_val(0, x.b, y.b, out_type(C, j));
    if (!((eq && x.ok && y.ok) || (!x.ok && !y.ok))) return false;
  }
  return true;
}

__device__ __forceinline__ uint64_t key_word(Val v, int t) {
  if (!v.ok) return 0;
  if (is_float(t)) {
    double d = widen(v.b, t);
    if (d == 0.0) d = 0.0;          // -0.0 groups with 0.0
    return f64_bits(d);
  }
  return v.b;
}

__device__ __forceinline__ uint64_t pay_word(Val v, int t) {
  if (!v.ok) return 0;
  return is_float(t) ? f64_bits(widen(v.b, t)) : v.b;
}

__device__ __forceinline__ void put_hi_lo(int32_t* o, uint64_t w) {
  o[0] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
  o[1] = static_cast<int32_t>(static_cast<uint32_t>(w));
}

__device__ __forceinline__ uint64_t chain_word(uint64_t b, int t) {
  return is_float(t) ? f64_bits(widen(b, t)) : b;
}

// the encode section: lanes of one output row (agg / join modes)
__device__ void encode(const Ctx& C, const Val* outs, bool vis, int ops,
                       int32_t* o) {
  const int ne = static_cast<int>(C.p[H_NENC]);
  const int64_t* et = C.p + C.p[H_ENC];
  int at = 0;
  for (int i = 0; i < ne; ++i) {
    const int e = static_cast<int>(et[2 * i]);
    const int j = static_cast<int>(et[2 * i + 1]);
    switch (e) {
      case E_SIGN:
        o[at++] = (ops == OP_INSERT || ops == OP_UI) ? 1 : -1;
        break;
      case E_VIS:
        o[at++] = vis ? 1 : 0;
        break;
      case E_KEY:
      case E_PAY: {
        const int t = out_type(C, j);
        const uint64_t w = e == E_KEY ? key_word(outs[j], t)
                                      : pay_word(outs[j], t);
        put_hi_lo(o + at, w);
        o[at + 2] = outs[j].ok ? 1 : 0;
        at += 3;
        break;
      }
      case E_SUM_INT: {
        const int64_t v = static_cast<int64_t>(outs[j].b);
        for (int k = 0; k < 3; ++k)
          o[at++] = static_cast<int32_t>((v >> (17 * k)) & 0x1FFFF);
        o[at++] = static_cast<int32_t>(v >> 51);
        break;
      }
      case E_SUM_FLOAT: {
        const double d = widen(outs[j].b, out_type(C, j));
        const float hi = __double2float_rn(d);
        const float lo =
            __double2float_rn(__dsub_rn(d, static_cast<double>(hi)));
        o[at++] = __float_as_int(hi);
        o[at++] = __float_as_int(lo);
        break;
      }
      case E_ORDER: {
        const int t = out_type(C, j);
        uint64_t m;
        if (is_float(t)) {
          double d = widen(outs[j].b, t);
          if (d == 0.0) d = 0.0;
          const uint64_t u = f64_bits(d);
          m = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
        } else {
          m = outs[j].b ^ 0x8000000000000000ull;
        }
        o[at++] = static_cast<int32_t>(static_cast<uint32_t>(m >> 32) ^
                                       0x80000000u);
        o[at++] = static_cast<int32_t>(static_cast<uint32_t>(m) ^
                                       0x80000000u);
        break;
      }
      case E_VALID:
        o[at++] = outs[j].ok ? 1 : 0;
        break;
      default:
        break;
    }
  }
}

__device__ __forceinline__ int degrade(int prev, int cur, int next, bool pp,
                                       bool pc, bool pn) {
  if (cur == OP_UD && next == OP_UI && pc && !pn) return OP_DELETE;
  if (cur == OP_UI && prev == OP_UD && pc && !pp) return OP_INSERT;
  return cur;
}

__global__ void fused_kernel(const int64_t* __restrict__ prog, int prog_len,
                             const int64_t* __restrict__ raw, long long n,
                             int w, const int8_t* __restrict__ host_same,
                             void* out, int out_w,
                             unsigned long long* counts, long long seg) {
  extern __shared__ int64_t sprog[];
  for (int i = threadIdx.x; i < prog_len; i += blockDim.x) sprog[i] = prog[i];
  __syncthreads();
  Ctx C;
  C.p = sprog;
  C.raw = raw;
  C.n = n;
  C.w = w;
  C.m = n * sprog[H_UNITS];
  C.seg = seg > 0 ? seg : C.m;
  C.host_same = host_same;
  const int mode = static_cast<int>(sprog[H_MODE]);
  const int nout = static_cast<int>(sprog[H_NOUT]);
  const int K = static_cast<int>(sprog[H_NPRED]);
  const int ncount = static_cast<int>(sprog[H_NCOUNT]);
  const bool has_wm = sprog[H_WM_TS] >= 0;
  const bool drop_pairs = sprog[H_DROP] != 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x;
       base < C.m; base += stride) {
    const long long i = base + threadIdx.x;
    const bool active = i < C.m;
    bool flags[kMaxCounts];
    for (int c = 0; c < kMaxCounts; ++c) flags[c] = false;
    if (active) {
      Val outs[kMaxOut];
      for (int j = 0; j < nout; ++j) outs[j] = run_out(C, j, i);
      if (mode == MODE_JOIN) {
        encode(C, outs, false, 0,
               static_cast<int32_t*>(out) + i * static_cast<long long>(out_w));
      } else {
        // ops of rows i-R .. i+R after each predicate's degradation
        const int R = K + 1;
        const int W = 2 * R + 1;
        int opw[kWin];
        unsigned pb[kWin];
        bool vin[3], vwm[3];
        for (int t = 0; t < W; ++t) {
          const long long r = wrap_row(C, i, t - R);
          opw[t] = raw_op(C, r);
          pb[t] = K > 0 ? pred_bits(C, r) : 0u;
          if (t >= R - 1 && t <= R + 1) base_vis(C, r, vin[t - R + 1],
                                                 vwm[t - R + 1]);
        }
        for (int k = 0; k < K; ++k) {
          int nw[kWin];
          for (int t = k + 1; t <= W - 2 - k; ++t) {
            nw[t] = degrade(opw[t - 1], opw[t], opw[t + 1],
                            (pb[t - 1] >> k) & 1u, (pb[t] >> k) & 1u,
                            (pb[t + 1] >> k) & 1u);
          }
          for (int t = k + 1; t <= W - 2 - k; ++t) opw[t] = nw[t];
        }
        const unsigned all = (1u << K) - 1u;
        bool vis2[3];
        for (int d = 0; d < 3; ++d)
          vis2[d] = vwm[d] && (pb[R - 1 + d] & all) == all;
        const int ops_i = opw[R];
        bool vis = vis2[1];
        if (drop_pairs) {
          const long long ip = wrap_row(C, i, 1);
          const long long im = wrap_row(C, i, -1);
          const bool pair_i = vis2[1] && vis2[2] && opw[R] == OP_UD &&
                              opw[R + 1] == OP_UI;
          const bool pair_m = vis2[0] && vis2[1] && opw[R - 1] == OP_UD &&
                              opw[R] == OP_UI;
          if (pair_i && same_rows(C, i, ip)) vis = false;
          if (pair_m && same_rows(C, im, i)) vis = false;
        }
        int c = 0;
        flags[c++] = vin[1];
        if (has_wm) flags[c++] = vwm[1];
        for (int k = 0; k < K; ++k) {
          const unsigned mk = (1u << (k + 1)) - 1u;
          flags[c++] = vwm[1] && (pb[R] & mk) == mk;
        }
        flags[c++] = vis;
        if (mode == MODE_CHAIN) {
          int64_t* o = static_cast<int64_t*>(out) +
                       i * static_cast<long long>(out_w);
          for (int j = 0; j < nout; ++j) {
            o[2 * j] = static_cast<int64_t>(
                chain_word(outs[j].b, out_type(C, j)));
            o[2 * j + 1] = outs[j].ok ? 1 : 0;
          }
          o[2 * nout] = vis ? 1 : 0;
          o[2 * nout + 1] = ops_i;
        } else {
          encode(C, outs, vis, ops_i,
                 static_cast<int32_t*>(out) +
                     i * static_cast<long long>(out_w));
        }
      }
    }
    if (counts != nullptr) {
      for (int c = 0; c < ncount; ++c) {
        const int cnt = __syncthreads_count(flags[c] ? 1 : 0);
        if (threadIdx.x == 0 && cnt > 0)
          atomicAdd(counts + c, static_cast<unsigned long long>(cnt));
      }
    }
  }
}

// the Python wrapper checks that the program's mode is the entry point's,
// and that a segment length divides the rows of a program without hop
// expansion
int launch(const int64_t* prog, int prog_len, const int64_t* raw,
           long long n, int w, const int8_t* host_same, void* out, int out_w,
           int64_t* counts, long long seg, cudaStream_t stream) {
  if (prog_len <= 0 || prog_len > kProgMax || n < 0 || seg < 0 ||
      (seg > 0 && n % seg != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  // grid-stride: hop-expanded rows (n * units) loop over the same grid
  const long long m_blocks = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(m_blocks < 8192 ? m_blocks : 8192);
  const size_t smem = static_cast<size_t>(prog_len) * sizeof(int64_t);
  fused_kernel<<<blocks, kThreads, smem, stream>>>(
      prog, prog_len, raw, n, w, host_same, out, out_w,
      reinterpret_cast<unsigned long long*>(counts), seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

RW_API int rw_fused_chain(const int64_t* prog, int prog_len,
                          const int64_t* raw, long long n, int w,
                          const int8_t* host_same, int64_t* out, int out_w,
                          int64_t* counts, cudaStream_t stream) {
  return launch(prog, prog_len, raw, n, w, host_same, out, out_w,
                counts, 0, stream);
}

// seg > 0: the rows are n / seg blocks of seg rows, each its own ring
RW_API int rw_agg_prelude(const int64_t* prog, int prog_len,
                          const int64_t* raw, long long n, int w,
                          const int8_t* host_same, int32_t* out, int out_w,
                          int64_t* counts, long long seg,
                          cudaStream_t stream) {
  return launch(prog, prog_len, raw, n, w, host_same, out, out_w,
                counts, seg, stream);
}

RW_API int rw_join_prelude(const int64_t* prog, int prog_len,
                           const int64_t* raw, long long n, int w,
                           const int8_t* host_same, int32_t* out, int out_w,
                           int64_t* counts, cudaStream_t stream) {
  return launch(prog, prog_len, raw, n, w, host_same, out, out_w,
                counts, 0, stream);
}
