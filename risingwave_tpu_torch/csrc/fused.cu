// Fused filter/project preludes: one expression-program interpreter, three
// entry points (risingwave_tpu_torch/ops/fused.py).
//
//   rw_fused_chain   B18  ops/fused.py:839 build_chain_step (chain_body
//                         :697, hop :776, noop-pair drop :809)
//   rw_agg_prelude   B19  ops/fused.py:877 build_agg_prelude
//   rw_join_prelude  B20  ops/fused.py:930 build_join_prelude
//   (references are to risingwave_tpu/)
//
// The program. ops/fused.py compiles a composed filter/project run at plan
// time into a flat int64 program: a header, a column table (which raw
// column or hop synthesis feeds each body column), one postfix sub-program
// per predicate and per output column (typed opcodes, 4 words each) and an
// encode section. Values are 64-bit words with a validity bit: ints
// sign-extended from their width (arithmetic in uint64, then sign-extended
// again, as numpy and XLA wrap), bool 0/1, f32 as float bits in the low
// word, f64 as double bits. Float arithmetic uses the _rn intrinsics and
// the library is built with -fmad=false: no contraction. A float division
// by a constant is x * (1 / c), and DECIMAL → float multiplies by 1 /
// 10^4: XLA's algebraic simplifier rewrites the reference's traced
// divisions so, and the port is held to that function.
//
// Neighbour rows. Filter pair degradation and the noop-pair drop read rows
// i-1 and i+1, rolled with wrap-around over the (hop-expanded) row range as
// xp.roll does; K composed predicates degrade in turn, so row i's op
// depends on rows i-1-K .. i+1+K. Batched raw matrices carry an always-
// invisible separator row per chunk, so no pair spans two chunks. With a
// segment length (agg_prelude over the row blocks of a sharded step,
// risingwave_tpu/parallel/agg.py:337 _build_raw_step, where each shard runs
// the prelude on its own block), the rows roll inside their own segment of
// `seg` rows (a ring), not over the whole range.
//
// What bounds it on the card: bytes (the raw matrix read once, the output
// written once) and, above them, the latency of an interpreter that runs a
// program opcode by opcode. So the design keeps a row's work in shared
// memory and spreads it over warps:
//   - tiles: a 256-thread block takes a piece of T = 32-128 rows inside
//     one ring plus R = K + 1 halo rows each side, rolled inside the ring
//     (a ring shorter than the piece and its halo repeats rows; the
//     unrolled slots keep the ring's neighbour order), and loads their raw
//     rows with 16-byte loads into shared memory, in the same round trip
//     as its first piece's copy of the program. T is the largest that
//     still gives the card two blocks an SM (q1's 4,096-row block: 128
//     pieces of 32 rows).
//   - one stage pass: a warp takes a (sub-program, 32 slots) task, a lane a
//     slot, so the lanes of a warp run the same opcodes: each predicate
//     runs once a slot (its bits to shared memory), each output column once
//     a row, each slot's op and base visibility once. Degradation then runs
//     predicate by predicate over the shared ops, and the noop-pair test
//     compares the shared outputs (a halo row's outputs are computed where
//     a visible pair reaches it, which insert-only streams never do).
//   - the evaluation stack keeps its top in registers and the rest in a
//     shared-memory column a thread, as deep as the program's deepest
//     sub-program (the compiler records it); the outputs live in shared
//     memory, so no per-thread array is indexed at run time.
//   - rows are encoded into a shared staging tile placed at the output's
//     offset within 16 bytes, a thread a (row, encode op) item at the
//     op's lane offset (the compiler records those too), and the piece's
//     rows leave as one contiguous range of 16-byte stores.
//   - stage counts: per counter, warp ballots into a block counter in
//     shared memory and one atomicAdd on unsigned long long a block —
//     exact and order-free.
//   - a block's phases are a chain of latencies, so the pieces must run
//     in one wave: at 64 registers a thread four blocks fit an SM, and
//     q7's 2^15-row backlog (512 pieces of 64 rows) takes one wave.
// The interpreter runs the plan-time program as it is; nothing is
// generated at run time. The host reads the program's header (its host
// copy, `hprog`) to size the tiles and the shared memory.
#include "common.cuh"

namespace {

enum Hdr {
  H_MODE = 0, H_NREF, H_NBODY, H_UNITS, H_HOP_TS, H_SLIDE, H_SIZE, H_WM_TS,
  H_WM_THR, H_NPRED, H_NOUT, H_DROP, H_COLTAB, H_PREDTAB, H_OUTTAB, H_ENC,
  H_NENC, H_OUTW, H_NCOUNT, H_LEN, H_DEPTH, H_ENCAT
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
constexpr int kRawMeta = 2;
constexpr int kThreads = 256;
constexpr int64_t kDec = 10000;
constexpr int kProgMax = 4096;
constexpr long long kMaxBlocks = 4096;
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kSmemDefault = 48 * 1024;

struct Val {
  uint64_t b;
  bool ok;
};

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// A launch's shape, read from the program's host copy, and the shared
// memory of one block (byte offsets): the program; per extended slot (a
// piece's T rows and R halo rows each side: E = T + 2R) its expanded row
// and raw row (int64, ws = w + 1 words apart, so the lanes of a warp read
// rows in different banks), op (two buffers), predicate bits and base
// visibility; per output column and row its value and validity; per row
// its final visibility and op; the evaluation stacks (depth - 1 entries a
// thread below the top, an entry's column of kThreads words); the staging
// tile of T encoded rows.
struct Shape {
  int mode, K, R, nout, ncount, ne, depth, w, out_w, esz, prog_len, T, E, ws;
  int coltab, outtab, predtab, encat;     // table positions in the program
  bool has_wm, drop;
  size_t prog, row_of, raw, ob, stack, stage, ook, op, pbk, vin, vwm, vis,
      ops, total;
};

__host__ __device__ inline Shape shape_of(const int64_t* hp, int w, int T) {
  Shape l;
  l.mode = static_cast<int>(hp[H_MODE]);
  l.K = l.mode == MODE_JOIN ? 0 : static_cast<int>(hp[H_NPRED]);
  l.R = l.mode == MODE_JOIN ? 0 : l.K + 1;
  l.nout = static_cast<int>(hp[H_NOUT]);
  l.ncount = static_cast<int>(hp[H_NCOUNT]);
  l.ne = static_cast<int>(hp[H_NENC]);
  l.depth = hp[H_DEPTH] > 0 ? static_cast<int>(hp[H_DEPTH]) : kMaxStack;
  l.w = w;
  l.out_w = static_cast<int>(hp[H_OUTW]);
  l.esz = l.mode == MODE_CHAIN ? 8 : 4;
  l.prog_len = static_cast<int>(hp[H_LEN]);
  l.coltab = static_cast<int>(hp[H_COLTAB]);
  l.outtab = static_cast<int>(hp[H_OUTTAB]);
  l.predtab = static_cast<int>(hp[H_PREDTAB]);
  l.encat = static_cast<int>(hp[H_ENCAT]);
  l.has_wm = hp[H_WM_TS] >= 0;
  l.drop = hp[H_DROP] != 0;
  l.T = T;
  l.E = T + 2 * l.R;
  l.ws = w + 1;
  size_t at = 0;
  l.prog = at;
  at = up16(at + static_cast<size_t>(l.prog_len) * 8);
  l.row_of = at;
  at = up16(at + static_cast<size_t>(l.E) * 8);
  l.raw = at;
  at = up16(at + static_cast<size_t>(l.E) * l.ws * 8);
  l.ob = at;
  at = up16(at + static_cast<size_t>(l.nout) * T * 8);
  l.stack = at;
  at = up16(at + static_cast<size_t>(l.depth - 1) * kThreads * 8);
  l.stage = at;
  at = up16(at + static_cast<size_t>(T) * l.out_w * l.esz + 16);
  l.ook = at;
  at = up16(at + static_cast<size_t>(l.nout) * T);
  l.op = at;
  at = up16(at + 2 * static_cast<size_t>(l.E));
  l.pbk = at;
  at = up16(at + static_cast<size_t>(l.K > 0 ? l.K : 1) * l.E);
  l.vin = at;
  at = up16(at + l.E);
  l.vwm = at;
  at = up16(at + l.E);
  l.vis = at;
  at = up16(at + T);
  l.ops = at;
  at = up16(at + T);
  l.total = at;
  return l;
}

struct Ctx {
  const int64_t* p;          // the program (shared memory)
  const int64_t* coltab;     // its column, output and predicate tables
  const int64_t* outtab;
  const int64_t* predtab;
  const int64_t* raw;        // the piece's raw rows (shared), ws apart
  const long long* row_of;   // the expanded row of each slot (shared)
  long long n;               // raw rows
  int ws;
  uint64_t* stk;             // this thread's stack column (shared)
  const int8_t* host_same;   // int8[n] or null (global)
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

// a raw-matrix body column of slot x
__device__ Val load_raw(const Ctx& C, const int64_t* ct, int x) {
  const int k = static_cast<int>(ct[1]);
  const int t = static_cast<int>(ct[2]);
  const int64_t* row = C.raw + x * C.ws + kRawMeta + 2 * k;
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

// body column c of slot x: a raw column, or a hop window column
// floor(ts / slide) * slide - copy * slide (+ size for window_end)
__device__ Val load_col(const Ctx& C, int c, int x) {
  const int64_t* ct = C.coltab + 3 * c;
  const int kind = static_cast<int>(ct[0]);
  if (kind == C_RAW) return load_raw(C, ct, x);
  const int64_t* tt = C.coltab + 3 * C.p[H_HOP_TS];
  const Val ts = load_raw(C, tt, x);
  const int64_t slide = C.p[H_SLIDE];
  const uint64_t copy = static_cast<uint64_t>(C.row_of[x] / C.n);
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

// One postfix sub-program at slot x. The top of the stack stays in
// registers (tb, tok); the entries below it live in the thread's shared
// column (entry i at stk[i * kThreads]) with their validity bits in okm.
__device__ Val run(const Ctx& C, int start, int n_insn, int x) {
  uint64_t tb = 0;
  bool tok = false;
  uint32_t okm = 0;
  int sp = 0;                      // entries, the top included
  uint64_t* S = C.stk;
  auto push = [&](uint64_t b, bool ok) {
    if (sp > 0) {
      S[(sp - 1) * kThreads] = tb;
      okm = (okm & ~(1u << (sp - 1))) |
            (static_cast<uint32_t>(tok) << (sp - 1));
    }
    tb = b;
    tok = ok;
    ++sp;
  };
  auto pop = [&]() -> Val {
    const Val v{tb, tok};
    --sp;
    if (sp > 0) {
      tb = S[(sp - 1) * kThreads];
      tok = ((okm >> (sp - 1)) & 1u) != 0;
    }
    return v;
  };
  for (int i = 0; i < n_insn; ++i) {
    const int64_t* I = C.p + start + 4 * i;
    const int op = static_cast<int>(I[0]);
    const int a = static_cast<int>(I[1]);
    switch (op) {
      case OP_COL: {
        Val v;
        if (I[2] == C_RAW + 1) {   // raw position and type resolved
          const int64_t ct[3] = {C_RAW, I[3] >> 3, I[3] & 7};
          v = load_raw(C, ct, x);
        } else {
          v = load_col(C, a, x);
        }
        push(v.b, v.ok);
        break;
      }
      case OP_CONST:
        push(static_cast<uint64_t>(I[1]), I[2] != 0);
        break;
      case OP_CAST:
        tb = cast_val(tb, a, static_cast<int>(I[2]));
        break;
      case OP_INT2DEC:
        tb = tb * static_cast<uint64_t>(kDec);
        break;
      case OP_DEC2F: {
        const int64_t v = static_cast<int64_t>(tb);
        tb = a == T_F32
                 ? f32_bits(__fmul_rn(__ll2float_rn(v),
                                      __fdiv_rn(1.0f,
                                                static_cast<float>(kDec))))
                 : f64_bits(__dmul_rn(__ll2double_rn(v),
                                      __ddiv_rn(1.0,
                                                static_cast<double>(kDec))));
        break;
      }
      case OP_ADD:
      case OP_SUB:
      case OP_MUL: {
        const Val y = pop();
        tb = arith(op, tb, y.b, a);
        tok = tok && y.ok;
        break;
      }
      case OP_DECMUL: {
        const Val y = pop();
        tb = static_cast<uint64_t>(
            div_trunc(static_cast<int64_t>(tb * y.b), kDec));
        tok = tok && y.ok;
        break;
      }
      case OP_FDIV: {
        const Val y = pop();
        const bool recip = I[2] != 0;    // constant divisor
        if (a == T_F32) {
          const float d = as_f32(y.b);
          const bool zero = d == 0.0f;
          const float safe = zero ? 1.0f : d;
          tb = f32_bits(recip ? __fmul_rn(as_f32(tb), __fdiv_rn(1.0f, safe))
                              : __fdiv_rn(as_f32(tb), safe));
          tok = tok && y.ok && !zero;
        } else {
          const double d = as_f64(y.b);
          const bool zero = d == 0.0;
          const double safe = zero ? 1.0 : d;
          tb = f64_bits(recip ? __dmul_rn(as_f64(tb), __ddiv_rn(1.0, safe))
                              : __ddiv_rn(as_f64(tb), safe));
          tok = tok && y.ok && !zero;
        }
        break;
      }
      case OP_DECDIV: {
        const Val y = pop();
        const int64_t d = static_cast<int64_t>(y.b);
        const bool zero = d == 0;
        tb = static_cast<uint64_t>(
            div_trunc(static_cast<int64_t>(tb * static_cast<uint64_t>(kDec)),
                      zero ? 1 : d));
        tok = tok && y.ok && !zero;
        break;
      }
      case OP_MOD: {
        const Val y = pop();
        bool zero;
        if (a == T_F32) {
          const float d = as_f32(y.b);
          zero = d == 0.0f;
          tb = f32_bits(fmodf(as_f32(tb), zero ? 1.0f : d));
        } else if (a == T_F64) {
          const double d = as_f64(y.b);
          zero = d == 0.0;
          tb = f64_bits(fmod(as_f64(tb), zero ? 1.0 : d));
        } else {
          const int64_t d = static_cast<int64_t>(y.b);
          zero = d == 0;
          const int64_t safe = zero ? 1 : d;
          const uint64_t q = static_cast<uint64_t>(
              div_trunc(static_cast<int64_t>(tb), safe));
          const uint64_t prod = sext(q * static_cast<uint64_t>(safe), a);
          tb = sext(tb - prod, a);
        }
        tok = tok && y.ok && !zero;
        break;
      }
      case OP_CMP: {
        const Val y = pop();
        tb = cmp_val(a, tb, y.b, static_cast<int>(I[2])) ? 1u : 0u;
        tok = tok && y.ok;
        break;
      }
      case OP_AND:
      case OP_OR: {
        const Val y = pop();
        const bool lv = tb != 0, rv = y.b != 0, ln = tok, rn = y.ok;
        if (op == OP_AND) {
          tb = (lv && rv) ? 1u : 0u;
          tok = (ln && rn) || (ln && !lv) || (rn && !rv);
        } else {
          tb = (lv || rv) ? 1u : 0u;
          tok = (ln && rn) || (ln && lv) || (rn && rv);
        }
        break;
      }
      case OP_NOT:
        tb = tb == 0 ? 1u : 0u;
        break;
      case OP_NEG:
        if (a == T_F32) tb ^= 0x80000000ull;
        else if (a == T_F64) tb ^= 0x8000000000000000ull;
        else tb = sext(0ull - tb, a);
        break;
      case OP_ISNULL:
      case OP_ISNOTNULL: {
        const bool present = tok;
        tb = (op == OP_ISNOTNULL) == present ? 1u : 0u;
        tok = true;
        break;
      }
      case OP_CASE_BEGIN:
        push(0, true);
        break;
      case OP_CASE_WHEN: {
        // ... acc, taken, cond, val: after two pops the top is `taken`
        // and the accumulator is entry sp - 2
        const Val val = pop();
        const Val cond = pop();
        if (cond.b != 0 && cond.ok && tb == 0) {
          S[(sp - 2) * kThreads] = val.b;
          okm = (okm & ~(1u << (sp - 2))) |
                (static_cast<uint32_t>(val.ok) << (sp - 2));
          tb = 1;
        }
        break;
      }
      case OP_CASE_END:
        pop();
        break;
      case OP_TUMBLE_START:
      case OP_TUMBLE_END: {
        const int64_t v = static_cast<int64_t>(tb);
        const int64_t w = I[1];
        uint64_t z = static_cast<uint64_t>(v) -
                     static_cast<uint64_t>(floormod(v, w));
        if (op == OP_TUMBLE_END) z += static_cast<uint64_t>(w);
        tb = z;
        break;
      }
      case OP_EXTRACT_EPOCH: {
        const int64_t v = static_cast<int64_t>(tb);
        const int64_t us = 1000000;
        const uint64_t whole = static_cast<uint64_t>(floordiv(v, us));
        const uint64_t frac = static_cast<uint64_t>(floormod(v, us));
        tb = whole * static_cast<uint64_t>(kDec) +
             static_cast<uint64_t>(floordiv(
                 static_cast<int64_t>(frac * static_cast<uint64_t>(kDec)),
                 us));
        break;
      }
      default:
        break;
    }
  }
  return Val{tb, tok};
}

__device__ __forceinline__ Val run_out(const Ctx& C, int j, int x) {
  const int64_t* ot = C.outtab + 3 * j;
  return run(C, static_cast<int>(ot[0]), static_cast<int>(ot[1]), x);
}

__device__ __forceinline__ int out_type(const Ctx& C, int j) {
  return static_cast<int>(C.outtab[3 * j + 2]);
}

// predicate k at slot x is TRUE (not NULL)
__device__ __forceinline__ bool pred_at(const Ctx& C, int k, int x) {
  const int64_t* pt = C.predtab;
  const Val v = run(C, static_cast<int>(pt[2 * k]),
                    static_cast<int>(pt[2 * k + 1]), x);
  return v.b != 0 && v.ok;
}

// visibility before the predicates: raw vis, the hop's NULL-timestamp
// mask and (with `wm`) the watermark late mask
__device__ void base_vis(const Ctx& C, int x, bool& vis_in, bool& vis_wm) {
  bool v = C.raw[x * C.ws + 1] != 0;
  const int hop_ts = static_cast<int>(C.p[H_HOP_TS]);
  if (hop_ts >= 0) v = v && load_col(C, hop_ts, x).ok;
  vis_in = v;
  const int wm_ts = static_cast<int>(C.p[H_WM_TS]);
  if (wm_ts >= 0 && v) {
    const Val ts = load_col(C, wm_ts, x);
    const Val thr = load_col(C, static_cast<int>(C.p[H_WM_THR]), x);
    if (ts.ok && static_cast<int64_t>(ts.b) < static_cast<int64_t>(thr.b))
      v = false;
  }
  vis_wm = v;
}

// The shared outputs of the piece: value and validity of output j at
// row t are ob[j * T + t], ook[j * T + t].
struct Outs {
  const uint64_t* ob;
  const uint8_t* ook;
  int T, R, rows;
};

// output j at slot x: the stage pass's for a piece row, computed here for
// a halo slot
__device__ __forceinline__ Val out_at(const Ctx& C, const Outs& O, int j,
                                      int x) {
  const int t = x - O.R;
  if (t >= 0 && t < O.rows) {
    return Val{O.ob[j * O.T + t], O.ook[j * O.T + t] != 0};
  }
  return run_out(C, j, x);
}

// output columns of slots a and b equal (values and validities), and the
// host passthrough columns too
__device__ bool same_rows(const Ctx& C, const Outs& O, int a, int b) {
  if (C.host_same != nullptr && C.host_same[C.row_of[a] % C.n] == 0)
    return false;
  const int nout = static_cast<int>(C.p[H_NOUT]);
  for (int j = 0; j < nout; ++j) {
    const Val x = out_at(C, O, j, a);
    const Val y = out_at(C, O, j, b);
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

// encode op i of the encode section for row `row` of the piece: its
// lanes at o (agg / join modes; the op's first lane is at the program's
// lane offset for op i)
__device__ void encode_op(const Ctx& C, const Outs& O, int i, int row,
                          bool vis, int ops, int32_t* o) {
  const int64_t* et = C.p + C.p[H_ENC];
  const int e = static_cast<int>(et[2 * i]);
  const int j = static_cast<int>(et[2 * i + 1]);
  const Val out = j < static_cast<int>(C.p[H_NOUT])
                      ? Val{O.ob[j * O.T + row], O.ook[j * O.T + row] != 0}
                      : Val{0, false};
  int at = 0;
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
      const uint64_t w = e == E_KEY ? key_word(out, t)
                                    : pay_word(out, t);
      put_hi_lo(o + at, w);
      o[at + 2] = out.ok ? 1 : 0;
      at += 3;
      break;
    }
    case E_SUM_INT: {
      const int64_t v = static_cast<int64_t>(out.b);
      for (int k = 0; k < 3; ++k)
        o[at++] = static_cast<int32_t>((v >> (17 * k)) & 0x1FFFF);
      o[at++] = static_cast<int32_t>(v >> 51);
      break;
    }
    case E_SUM_FLOAT: {
      const double d = widen(out.b, out_type(C, j));
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
        double d = widen(out.b, t);
        if (d == 0.0) d = 0.0;
        const uint64_t u = f64_bits(d);
        m = (u >> 63) ? ~u : (u | 0x8000000000000000ull);
      } else {
        m = out.b ^ 0x8000000000000000ull;
      }
      o[at++] = static_cast<int32_t>(static_cast<uint32_t>(m >> 32) ^
                                     0x80000000u);
      o[at++] = static_cast<int32_t>(static_cast<uint32_t>(m) ^
                                     0x80000000u);
      break;
    }
    case E_VALID:
      o[at++] = out.ok ? 1 : 0;
      break;
    default:
      break;
  }
}

__device__ __forceinline__ int degrade(int prev, int cur, int next, bool pp,
                                       bool pc, bool pn) {
  if (cur == OP_UD && next == OP_UI && pc && !pn) return OP_DELETE;
  if (cur == OP_UI && prev == OP_UD && pc && !pp) return OP_INSERT;
  return cur;
}

// the expanded row of slot x of a piece (first row jt of its ring), rolled
// inside the ring
__device__ __forceinline__ long long ring_row(long long rs, long long jt,
                                              int x, int R, long long ring) {
  long long r = jt + x - R;
  if (r < 0 || r >= ring) {
    r %= ring;
    if (r < 0) r += ring;
  }
  return rs + r;
}

__global__ void __launch_bounds__(kThreads) fused_kernel(
    const int64_t* __restrict__ prog, const Shape sh,
    const int64_t* __restrict__ raw, long long n,
    const int8_t* __restrict__ host_same, void* out,
    unsigned long long* counts, long long ring, long long per_ring,
    long long pieces, bool vec) {
  extern __shared__ int4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  __shared__ unsigned s_cnt[kMaxCounts];
  int64_t* sprog = reinterpret_cast<int64_t*>(sm + sh.prog);
  long long* row_of = reinterpret_cast<long long*>(sm + sh.row_of);
  int64_t* rawt = reinterpret_cast<int64_t*>(sm + sh.raw);
  uint64_t* ob = reinterpret_cast<uint64_t*>(sm + sh.ob);
  uint8_t* ook = reinterpret_cast<uint8_t*>(sm + sh.ook);
  int8_t* opb = reinterpret_cast<int8_t*>(sm + sh.op);
  uint8_t* pbk = reinterpret_cast<uint8_t*>(sm + sh.pbk);
  uint8_t* vin = reinterpret_cast<uint8_t*>(sm + sh.vin);
  uint8_t* vwm = reinterpret_cast<uint8_t*>(sm + sh.vwm);
  uint8_t* vis_r = reinterpret_cast<uint8_t*>(sm + sh.vis);
  int8_t* ops_r = reinterpret_cast<int8_t*>(sm + sh.ops);
  char* stage = sm + sh.stage;
  Ctx C;
  C.p = sprog;
  C.coltab = sprog + sh.coltab;
  C.outtab = sprog + sh.outtab;
  C.predtab = sprog + sh.predtab;
  C.raw = rawt;
  C.row_of = row_of;
  C.n = n;
  C.ws = sh.ws;
  C.stk = reinterpret_cast<uint64_t*>(sm + sh.stack) + threadIdx.x;
  C.host_same = host_same;
  if (threadIdx.x < kMaxCounts) s_cnt[threadIdx.x] = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T = sh.T, E = sh.E, R = sh.R, K = sh.K, w = sh.w;
  const int w2 = w / 2;
  const int out_w = sh.out_w, esz = sh.esz, nout = sh.nout;
  for (long long p = blockIdx.x; p < pieces; p += gridDim.x) {
    const long long g = p / per_ring;
    const long long jt = (p - g * per_ring) * T;   // first row in the ring
    const long long rs = g * ring;                 // the ring's first row
    const int rows = static_cast<int>(min(static_cast<long long>(T),
                                          ring - jt));
    const int ee = rows + 2 * R;
    const Outs O{ob, ook, T, R, rows};
    // 1. the program (a block's first piece), the slots' rows rolled
    // inside the ring and their raw rows: one round trip
    if (p == blockIdx.x) {
      for (int i = threadIdx.x; i < sh.prog_len; i += kThreads)
        sprog[i] = prog[i];
    }
    for (int x = threadIdx.x; x < ee; x += kThreads)
      row_of[x] = ring_row(rs, jt, x, R, ring);
    for (int e = threadIdx.x; e < ee * w2; e += kThreads) {
      const int x = e / w2;
      const int c = e - x * w2;
      long long r = ring_row(rs, jt, x, R, ring);
      if (r >= n) r %= n;                          // a hop copy
      const int64_t* src = raw + r * w + 2 * c;
      int64_t* d = rawt + x * sh.ws + 2 * c;
      if (vec) {      // w is even: every row starts 16 bytes aligned
        const longlong2 v = *reinterpret_cast<const longlong2*>(src);
        d[0] = v.x;
        d[1] = v.y;
      } else {
        d[0] = src[0];
        d[1] = src[1];
      }
    }
    __syncthreads();
    // 2. the stage pass: a warp a (sub-program, 32 slots) task
    const int ge = (ee + 31) / 32;
    const int gt = (rows + 31) / 32;
    const int n_base = sh.mode == MODE_JOIN ? 0 : ge;
    const int n_pred = K * ge;
    const int n_task = n_base + n_pred + nout * gt;
    for (int task = warp; task < n_task; task += kThreads / 32) {
      if (task < n_base) {
        const int x = task * 32 + lane;
        if (x < ee) {
          opb[x] = static_cast<int8_t>(rawt[x * sh.ws]);
          if (x >= R - 1 && x <= R + rows) {
            bool a, b;
            base_vis(C, x, a, b);
            vin[x] = a;
            vwm[x] = b;
          }
        }
      } else if (task < n_base + n_pred) {
        const int q = task - n_base;
        const int k = q / ge;
        const int x = (q - k * ge) * 32 + lane;
        if (x < ee) pbk[k * E + x] = pred_at(C, k, x);
      } else {
        const int q = task - n_base - n_pred;
        const int j = q / gt;
        const int t = (q - j * gt) * 32 + lane;
        if (t < rows) {
          const Val v = run_out(C, j, R + t);
          ob[j * T + t] = v.b;
          ook[j * T + t] = v.ok;
        }
      }
    }
    __syncthreads();
    // 3. filter-pair degradation, predicate by predicate
    int cur = 0;
    for (int k = 0; k < K; ++k) {
      const int8_t* a = opb + cur * E;
      int8_t* b = opb + (1 - cur) * E;
      const uint8_t* pk = pbk + k * E;
      for (int x = k + 1 + threadIdx.x; x < ee - 1 - k; x += kThreads) {
        b[x] = static_cast<int8_t>(degrade(a[x - 1], a[x], a[x + 1],
                                           pk[x - 1], pk[x], pk[x + 1]));
      }
      __syncthreads();
      cur = 1 - cur;
    }
    const int8_t* opf = opb + cur * E;
    // 4. a thread a row: visibility, the noop-pair drop and the counts
    if (sh.mode != MODE_JOIN) {
      const int t = threadIdx.x;
      unsigned fl = 0;
      if (t < rows) {
        const int x = R + t;
        const unsigned all = (1u << K) - 1u;
        unsigned pb[3];
        bool vis2[3];
        for (int d = 0; d < 3; ++d) {
          pb[d] = 0;
          for (int k = 0; k < K; ++k)
            pb[d] |= static_cast<unsigned>(pbk[k * E + x - 1 + d]) << k;
          vis2[d] = vwm[x - 1 + d] && (pb[d] & all) == all;
        }
        bool vis = vis2[1];
        if (sh.drop) {
          const bool pair_i = vis2[1] && vis2[2] && opf[x] == OP_UD &&
                              opf[x + 1] == OP_UI;
          const bool pair_m = vis2[0] && vis2[1] && opf[x - 1] == OP_UD &&
                              opf[x] == OP_UI;
          if (pair_i && same_rows(C, O, x, x + 1)) vis = false;
          if (pair_m && same_rows(C, O, x - 1, x)) vis = false;
        }
        vis_r[t] = vis;
        ops_r[t] = opf[x];
        int c = 0;
        fl |= static_cast<unsigned>(vin[x] != 0) << c++;
        if (sh.has_wm) fl |= static_cast<unsigned>(vwm[x] != 0) << c++;
        for (int k = 0; k < K; ++k) {
          const unsigned mk = (1u << (k + 1)) - 1u;
          fl |= static_cast<unsigned>(vwm[x] != 0 && (pb[1] & mk) == mk)
                << c++;
        }
        fl |= static_cast<unsigned>(vis) << c++;
      }
      if (counts != nullptr) {
        for (int c = 0; c < sh.ncount; ++c) {
          const unsigned b = __ballot_sync(0xffffffffu, (fl >> c) & 1u);
          if (lane == 0 && b != 0u) atomicAdd(&s_cnt[c], __popc(b));
        }
      }
      __syncthreads();
    }
    // 5. the encoded rows into the staging tile, a thread a (row, encode
    // op) item (chain mode: a (row, output column) item and a (row,
    // vis/op) item), then one contiguous range of 16-byte stores
    char* dst = static_cast<char*>(out) + (rs + jt) * out_w * esz;
    char* tile = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
    const int n_items = sh.mode == MODE_CHAIN ? nout + 1 : sh.ne;
    const int64_t* encat = sprog + sh.encat;
    for (int item = threadIdx.x; item < rows * n_items; item += kThreads) {
      const int i = item / rows;
      const int t = item - i * rows;
      if (sh.mode == MODE_CHAIN) {
        int64_t* o = reinterpret_cast<int64_t*>(tile) + t * out_w + 2 * i;
        if (i < nout) {
          o[0] = static_cast<int64_t>(chain_word(ob[i * T + t],
                                                 out_type(C, i)));
          o[1] = ook[i * T + t] ? 1 : 0;
        } else {
          o[0] = vis_r[t] ? 1 : 0;
          o[1] = ops_r[t];
        }
      } else {
        const bool join = sh.mode == MODE_JOIN;
        encode_op(C, O, i, t, join ? false : vis_r[t] != 0,
                  join ? 0 : ops_r[t],
                  reinterpret_cast<int32_t*>(tile) + t * out_w + encat[i]);
      }
    }
    __syncthreads();
    rw::store_ints(reinterpret_cast<int32_t*>(dst),
                   reinterpret_cast<const int32_t*>(tile),
                   static_cast<long long>(rows) * out_w * (esz / 4));
    __syncthreads();
  }
  if (counts != nullptr && threadIdx.x < sh.ncount &&
      s_cnt[threadIdx.x] > 0u) {
    atomicAdd(counts + threadIdx.x,
              static_cast<unsigned long long>(s_cnt[threadIdx.x]));
  }
}

// The host copy of the program (`hprog`) gives the launch its shape; the
// Python wrapper passes the same program's device copy and checks the
// entry point's mode and that a segment length divides the rows of a
// program without hop expansion (checked here again).
int launch(const int64_t* prog, const int64_t* hprog, int prog_len,
           const int64_t* raw, long long n, int w, const int8_t* host_same,
           void* out, int out_w, int64_t* counts, long long seg, int mode,
           cudaStream_t stream) {
  if (hprog == nullptr || prog_len <= H_ENCAT || prog_len > kProgMax ||
      n < 0 || seg < 0 || (seg > 0 && n % seg != 0) ||
      hprog[H_MODE] != mode || hprog[H_LEN] != prog_len ||
      w != kRawMeta + 2 * hprog[H_NREF] || out_w != hprog[H_OUTW] ||
      hprog[H_NPRED] > kMaxPred || hprog[H_NOUT] > kMaxOut ||
      hprog[H_DEPTH] > kMaxStack || hprog[H_UNITS] < 1 ||
      (seg > 0 && hprog[H_UNITS] != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const long long m = n * hprog[H_UNITS];
  const long long ring = seg > 0 ? seg : m;
  // the largest tile (128, 64, 32 rows, no larger than a short ring
  // needs) that still leaves two blocks an SM
  int dev = 0, sms = 0;
  const int rc = rw::sm_count(&dev, &sms);
  if (rc != 0) return rc;
  const long long target_pieces = 2LL * sms;
  int T = 0;
  long long per_ring = 0, pieces = 0;
  for (int t = 128; t >= 32; t /= 2) {
    if ((t > 32 && t / 2 >= ring) || shape_of(hprog, w, t).total > kSmemMax)
      continue;
    T = t;
    per_ring = (ring + T - 1) / T;
    pieces = (m / ring) * per_ring;
    if (pieces >= target_pieces) break;
  }
  if (T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(hprog, w, T);
  if (sh.total > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = static_cast<int>(pieces < kMaxBlocks ? pieces
                                                          : kMaxBlocks);
  fused_kernel<<<blocks, kThreads, sh.total, stream>>>(
      prog, sh, raw, n, host_same, out,
      reinterpret_cast<unsigned long long*>(counts), ring, per_ring, pieces,
      (reinterpret_cast<uintptr_t>(raw) & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// prog: the program's words on the card; hprog: the same words on the host
RW_API int rw_fused_chain(const int64_t* prog, const int64_t* hprog,
                          int prog_len, const int64_t* raw, long long n,
                          int w, const int8_t* host_same, int64_t* out,
                          int out_w, int64_t* counts, cudaStream_t stream) {
  return launch(prog, hprog, prog_len, raw, n, w, host_same, out, out_w,
                counts, 0, MODE_CHAIN, stream);
}

// seg > 0: the rows are n / seg blocks of seg rows, each its own ring
RW_API int rw_agg_prelude(const int64_t* prog, const int64_t* hprog,
                          int prog_len, const int64_t* raw, long long n,
                          int w, const int8_t* host_same, int32_t* out,
                          int out_w, int64_t* counts, long long seg,
                          cudaStream_t stream) {
  return launch(prog, hprog, prog_len, raw, n, w, host_same, out, out_w,
                counts, seg, MODE_AGG, stream);
}

RW_API int rw_join_prelude(const int64_t* prog, const int64_t* hprog,
                           int prog_len, const int64_t* raw, long long n,
                           int w, const int8_t* host_same, int32_t* out,
                           int out_w, int64_t* counts, cudaStream_t stream) {
  return launch(prog, hprog, prog_len, raw, n, w, host_same, out, out_w,
                counts, 0, MODE_JOIN, stream);
}
