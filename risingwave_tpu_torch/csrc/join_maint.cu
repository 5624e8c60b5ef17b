// Kernel K7: join_maint — maintenance writes of a join side's row arrays.
//
// masked_scatter replaces risingwave_tpu/ops/hash_join.py:361
// _masked_scatter (with its host staging, :375 _pad_scatter_args) and
// rebase replaces :457 _rebase_jit (both B17). The third B17 program,
// :446 _remap_head, runs on K4's remap (csrc/rebuild.cu) over the one
// head row with fill -1.
//
// masked_scatter has two modes over n rows i, each row visible when the
// visibility array is null or vis[i] != 0:
//   scatter: dst[idx[i]] := src[i]       (a degree write by ref)
//   gather:  dst[i]      := src[idx[i]]  (compaction's carry: the live
//                                        refs' degrees into the fresh
//                                        array, dense i < n)
// Rows are `width` int32 lanes (1: the degree array; P: payload rows).
// idx, vis and src are read with a row stride, so a column of a matrix
// already on the card is an operand as it lies: the refs column of the
// reload's staged aux, the degree column mat[1:1+n, 0] of K6's matrix.
// An index outside [0, rows) of the array it indexes is dropped, a
// negative one included (ROADMAP queue C: the reference wraps it). The
// scatter's refs are distinct, as in the reference, so no write races.
//
// rebase: one elementwise pass; every finite ins/del sequence becomes 0,
// I32_MAX (never inserted / live) stays.
//
// What bounds them on the card. At the paths' shapes (1,536 to 40,000
// rows, 1-D) masked_scatter's bytes take 0.007-0.67 us against a launch
// floor of ~2.5 us and one DRAM round trip a dependent load: it is
// latency-bound. So it is one launch with no second pass and no fill
// ahead of it (a null vis replaces the all-ones array), each thread
// takes four rows and issues all their loads before any store (a
// 16-byte load of four indices, and of four values, where the column is
// contiguous and aligned; a 16-byte store of four gathered rows where
// all four are visible), and the callers pass device columns, so no
// upload, fill or host round trip sits in the chain. Payload rows (no
// path writes them here since their lanes ride in K5's launch; the
// masked mode's checks do) take a thread a row. rebase reads and
// writes both sequence arrays once: bytes.
#include "common.cuh"

namespace {

constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread

struct Maint {
  int32_t* dst;
  long long dst_rows;
  int width;
  const int32_t* idx;
  long long idx_stride;
  const int32_t* vis;  // null: every row visible
  long long vis_stride;
  const int32_t* src;
  long long src_stride;  // ints from one source row to the next
  long long src_rows;
  int n;
};

// Rows i0 .. i0+3 of a strided int32 column (0 past n): one 16-byte load
// where the four lie contiguous and 16-byte aligned.
__device__ __forceinline__ void load4(const int32_t* p, long long stride,
                                      long long i0, int n,
                                      int32_t out[kRows]) {
  const int32_t* q = p + i0 * stride;
  if (stride == 1 && i0 + kRows <= n &&
      (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(q));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    out[j] = i0 + j < n ? __ldg(p + (i0 + j) * stride) : 0;
  }
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads) masked_scatter_kernel(Maint a) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kRows;
  if (i0 >= a.n) return;
  int32_t r[kRows], v[kRows];
  bool ok[kRows];
  load4(a.idx, a.idx_stride, i0, a.n, r);
  if (a.vis != nullptr) {
    load4(a.vis, a.vis_stride, i0, a.n, v);
  }
  // the array the index points into: the source when gathering
  const long long lim = kGather ? a.src_rows : a.dst_rows;
  bool all = true;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    ok[j] = i0 + j < a.n && (a.vis == nullptr || v[j] != 0) && r[j] >= 0 &&
            r[j] < lim;
    all &= ok[j];
  }
  if (kGather) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      v[j] = ok[j] ? __ldg(a.src + r[j] * a.src_stride) : 0;
    }
    int32_t* d = a.dst + i0;
    if (all && (reinterpret_cast<uintptr_t>(d) & 15) == 0) {
      *reinterpret_cast<int4*>(d) = make_int4(v[0], v[1], v[2], v[3]);
      return;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (ok[j]) d[j] = v[j];
    }
  } else {
    load4(a.src, a.src_stride, i0, a.n, v);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (ok[j]) a.dst[r[j]] = v[j];
    }
  }
}

// Payload rows (width > 1): a thread a row, its lanes in order (a
// thread a lane was slower on an H100 at q8's 2^20 rows x 6 lanes: six
// threads read each row's ref and divide for their lane).
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
    masked_scatter_rows_kernel(Maint a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  if (a.vis != nullptr && __ldg(a.vis + i * a.vis_stride) == 0) return;
  const long long r = __ldg(a.idx + i * a.idx_stride);
  if (r < 0 || r >= (kGather ? a.src_rows : a.dst_rows)) return;
  const int32_t* s = a.src + (kGather ? r : i) * a.src_stride;
  int32_t* d = a.dst + (kGather ? i : r) * a.width;
  for (int c = 0; c < a.width; ++c) d[c] = __ldg(s + c);
}

template <bool kGather>
void launch(const Maint& a, cudaStream_t st) {
  if (a.width == 1) {
    masked_scatter_kernel<kGather>
        <<<rw::blocks_for(a.n, kThreads * kRows), kThreads, 0, st>>>(a);
  } else {
    masked_scatter_rows_kernel<kGather>
        <<<rw::blocks_for(a.n, kThreads), kThreads, 0, st>>>(a);
  }
}

__global__ void rebase_kernel(int32_t* __restrict__ ins_seq,
                              int32_t* __restrict__ del_seq, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  if (ins_seq[i] != kI32Max) ins_seq[i] = 0;
  if (del_seq[i] != kI32Max) del_seq[i] = 0;
}

}  // namespace

// gather = 0: dst[idx[i]] := src[i]; gather = 1: dst[i] := src[idx[i]]
// (i < n <= dst_rows). dst int32[dst_rows, width] contiguous; src rows
// `src_stride` ints apart with unit lane stride; vis may be null.
RW_API int rw_masked_scatter(int gather, void* dst, long long dst_rows,
                             int width, const void* idx,
                             long long idx_stride, const void* vis,
                             long long vis_stride, const void* src,
                             long long src_stride, long long src_rows, int n,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const Maint a{static_cast<int32_t*>(dst), dst_rows, width,
                  static_cast<const int32_t*>(idx), idx_stride,
                  static_cast<const int32_t*>(vis), vis_stride,
                  static_cast<const int32_t*>(src), src_stride, src_rows, n};
    if (gather) {
      launch<true>(a, st);
    } else {
      launch<false>(a, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

RW_API int rw_rebase(void* ins_seq, void* del_seq, long long n,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    constexpr int kRebaseThreads = 256;
    rebase_kernel<<<rw::blocks_for(n, kRebaseThreads), kRebaseThreads, 0,
                    st>>>(static_cast<int32_t*>(ins_seq),
                          static_cast<int32_t*>(del_seq), n);
  }
  return static_cast<int>(cudaGetLastError());
}
