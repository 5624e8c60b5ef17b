// Kernel K2: agg_apply — accumulate one packed batch into grouped-agg
// state, after K1 has placed every row in a slot.
//
// Replaces the accumulator half of risingwave_tpu/ops/hash_agg.py:519
// build_apply (core :540, per-call updates _update_call :392) (B4).
//
// Input: the packed int32[N, W] batch of pack_chunk (key lanes | sign |
// vis | per call: input lanes + valid), the slots of K1, and the state
// matrix st[R, cap] (layout in common.cuh). A call descriptor int32[C, 4]
// gives per call (kind, first acc row, first input column, valid column
// or -1 for count(*)).
//
// Per visible row with a slot, one thread:
//   phase 0: group_rows += sign, dirty = 1;
//            COUNT        atomicAdd sign
//            SUM (int)    four 17-bit limb atomicAdds of sign * limb
//            SUM (float)  atomicAdd on the (hi, lo) f32 pair
//            MIN/MAX      non-null count; for inserts, atomicMax/Min on
//                         the hi lane, and a thread that RAISED hi resets
//                         lo to the identity (the old lo belonged to a
//                         smaller hi)
//   phase 1: MIN/MAX      rows whose hi equals the settled hi fold their lo
//                         in with atomicMax/Min
// This is the reference's two-pass lexicographic (hi, lo) rule (:430-453),
// bit for bit: after both phases (hi, lo) is the lexicographic extreme of
// the old pair and the rows' pairs.
//
// Integer SUM: limb adds of at most MAX_CHUNK_ROWS = 8192 rows stay inside
// int32; the wrapper launches phase 0 per 8192-row slice and carry_kernel
// after each, the reference's slicing (:413-428), so integer results are
// bit-identical whatever order the atomics land in. Float SUM adds in
// atomic order, which differs from run to run: it is held to a stated
// tolerance, not to bits.
//
// Shard axis (risingwave_tpu/parallel/agg.py:283, B22): blockIdx.y is the
// shard. Shard s reads its own batch (packed + s * pshard, slots + s *
// sshard) and updates its own state matrix (st + s * stshard), so one
// launch per phase and slice serves every shard; the single-device path
// launches S = 1.
//
// What bounds it on the card: bytes in the general case (each row's W
// lanes are read once; state is touched at the rows' slots). In q7 nearly
// all 32K rows of a batch hit ONE slot, so the same-address atomics
// serialize in L2; that, not bandwidth, sets its time. Warp-aggregated
// atomics would cut it and are later work.
#include "common.cuh"

namespace {

enum Kind { kCount = 0, kSumInt = 1, kSumFloat = 2, kMax = 3, kMin = 4 };
constexpr int kLimbBits = 17;
constexpr int kLimbs = 4;

__global__ void apply_kernel(int phase, const int32_t* __restrict__ packed,
                             int w, int kw, int row0, int nrows,
                             long long pshard,
                             const int32_t* __restrict__ slots,
                             long long sshard, int32_t* st, long long cap,
                             long long stshard,
                             const int32_t* __restrict__ desc, int ncalls) {
  const int r = row0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row0 + nrows) return;
  const long long sh = blockIdx.y;
  packed += sh * pshard;
  slots += sh * sshard;
  st += sh * stshard;
  const int32_t* p = packed + static_cast<size_t>(r) * w;
  const int32_t slot = slots[r];
  if (p[kw + 1] == 0 || slot < 0) return;
  const int32_t sign = p[kw];
  if (phase == 0) {
    atomicAdd(&st[rw::kRowGroupRows * cap + slot], sign);
    st[rw::kRowDirty * cap + slot] = 1;
  }
  for (int c = 0; c < ncalls; ++c) {
    const int kind = desc[4 * c];
    const int a = desc[4 * c + 1];
    const int ic = desc[4 * c + 2];
    const int vc = desc[4 * c + 3];
    if (vc >= 0 && p[vc] == 0) continue;
    int32_t* acc = st + static_cast<size_t>(rw::kRowAcc0 + a) * cap;
    const bool extreme = kind == kMax || kind == kMin;
    if (phase == 1) {
      if (extreme && sign > 0 && p[ic] == acc[slot]) {
        if (kind == kMax) {
          atomicMax(&acc[cap + slot], p[ic + 1]);
        } else {
          atomicMin(&acc[cap + slot], p[ic + 1]);
        }
      }
      continue;
    }
    switch (kind) {
      case kCount:
        atomicAdd(&acc[slot], sign);
        break;
      case kSumInt:
        for (int l = 0; l < kLimbs; ++l) {
          atomicAdd(&acc[l * cap + slot], p[ic + l] * sign);
        }
        atomicAdd(&acc[kLimbs * cap + slot], sign);
        break;
      case kSumFloat: {
        float* f = reinterpret_cast<float*>(acc);
        const float sf = static_cast<float>(sign);
        atomicAdd(&f[slot], __int_as_float(p[ic]) * sf);
        atomicAdd(&f[cap + slot], __int_as_float(p[ic + 1]) * sf);
        atomicAdd(&acc[2 * cap + slot], sign);
        break;
      }
      case kMax:
      case kMin: {
        atomicAdd(&acc[2 * cap + slot], sign);
        if (sign > 0) {
          const int32_t v = p[ic];
          if (kind == kMax) {
            if (atomicMax(&acc[slot], v) < v) acc[cap + slot] = INT32_MIN;
          } else {
            if (atomicMin(&acc[slot], v) > v) acc[cap + slot] = INT32_MAX;
          }
        }
        break;
      }
      default:
        break;
    }
  }
}

// Carry normalization of every integer-SUM call's limbs over all slots
// (ops/hash_agg.py:424-428): limbs 0..2 back into [0, 2^17).
__global__ void carry_kernel(int32_t* st, long long cap, long long stshard,
                             const int32_t* __restrict__ desc, int ncalls) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= cap) return;
  st += blockIdx.y * stshard;
  for (int c = 0; c < ncalls; ++c) {
    if (desc[4 * c] != kSumInt) continue;
    int32_t* acc = st + static_cast<size_t>(rw::kRowAcc0 + desc[4 * c + 1]) *
                            cap;
    int32_t limb[kLimbs];
    for (int l = 0; l < kLimbs; ++l) limb[l] = acc[l * cap + j];
    for (int l = 0; l < kLimbs - 1; ++l) {
      const int32_t carry = limb[l] >> kLimbBits;  // arithmetic shift
      limb[l] -= carry * (1 << kLimbBits);
      limb[l + 1] += carry;
    }
    for (int l = 0; l < kLimbs; ++l) acc[l * cap + j] = limb[l];
  }
}

}  // namespace

// Strides are in int32 elements: pshard between the shards' batches,
// sshard between their slot rows, stshard between their state matrices.
RW_API int rw_agg_apply(int phase, const void* packed, int w, int kw,
                        int row0, int nrows, long long pshard,
                        const void* slots, long long sshard, void* st,
                        long long cap, long long stshard, const void* desc,
                        int ncalls, int nshards, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows > 0 && nshards > 0) {
    constexpr int kThreads = 256;
    const dim3 grid(rw::blocks_for(nrows, kThreads), nshards);
    apply_kernel<<<grid, kThreads, 0, s>>>(
        phase, static_cast<const int32_t*>(packed), w, kw, row0, nrows,
        pshard, static_cast<const int32_t*>(slots), sshard,
        static_cast<int32_t*>(st), cap, stshard,
        static_cast<const int32_t*>(desc), ncalls);
  }
  return static_cast<int>(cudaGetLastError());
}

RW_API int rw_agg_carry(void* st, long long cap, long long stshard,
                        const void* desc, int ncalls, int nshards,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  if (nshards > 0) {
    const dim3 grid(rw::blocks_for(cap, kThreads), nshards);
    carry_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<int32_t*>(st), cap, stshard,
        static_cast<const int32_t*>(desc), ncalls);
  }
  return static_cast<int>(cudaGetLastError());
}
