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
// One thread holds one row; a row is live when it is visible and has a
// slot. The update of one row:
//   phase 0: group_rows += sign, dirty = 1;
//            COUNT        += sign
//            SUM (int)    four 17-bit limbs += sign * limb, count += sign
//            SUM (float)  the (hi, lo) f32 pair += sign * (hi, lo)
//            MIN/MAX      non-null count += sign; for inserts, max/min on
//                         the hi lane, and an update that RAISED hi resets
//                         lo to the identity (the old lo belonged to a
//                         smaller hi)
//   phase 1: MIN/MAX      inserts whose hi equals the settled hi fold their
//                         lo in with max/min
// A call of kind kNone writes nothing: the host kinds (string_agg,
// array_agg) and approx_count_distinct keep their values on the host and
// their one dummy lane only keeps the plan's layout (:396-403); the row
// still counts in group_rows and marks its group dirty.
//
// Warp aggregation. A warp first finds its group: the live lanes whose
// slot is the slot of lane 0's row, read from memory beside each lane's
// own slot, so one __ballot_sync is the only collective before the
// choice (a lane 0 that is not live still names the slot: the group is
// then the other live lanes on it). When the group holds two lanes or
// more, each field is reduced over it with full-warp collectives
// (__reduce_add_sync for the counts, group_rows and the integer limbs,
// __reduce_max/min_sync for the extremes, a butterfly of __shfl_xor_sync
// for the float pair; lanes outside the group give the identity), its
// lowest lane issues one atomic per field and is the only one that
// stores dirty, and every live lane outside it updates alone. Otherwise
// every live lane updates alone, with no collective at all, and the
// others leave. No lane leaves before the ballot.
//
// One group, named by lane 0, and not every lane's peers: measured on
// the H100 (PERF.md §6), __match_any_sync with a reduction per peer
// group (each lane passing its group's mask) took 2.7x the per-row
// kernel at one row a slot, and two to four groups a warp were slower at
// q7's step and gained only at maxbids' first agg (half the rows on one
// auction). At one row a slot the cost is the latency in front of the
// choice, paid by every warp in a launch of 8,192 rows, which is one
// wave of warps: a ballot to skip empty warps and a shuffle of the
// lowest live lane's slot made the mixed plan 1.2% slower than the
// per-row kernel, lane 0's slot shuffled 0.4% slower, and lane 0's slot
// read from memory made it 0.9% faster. For the same reason no load of a row
// waits on another: slot, vis and sign together, a call's descriptor as
// one 16-byte load, its input lanes beside its valid lane.
//
// The result is the per-row rule's, bit for bit (the reference's two-pass
// lexicographic (hi, lo) rule, :430-453): the group's max/min of hi is
// one more candidate for the slot's hi, and a raise still resets lo;
// phase 1 folds the max/min of the lo of the group's rows whose hi equals
// the settled hi. Max and min are associative, so how rows are grouped
// into atomics does not change (hi, lo).
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
// lanes are read once; state is touched at the rows' slots), and the
// launches' fixed cost at q7's step, whose 1.2 MB take a fraction of one
// launch. There nearly every row of a 2^15-row batch hits one slot: an
// atomic per row and field serialized at one L2 address, and one per
// warp and field is 32 times fewer.
#include "common.cuh"

namespace {

enum Kind {
  kCount = 0, kSumInt = 1, kSumFloat = 2, kMax = 3, kMin = 4, kNone = 5
};
constexpr int kLimbBits = 17;
constexpr int kLimbs = 4;
constexpr unsigned kAll = 0xffffffffu;

// A lane's part in its warp's aggregation: `in` whether its row is in the
// warp's group, `lead` whether it issues the group's atomics (the group's
// lowest lane), `alone` whether it is live outside the group.
struct Lane {
  bool in;
  bool lead;
  bool alone;
};

// One field of the update. With kAgg the field is first reduced over the
// group with a full-warp collective (every lane passes one mask, the warp
// is converged), and the lead issues the group's one atomic; a live lane
// outside the group issues its own. Without kAgg every live lane is alone
// and there is no collective.
template <bool kAgg>
__device__ __forceinline__ void add_field(const Lane& l, int32_t* a, int v) {
  if (kAgg) {
    const int g = __reduce_add_sync(kAll, l.in ? v : 0);
    if (l.in) v = g;
  }
  if ((l.lead || l.alone) && v != 0) atomicAdd(a, v);
}

// float sum over the group in butterfly order
template <bool kAgg>
__device__ __forceinline__ void add_field(const Lane& l, float* a, float v,
                                          bool any) {
  if (kAgg) {
    float g = l.in ? v : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) g += __shfl_xor_sync(kAll, g, o);
    if (l.in) v = g;
  }
  if ((l.lead || l.alone) && any) atomicAdd(a, v);
}

// the group's max (or min) of v; a lane outside the group keeps its own
template <bool kAgg>
__device__ __forceinline__ int32_t ext_field(const Lane& l, bool is_max,
                                             int32_t ident, int32_t v) {
  if (kAgg) {
    const int32_t x = l.in ? v : ident;
    const int32_t g = is_max ? __reduce_max_sync(kAll, x)
                             : __reduce_min_sync(kAll, x);
    if (l.in) v = g;
  }
  return v;
}

// whether any row of the lane's group (or the lane's own row) has `pred`
template <bool kAgg>
__device__ __forceinline__ bool any_field(const Lane& l, bool pred) {
  if (kAgg) {
    const bool g = __any_sync(kAll, l.in && pred);
    if (l.in) pred = g;
  }
  return pred;
}

// The update of one row (kAgg: of its group) in one phase.
// (`sign` is the row's sign lane; it counts only where the row is live)
template <bool kAgg>
__device__ __forceinline__ void update(const Lane& l, int phase,
                                       const int32_t* p, int32_t slot,
                                       int32_t sign, int32_t* st,
                                       long long cap,
                                       const int32_t* __restrict__ desc,
                                       int ncalls) {
  const bool live = slot >= 0;
  if (!live) {
    slot = 0;  // never dereferenced: only lead and alone lanes act
    sign = 0;
  }
  if (phase == 0) {
    add_field<kAgg>(l, &st[rw::kRowGroupRows * cap + slot], sign);
    if (l.lead || l.alone) st[rw::kRowDirty * cap + slot] = 1;
  }
  for (int c = 0; c < ncalls; ++c) {
    // one 16-byte load a call: (kind, first acc row, input col, valid col)
    const int4 d = reinterpret_cast<const int4*>(desc)[c];
    const int kind = d.x;
    const bool extreme = kind == kMax || kind == kMin;
    if (kind == kNone || (phase == 1 && !extreme)) continue;
    const int ic = d.z;
    const int vc = d.w;
    int32_t* acc = st + static_cast<size_t>(rw::kRowAcc0 + d.y) * cap + slot;
    // a live row's input lanes (COUNT has none: ic < 0) are read whatever
    // its valid lane says, so neither load waits on the other
    const bool in_lanes = live && ic >= 0;
    const int32_t x0 = in_lanes ? p[ic] : 0;
    const int32_t x1 = in_lanes ? p[ic + 1] : 0;
    const bool on = live && (vc < 0 || p[vc] != 0);
    const bool is_max = kind == kMax;
    const int32_t ident = is_max ? INT32_MIN : INT32_MAX;
    if (phase == 1) {
      const bool fold = on && sign > 0 && x0 == (live ? acc[0] : 0);
      const bool any = any_field<kAgg>(l, fold);
      const int32_t g = ext_field<kAgg>(l, is_max, ident, fold ? x1 : ident);
      if ((l.lead || l.alone) && any) {
        if (is_max) {
          atomicMax(&acc[cap], g);
        } else {
          atomicMin(&acc[cap], g);
        }
      }
      continue;
    }
    switch (kind) {
      case kCount:
        add_field<kAgg>(l, acc, on ? sign : 0);
        break;
      case kSumInt:
        for (int k = 0; k < kLimbs; ++k) {
          const int32_t x = k == 0 ? x0 : k == 1 ? x1 : in_lanes ? p[ic + k]
                                                                : 0;
          add_field<kAgg>(l, acc + k * cap, on ? x * sign : 0);
        }
        add_field<kAgg>(l, acc + kLimbs * cap, on ? sign : 0);
        break;
      case kSumFloat: {
        const bool any = any_field<kAgg>(l, on);
        const float sf = static_cast<float>(sign);
        for (int k = 0; k < 2; ++k) {
          add_field<kAgg>(l, reinterpret_cast<float*>(acc + k * cap),
                          on ? __int_as_float(k == 0 ? x0 : x1) * sf : 0.0f,
                          any);
        }
        add_field<kAgg>(l, acc + 2 * cap, on ? sign : 0);
        break;
      }
      case kMax:
      case kMin: {
        add_field<kAgg>(l, acc + 2 * cap, on ? sign : 0);
        const bool ins = on && sign > 0;
        const bool any = any_field<kAgg>(l, ins);
        const int32_t v = ext_field<kAgg>(l, is_max, ident,
                                          ins ? x0 : ident);
        if ((l.lead || l.alone) && any) {
          if (is_max) {
            if (atomicMax(acc, v) < v) acc[cap] = INT32_MIN;
          } else {
            if (atomicMin(acc, v) > v) acc[cap] = INT32_MAX;
          }
        }
        break;
      }
      default:
        break;
    }
  }
}

__global__ void apply_kernel(int phase, const int32_t* __restrict__ packed,
                             int w, int kw, int row0, int nrows,
                             long long pshard,
                             const int32_t* __restrict__ slots,
                             long long sshard, int32_t* st, long long cap,
                             long long stshard,
                             const int32_t* __restrict__ desc, int ncalls) {
  const int r = row0 + blockIdx.x * blockDim.x + threadIdx.x;
  const long long sh = blockIdx.y;
  packed += sh * pshard;
  slots += sh * sshard;
  st += sh * stshard;
  const int32_t* p = packed + static_cast<size_t>(r) * w;
  // the slot and the sign are loaded beside the vis lane, and lane 0's
  // slot beside the lane's own (no branch on vis to sink the loads into,
  // no shuffle after them): each wait puts one more round trip on every
  // warp's path
  const int r0 = r - static_cast<int>(threadIdx.x & 31);
  int32_t slot = -1;
  int32_t sign = 0;
  int32_t s0 = -1;
  if (r0 < row0 + nrows) s0 = slots[r0];
  if (r < row0 + nrows) {
    const int32_t s = slots[r];
    const int32_t vis = p[kw + 1];
    sign = p[kw];
    slot = max(s, -1) | -static_cast<int32_t>(vis == 0);
  }
  // the group: the live lanes whose slot is lane 0's slot (lane 0 may be
  // invisible: the group is then the other live lanes on that slot). Every
  // lane reaches this collective; none has left yet.
  const unsigned group = __ballot_sync(kAll, s0 >= 0 && slot == s0);
  if ((group & (group - 1u)) == 0) {
    // a group of one or none: every live lane alone, no collective, and
    // a lane with no live row has nothing to do
    if (slot < 0) return;
    const Lane one{false, false, true};
    update<false>(one, phase, p, slot, sign, st, cap, desc, ncalls);
  } else {
    const unsigned lane_bit = 1u << (threadIdx.x & 31);
    const bool in = (group & lane_bit) != 0;
    const Lane l{in, in && (group & (lane_bit - 1u)) == 0,
                 slot >= 0 && !in};
    update<true>(l, phase, p, slot, sign, st, cap, desc, ncalls);
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
// desc is 16-byte aligned (a call's four ints are one load).
RW_API int rw_agg_apply(int phase, const void* packed, int w, int kw,
                        int row0, int nrows, long long pshard,
                        const void* slots, long long sshard, void* st,
                        long long cap, long long stshard, const void* desc,
                        int ncalls, int nshards, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrows > 0 && nshards > 0) {
    constexpr int kThreads = 256;  // whole warps: the kernel needs them
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
