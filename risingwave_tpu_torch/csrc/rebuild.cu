// Kernel K4: rebuild — keep the live slots of a grouped-agg table.
//
// Replaces risingwave_tpu/ops/hash_agg.py:642 _rebuild_live and :795
// remap_slots (B7), with the live masks of :676 retire_state (B8) and of
// the growth step (:968 GroupedAggKernel._grow_step).
//
// Open addressing with linear probing cannot free a slot in place (it
// would cut the probe chain of every key that collided past it), so both
// growth and watermark retirement rebuild: live_kernel computes which
// slots survive and zeroes the fresh table in the same launch, K1
// (probe_insert) inserts the survivors' keys into that table and returns
// old_to_new, and remap_kernel moves every slot-indexed row of the state
// matrix through old_to_new. A rebuild is three launches.
//
// live_kernel, mode 0 (grow):   occ & (group_rows != 0 | dirty | emitted)
//             mode 1 (retire):  the same, minus groups whose key column at
//                               lane_off sorts strictly below the watermark
//                               (hi signed, lo unsigned; NULL never below).
//             mode 2 (evict):   the same, minus the slots K8 (lookup)
//                               marked in dropped int32[S, cap]: the
//                               cold-tier eviction of hash_agg.py:714
//                               evict_state (B9), rule of :727-728.
//             mode 3 (occupied): occ alone: the sharded growth of
//                               risingwave_tpu/parallel/agg.py:603, which
//                               keeps every occupied slot.
// remap_kernel, one launch over max(n_src, new_cap) indices: index i moves
// source column i to old_to_new[i] (when >= 0), and index j writes the
// fill of every row into new slot j when the fresh table left it empty.
// The two sets of writes are disjoint and cover the whole output, so the
// output needs no separate initialization. The same kernel loads a
// recovered host matrix into a fresh table (GroupedAggKernel.rebuild).
//
// Shard axis (risingwave_tpu/parallel/agg.py:603 grow, :707 retire_below,
// :729 rebuild, :814 reshard; B23): blockIdx.y is the shard. live_kernel
// reads st int32[S, R, cap] and writes live int32[S, cap] and the fresh
// keys int32[S, new_cap, K] and occ int32[S, new_cap]; remap_kernel moves
// src int32[S, R, n_src] through old_to_new int32[S, n_src] into out
// int32[S, R, new_cap] with occ_new int32[S, new_cap]. One launch serves
// every shard; the single-device path launches S = 1. The live rule of
// mode 0 is also the reshard's (agg.py:833-834).
//
// What bounds them on the card. live: one launch floor (~2.5 us); its
// bytes are the occ word of every slot, three state rows (and, retiring,
// the key lanes) of the occupied ones, the mask written, and the fresh
// table's (K + 1) * new_cap words cleared: at q7's 2^18 slots, K = 3,
// 1 MiB read, 1 MiB of mask and 4 MiB of table, ~1.9 us at 3.35 TB/s.
// Before, the mask was one launch and the fresh table two fills (three
// launch floors for ~1.9 us of bytes), so the design clears the table in
// the mask's own launch: the grid covers max(cap, new_cap) slots a shard
// (growth doubles the capacity), a thread takes 4 slots, and its loads
// and stores are 16 bytes wide where the layout allows (the occ, state,
// dropped and mask rows are contiguous; the fresh keys and occ are each
// one flat run of int32 words a shard, cleared by neighbouring threads at
// neighbouring 16-byte words). The state rows are read only where a slot
// is occupied: a table is mostly empty after a retirement, and the rows
// then cost no bytes. remap: bytes: old_to_new and the new occ once, R
// rows of every live slot moved, R * new_cap * 4 bytes written.
#include "common.cuh"

namespace {

constexpr int kPer = 4;                 // slots a thread of live_kernel

struct Live {
  int mode;
  const int32_t* st;
  const int32_t* keys;
  const int32_t* occ;
  long long cap;
  int k, lane_off;
  int32_t wm_hi, wm_lo;
  long long stshard;
  const int32_t* dropped;
  int32_t* live;
  int32_t* new_keys;            // null: no fresh table to clear
  int32_t* new_occ;
  long long new_cap;
  bool vec_live;                // 16-byte access to occ, rows, mask
  bool vec_new;                 // 16-byte stores to the fresh table
};

// the live rule for slot j of one shard, occ[j] != 0 known, from its
// rule rows, its key column's lanes (hi, lo, valid; retire) and its
// dropped word (evict), all loaded by the caller
__device__ __forceinline__ bool keep_occupied(const Live& a, int32_t gr,
                                              int32_t dirty, int32_t ev,
                                              int32_t hi, int32_t lo,
                                              int32_t nonnull,
                                              int32_t dropped) {
  if (a.mode == 3) return true;
  bool keep = gr != 0 || dirty != 0 || ev != 0;
  if (a.mode == 1) {
    const bool below = hi < a.wm_hi ||
        (hi == a.wm_hi &&
         static_cast<uint32_t>(lo) < static_cast<uint32_t>(a.wm_lo));
    if (nonnull != 0 && below) keep = false;
  }
  if (a.mode == 2 && dropped != 0) keep = false;
  return keep;
}

__global__ void __launch_bounds__(256) live_kernel(const Live a) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long sh = blockIdx.y;
  const long long j0 = t * kPer;
  // the fresh table: slots j0..j0+3 of this shard's keys and occ
  if (a.new_occ != nullptr && j0 < a.new_cap) {
    int32_t* nk = a.new_keys + sh * a.new_cap * a.k;
    int32_t* no = a.new_occ + sh * a.new_cap;
    if (a.vec_new) {
      // new_cap % 4 == 0: the shard's K * new_cap / 4 key words and
      // new_cap / 4 occ words, thread t the t-th of each K-th part
      const long long n4 = a.new_cap / kPer;
      const int4 z = make_int4(0, 0, 0, 0);
      reinterpret_cast<int4*>(no)[t] = z;
      int4* k4 = reinterpret_cast<int4*>(nk);
      for (int q = 0; q < a.k; ++q) k4[t + q * n4] = z;
    } else {
      for (long long j = j0; j < j0 + kPer && j < a.new_cap; ++j) {
        no[j] = 0;
        for (int q = 0; q < a.k; ++q) nk[j * a.k + q] = 0;
      }
    }
  }
  if (j0 >= a.cap) return;
  const int32_t* st = a.st + sh * a.stshard;
  const int32_t* keys = a.keys + sh * a.cap * a.k;
  const int32_t* occ = a.occ + sh * a.cap;
  const int32_t* dropped = a.dropped == nullptr ? nullptr
                                                : a.dropped + sh * a.cap;
  int32_t* live = a.live + sh * a.cap;
  const int32_t* gr = st + rw::kRowGroupRows * a.cap;
  const int32_t* dirty = st + rw::kRowDirty * a.cap;
  const int32_t* ev = st + rw::kRowEmittedValid * a.cap;
  if (a.vec_live && j0 + kPer <= a.cap) {
    const int4 o = *reinterpret_cast<const int4*>(occ + j0);
    int4 out = make_int4(0, 0, 0, 0);
    if (a.mode == 3) {
      out = make_int4(o.x != 0, o.y != 0, o.z != 0, o.w != 0);
    } else if ((o.x | o.y | o.z | o.w) != 0) {
      // a second round trip only where a slot is occupied: its rule rows,
      // dropped words and key lanes all load together
      const int4 g = *reinterpret_cast<const int4*>(gr + j0);
      const int4 d = *reinterpret_cast<const int4*>(dirty + j0);
      const int4 e = *reinterpret_cast<const int4*>(ev + j0);
      const int4 dr = a.mode == 2
          ? *reinterpret_cast<const int4*>(dropped + j0)
          : make_int4(0, 0, 0, 0);
      const int oc[kPer] = {o.x, o.y, o.z, o.w};
      int32_t hi[kPer] = {}, lo[kPer] = {}, nn[kPer] = {};
      if (a.mode == 1) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (oc[q] != 0) {
            const int32_t* key = keys + (j0 + q) * a.k + a.lane_off;
            hi[q] = key[0];
            lo[q] = key[1];
            nn[q] = key[2];
          }
        }
      }
      out.x = o.x != 0 && keep_occupied(a, g.x, d.x, e.x, hi[0], lo[0],
                                        nn[0], dr.x);
      out.y = o.y != 0 && keep_occupied(a, g.y, d.y, e.y, hi[1], lo[1],
                                        nn[1], dr.y);
      out.z = o.z != 0 && keep_occupied(a, g.z, d.z, e.z, hi[2], lo[2],
                                        nn[2], dr.z);
      out.w = o.w != 0 && keep_occupied(a, g.w, d.w, e.w, hi[3], lo[3],
                                        nn[3], dr.w);
    }
    *reinterpret_cast<int4*>(live + j0) = out;
    return;
  }
  for (long long j = j0; j < j0 + kPer && j < a.cap; ++j) {
    if (occ[j] == 0) {
      live[j] = 0;
      continue;
    }
    const int32_t* key = keys + j * a.k + a.lane_off;
    live[j] = keep_occupied(
        a, gr[j], dirty[j], ev[j], a.mode == 1 ? key[0] : 0,
        a.mode == 1 ? key[1] : 0, a.mode == 1 ? key[2] : 0,
        a.mode == 2 ? dropped[j] : 0);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void remap_kernel(const int32_t* __restrict__ src, long long n_src,
                             const int32_t* __restrict__ old_to_new,
                             const int32_t* __restrict__ occ_new,
                             long long new_cap,
                             const int32_t* __restrict__ fill, int nrows,
                             int32_t* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long sh = blockIdx.y;
  src += sh * nrows * n_src;
  old_to_new += sh * n_src;
  occ_new += sh * new_cap;
  out += sh * nrows * new_cap;
  if (i < n_src) {
    const int32_t t = old_to_new[i];
    if (t >= 0) {
      for (int r = 0; r < nrows; ++r) out[r * new_cap + t] = src[r * n_src + i];
    }
  }
  if (i < new_cap && occ_new[i] == 0) {
    for (int r = 0; r < nrows; ++r) out[r * new_cap + i] = fill[r];
  }
}

}  // namespace

// stshard: int32 elements between the shards' state matrices; dropped
// (int32[S, cap]) is read in mode 2 only and may be null otherwise;
// new_keys (int32[S, new_cap, k]) and new_occ (int32[S, new_cap]) are the
// fresh table this launch zeroes, both null (and new_cap 0) for the mask
// alone.
RW_API int rw_live_mask(int mode, const void* st, const void* keys,
                        const void* occ, long long cap, int k, int lane_off,
                        int wm_hi, int wm_lo, long long stshard, int nshards,
                        const void* dropped, void* live, void* new_keys,
                        void* new_occ, long long new_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  if ((new_keys == nullptr) != (new_occ == nullptr) ||
      (new_occ != nullptr && new_cap <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Live a;
  a.mode = mode;
  a.st = static_cast<const int32_t*>(st);
  a.keys = static_cast<const int32_t*>(keys);
  a.occ = static_cast<const int32_t*>(occ);
  a.cap = cap;
  a.k = k;
  a.lane_off = lane_off;
  a.wm_hi = wm_hi;
  a.wm_lo = wm_lo;
  a.stshard = stshard;
  a.dropped = static_cast<const int32_t*>(dropped);
  a.live = static_cast<int32_t*>(live);
  a.new_keys = static_cast<int32_t*>(new_keys);
  a.new_occ = static_cast<int32_t*>(new_occ);
  a.new_cap = new_occ == nullptr ? 0 : new_cap;
  a.vec_live = cap % kPer == 0 && stshard % kPer == 0 && aligned16(st) &&
               aligned16(occ) && aligned16(live) &&
               (dropped == nullptr || aligned16(dropped));
  a.vec_new = a.new_cap % kPer == 0 && aligned16(new_keys) &&
              aligned16(new_occ);
  const long long n = cap > a.new_cap ? cap : a.new_cap;
  if (nshards > 0 && n > 0) {
    const dim3 grid(rw::blocks_for((n + kPer - 1) / kPer, kThreads),
                    nshards);
    live_kernel<<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

RW_API int rw_remap(const void* src, long long n_src, const void* old_to_new,
                    const void* occ_new, long long new_cap, const void* fill,
                    int nrows, int nshards, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const long long n = n_src > new_cap ? n_src : new_cap;
  if (n > 0 && nshards > 0) {
    const dim3 grid(rw::blocks_for(n, kThreads), nshards);
    remap_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(src), n_src,
        static_cast<const int32_t*>(old_to_new),
        static_cast<const int32_t*>(occ_new), new_cap,
        static_cast<const int32_t*>(fill), nrows,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
