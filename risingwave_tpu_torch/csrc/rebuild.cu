// Kernel K4: rebuild — keep the live slots of a grouped-agg table.
//
// Replaces risingwave_tpu/ops/hash_agg.py:642 _rebuild_live and :795
// remap_slots (B7), with the live masks of :676 retire_state (B8) and of
// the growth step (:968 GroupedAggKernel._grow_step).
//
// Open addressing with linear probing cannot free a slot in place (it
// would cut the probe chain of every key that collided past it), so both
// growth and watermark retirement rebuild: live_kernel computes which
// slots survive, K1 (probe_insert) inserts the survivors' keys into a
// fresh table and returns old_to_new, and remap_kernel moves every
// slot-indexed row of the state matrix through old_to_new.
//
// live_kernel, mode 0 (grow):   occ & (group_rows != 0 | dirty | emitted)
//             mode 1 (retire):  the same, minus groups whose key column at
//                               lane_off sorts strictly below the watermark
//                               (hi signed, lo unsigned; NULL never below).
// remap_kernel, one launch over max(n_src, new_cap) indices: index i moves
// source column i to old_to_new[i] (when >= 0), and index j writes the
// fill of every row into new slot j when the fresh table left it empty.
// The two sets of writes are disjoint and cover the whole output, so the
// output needs no separate initialization. The same kernel loads a
// recovered host matrix into a fresh table (GroupedAggKernel.rebuild).
//
// Shard axis (risingwave_tpu/parallel/agg.py:603 grow, :707 retire_below,
// :729 rebuild, :814 reshard; B23): blockIdx.y is the shard. live_kernel
// reads st int32[S, R, cap] and writes live int32[S, cap]; remap_kernel
// moves src int32[S, R, n_src] through old_to_new int32[S, n_src] into
// out int32[S, R, new_cap] with occ_new int32[S, new_cap]. One launch
// serves every shard; the single-device path launches S = 1. The live
// rule of mode 0 is also the reshard's (agg.py:833-834).
//
// What bounds them on the card: bytes. live reads occ, three state rows
// and (retire) the key lanes: 8 * 4 bytes per slot at K = 3. remap reads
// old_to_new and the new occ once and moves R rows of every live slot,
// writing R * new_cap * 4 bytes.
#include "common.cuh"

namespace {

__global__ void live_kernel(int mode, const int32_t* __restrict__ st,
                            const int32_t* __restrict__ keys,
                            const int32_t* __restrict__ occ, long long cap,
                            int k, int lane_off, int32_t wm_hi,
                            int32_t wm_lo, long long stshard,
                            int32_t* __restrict__ live) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= cap) return;
  st += blockIdx.y * stshard;
  keys += blockIdx.y * cap * k;
  occ += blockIdx.y * cap;
  live += blockIdx.y * cap;
  bool keep = occ[j] != 0 &&
              (st[rw::kRowGroupRows * cap + j] != 0 ||
               st[rw::kRowDirty * cap + j] != 0 ||
               st[rw::kRowEmittedValid * cap + j] != 0);
  if (mode == 1 && keep) {
    const int32_t* key = keys + j * k + lane_off;
    const int32_t hi = key[0];
    const uint32_t lo = static_cast<uint32_t>(key[1]);
    const bool nonnull = key[2] != 0;
    const bool below =
        hi < wm_hi || (hi == wm_hi && lo < static_cast<uint32_t>(wm_lo));
    if (nonnull && below) keep = false;
  }
  live[j] = keep ? 1 : 0;
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

// stshard: int32 elements between the shards' state matrices.
RW_API int rw_live_mask(int mode, const void* st, const void* keys,
                        const void* occ, long long cap, int k, int lane_off,
                        int wm_hi, int wm_lo, long long stshard, int nshards,
                        void* live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  if (nshards > 0) {
    const dim3 grid(rw::blocks_for(cap, kThreads), nshards);
    live_kernel<<<grid, kThreads, 0, s>>>(
        mode, static_cast<const int32_t*>(st),
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(occ),
        cap, k, lane_off, wm_hi, wm_lo, stshard, static_cast<int32_t*>(live));
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
