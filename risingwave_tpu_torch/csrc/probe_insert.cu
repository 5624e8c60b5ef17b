// Kernel K1: probe_insert — whole-batch find-or-insert into the
// open-addressing hash table of int32 key lanes.
//
// Replaces risingwave_tpu/ops/hash_table.py:88 probe_insert, with the row
// hash of risingwave_tpu/common/hash.py:58 hash_columns inlined (B1, B2).
//
// Design. One launch a call, one thread per batch row: it holds its K
// lanes in registers (K <= 8; wider keys are read from the batch row at
// each comparison) and hashes them. The lanes of a warp that hold one key
// meet first (rw::warp_leader: __match_any_sync on the hash, then the
// key compared with the group's lowest lane), and only the group's leader
// probes; then each warp offers its first probing lane's key to the block
// in shared memory, and a probing lane whose key an earlier warp offered
// takes that warp's slot after one more barrier. q7's step puts nearly
// every row on one or two keys, so a block sends about one probe to the
// hot table line instead of 256 (strong loads of one L2 line from every
// warp of the card made that shape's time swing by ~30% between cards);
// a block with at most one offer skips the second barrier. The leader
// probes linearly from hash & (cap - 1) through rw::find_or_insert
// (common.cuh): an empty slot is claimed with atomicCAS on occ (0 empty
// -> -1 busy), the winner writes its lanes and publishes occ = 1 with a
// release store, every other look at occ is an acquire load, so a row
// that sees 1 (at once or after waiting out -1) reads the winner's lanes;
// a loser compares against the winner's key, so equal keys in one batch
// meet on one slot. A probe step takes a group of 4 slots: their occ
// words in one 16-byte acquire load, their lanes prefetched into L2
// beside it and read after it in 16-byte loads, so a step costs one trip
// to memory and one to L2, and no step pays a full fence. (A shard's
// probe chains are long — its keys' homes sit on 1/8 of its slots, see
// common.cuh — so a fresh key walks ~110 slots: ~28 steps.) The stats
// [inserted, overflow] come out of the same launch: each warp counts by
// ballot and adds its sums to `stats` with one atomic, and `stats` was
// zeroed by the launch before it on the stream, which this launch repeats
// for the next one (rw::zero_next; ops/cuda.py stats_chain), so no memset
// precedes the kernel and no warp waits for another. A warp with at most
// one valid row (most of a shard's receive block) skips the meeting.
//
// Deviation from the reference: the JAX program elects the LOWEST row
// index as the winner of a contested slot (scatter-min claim rounds,
// hash_table.py:115-120); here the first CAS wins. Slot assignment may
// therefore differ from the reference's; the plain PyTorch version keeps
// the reference's rule exactly, and this kernel is held to the table
// invariants (each valid row's slot holds its key, equal keys share one
// slot, the same key set and insert count).
//
// Bounds. The probe is bounded by cap steps. A row that finds no slot
// gets -1 and sets stats[1]; the Python side turns that into an error.
// The wrapper keeps load under MAX_LOAD 0.70, so this never fires.
//
// Shard axis (risingwave_tpu/parallel/agg.py, B22/B23). The launch takes S
// independent tables (keys int32[S, cap, K], occ int32[S, cap]) and S
// batches of n rows each, one per grid row (blockIdx.y = shard): shard s
// probes and claims only inside its own cap slots, and stats is int32[S,
// 2]. One launch serves every shard; the single-device path launches S =
// 1.
//
// What bounds it on the card: bytes — each row reads its K lanes and its
// valid flag and writes one slot; the table is touched only at the probed
// slots. In the q7 steady state nearly every row hits the same existing
// slot, so the table reads are L2 hits and the kernel is launch-bound at
// N = 32K rows; at q8's side-epoch (2^16 rows into a 2^22-slot, 100 MB
// table) each row's probe is a trip to memory.
//
// Kernel K8: lookup — the read-only probe (B3, risingwave_tpu/ops/
// hash_table.py:137), standalone for the cold-tier eviction of
// risingwave_tpu/ops/hash_agg.py:714 evict_state (B9). One thread per row
// walks the same probe chain as K1 through rw::find_slot (occ and lanes
// loaded together: the table is not written while it runs) and stops at
// its key (slot) or at the first empty slot (absent, -1), a group of 4
// slots a step. Invalid rows
// get -1. With a `dropped` int32[cap] mask, a found row also sets
// dropped[slot] = 1 (equal keys write the same 1, so duplicates need no
// atomics). A row that runs cap steps without meeting its key or an empty
// slot sets stats[1], as K1 does; stats come out of the launch as K1's
// (its rows are distinct keys, so it probes without the warp's meeting).
// Bound: bytes — K lanes and a flag read per row, one slot written, and
// the probed table slots.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <class Key>
__global__ void __launch_bounds__(kThreads)
    probe_insert_kernel(const int32_t* __restrict__ bkeys,
                        long long kstride, long long kshard,
                        const int32_t* __restrict__ valid,
                        long long vstride, long long vshard, int n, int k,
                        int32_t* tkeys, int32_t* occ, int cap,
                        int32_t* __restrict__ slots, int32_t* stats,
                        int32_t* next, int n_next) {
  constexpr int kWarps = kThreads / 32;
  // each warp's offer to the block: its first probing lane's key
  __shared__ uint32_t s_hash[kWarps];
  __shared__ int32_t s_lanes[kWarps][8];
  __shared__ int s_has[kWarps], s_slot[kWarps];
  rw::zero_next(next, n_next);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sh = blockIdx.y;
  const bool act =
      r < n && valid[sh * vshard + static_cast<long long>(r) * vstride] != 0;
  const unsigned live = __ballot_sync(0xffffffffu, act);
  Key key(k);
  uint32_t h = 0u;
  bool follow = false;
  int leader = 0;
  const bool meet = Key::kGrouped && __popc(live) > 1;
  if (live != 0u) {  // a warp with no valid row only writes its -1s
    if (act) {
      key.load(bkeys + sh * kshard + static_cast<long long>(r) * kstride);
    }
    h = act ? key.hash() : 0u;
    if constexpr (Key::kGrouped) {
      if (meet) leader = rw::warp_leader(key, act, h, &follow);
    }
  }
  const bool probe = act && !follow;
  int src = -1;  // an earlier warp of the block that offered this key
  int first = -1;
  int offered = 0;
  if constexpr (Key::kGrouped) {
    const unsigned probers = __ballot_sync(0xffffffffu, probe);
    first = probers != 0u ? __ffs(probers) - 1 : -1;
    if (lane == 0) s_has[warp] = first >= 0;
    if (lane == first) {
      s_hash[warp] = h;
#pragma unroll
      for (int i = 0; i < Key::kLanes; ++i) s_lanes[warp][i] = key.v[i];
    }
    offered = __syncthreads_count(lane == first);
    if (offered > 1 && probe) {
      for (int w = 0; w < warp && src < 0; ++w) {
        if (!s_has[w] || s_hash[w] != h) continue;
        bool eq = true;
#pragma unroll
        for (int i = 0; i < Key::kLanes; ++i) eq &= s_lanes[w][i] == key.v[i];
        if (eq) src = w;
      }
    }
  }
  bool inserted = false;
  int slot = -1;
  if (probe && src < 0) {
    slot = rw::find_or_insert(key, h, tkeys + sh * cap * k, occ + sh * cap,
                              static_cast<uint32_t>(cap), &inserted);
  }
  if (offered > 1) {  // the same on every thread of the block
    if (lane == first && src < 0) s_slot[warp] = slot;
    __syncthreads();
    if (src >= 0) slot = s_slot[src];
  }
  if (meet) {
    const int lead = __shfl_sync(0xffffffffu, slot, leader);
    if (follow) slot = lead;
  }
  if (r < n) slots[sh * n + r] = slot;
  rw::warp_stats(inserted, act && slot < 0, stats + 2 * sh);
}

template <class Key>
__global__ void __launch_bounds__(kThreads)
    lookup_kernel(const int32_t* __restrict__ bkeys, long long kstride,
                  const int32_t* __restrict__ valid, long long vstride,
                  int n, int k, const int32_t* __restrict__ tkeys,
                  const int32_t* __restrict__ occ, int cap,
                  int32_t* __restrict__ slots, int32_t* stats,
                  int32_t* __restrict__ dropped, int32_t* next, int n_next) {
  rw::zero_next(next, n_next);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool overflow = false;
  if (r < n) {
    int slot = -1;
    if (valid[static_cast<long long>(r) * vstride] != 0) {
      Key key(k);
      key.load(bkeys + static_cast<long long>(r) * kstride);
      slot = rw::find_slot(key, tkeys, occ, static_cast<uint32_t>(cap));
      overflow = slot == -2;
      if (slot < 0) {
        slot = -1;
      } else if (dropped != nullptr) {
        dropped[slot] = 1;
      }
    }
    slots[r] = slot;
  }
  rw::warp_stats(false, overflow, stats);
}

}  // namespace

// Per shard: stats[s, 0] = rows inserted, stats[s, 1] = overflow flag,
// summed by the launch into stats, which must be zero on entry; the
// launch zeroes `next` (n_next words), the stats block of the next launch
// on the stream (ops/cuda.py stats_chain). Strides are in int32 elements:
// kstride/vstride between rows, kshard/vshard between shards' batches;
// slots is int32[S, n].
RW_API int rw_probe_insert(const void* bkeys, long long kstride,
                           long long kshard, const void* valid,
                           long long vstride, long long vshard, int n,
                           int k, void* tkeys, void* occ, int cap,
                           int nshards, void* slots, void* stats,
                           void* next, int n_next, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nshards > 0) {
    const dim3 grid(n > 0 ? rw::blocks_for(n, kThreads) : 1, nshards);
#define RW_LAUNCH(KEY)                                                     \
  probe_insert_kernel<KEY><<<grid, kThreads, 0, st>>>(                     \
      static_cast<const int32_t*>(bkeys), kstride, kshard,                 \
      static_cast<const int32_t*>(valid), vstride, vshard, n, k,           \
      static_cast<int32_t*>(tkeys), static_cast<int32_t*>(occ), cap,       \
      static_cast<int32_t*>(slots), static_cast<int32_t*>(stats),          \
      static_cast<int32_t*>(next), n_next)
    RW_LANES_SWITCH(k, rw::groups_aligned(tkeys, occ, cap), RW_LAUNCH)
#undef RW_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: stats = [0, overflow], summed by the launch (zero on entry); `next`
// and `dropped` as above (`dropped` may be null).
RW_API int rw_lookup(const void* bkeys, long long kstride, const void* valid,
                     long long vstride, int n, int k, const void* tkeys,
                     const void* occ, int cap, void* slots, void* stats,
                     void* dropped, void* next, int n_next, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = n > 0 ? rw::blocks_for(n, kThreads) : 1;
#define RW_LAUNCH(KEY)                                                     \
  lookup_kernel<KEY><<<blocks, kThreads, 0, st>>>(                         \
      static_cast<const int32_t*>(bkeys), kstride,                         \
      static_cast<const int32_t*>(valid), vstride, n, k,                   \
      static_cast<const int32_t*>(tkeys),                                  \
      static_cast<const int32_t*>(occ), cap, static_cast<int32_t*>(slots), \
      static_cast<int32_t*>(stats), static_cast<int32_t*>(dropped),        \
      static_cast<int32_t*>(next), n_next)
  RW_LANES_SWITCH(k, rw::groups_aligned(tkeys, occ, cap), RW_LAUNCH)
#undef RW_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
