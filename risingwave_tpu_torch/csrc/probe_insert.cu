// Kernel K1: probe_insert — whole-batch find-or-insert into the
// open-addressing hash table of int32 key lanes.
//
// Replaces risingwave_tpu/ops/hash_table.py:88 probe_insert, with the row
// hash of risingwave_tpu/common/hash.py:58 hash_columns inlined (B1, B2).
//
// Design. One thread per batch row: it hashes its K lanes, then probes
// linearly (stride 1) from hash & (cap - 1). An empty slot is claimed with
// atomicCAS on occ (0 empty -> -1 busy); the winner writes its key lanes,
// fences, and publishes occ = 1. A thread that finds a slot busy waits for
// it to become 1 and then compares keys, so a loser re-checks the winner's
// key and equal keys in one batch meet on one slot. Keys are read through
// L2 (__ldcg) after the fence that follows seeing occ = 1.
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
// probes and claims only inside its own cap slots, and stats is int32[S, 2].
// One launch serves every shard; the single-device path launches S = 1.
//
// What bounds it on the card: bytes — each row reads its K lanes and its
// valid flag and writes one slot; the table is touched only at the probed
// slots. In the q7 steady state nearly every row hits the same existing
// slot, so the table reads are L2 hits and the kernel is launch-bound at
// N = 32K rows.
#include "common.cuh"

namespace {

constexpr int32_t kEmpty = 0;
constexpr int32_t kReady = 1;
constexpr int32_t kBusy = -1;

__global__ void probe_insert_kernel(const int32_t* __restrict__ bkeys,
                                    long long kstride, long long kshard,
                                    const int32_t* __restrict__ valid,
                                    long long vstride, long long vshard,
                                    int n, int k, int32_t* tkeys,
                                    int32_t* occ, int cap,
                                    int32_t* __restrict__ slots,
                                    int32_t* stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long sh = blockIdx.y;
  bkeys += sh * kshard;
  valid += sh * vshard;
  tkeys += sh * static_cast<long long>(cap) * k;
  occ += sh * cap;
  slots += sh * n;
  stats += 2 * sh;
  if (valid[static_cast<long long>(r) * vstride] == 0) {
    slots[r] = -1;
    return;
  }
  const int32_t* key = bkeys + static_cast<long long>(r) * kstride;
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  uint32_t slot = rw::hash_lanes(key, k) & mask;
  volatile int32_t* vocc = occ;
  for (int step = 0; step < cap; ++step) {
    int32_t s = vocc[slot];
    if (s == kEmpty) {
      s = atomicCAS(&occ[slot], kEmpty, kBusy);
      if (s == kEmpty) {
        int32_t* dst = tkeys + static_cast<size_t>(slot) * k;
        for (int i = 0; i < k; ++i) dst[i] = key[i];
        __threadfence();
        atomicExch(&occ[slot], kReady);
        atomicAdd(&stats[0], 1);
        slots[r] = static_cast<int32_t>(slot);
        return;
      }
    }
    while (s == kBusy) {
      __nanosleep(32);
      s = vocc[slot];
    }
    __threadfence();
    const int32_t* cur = tkeys + static_cast<size_t>(slot) * k;
    bool eq = true;
    for (int i = 0; i < k; ++i) eq = eq && (__ldcg(cur + i) == key[i]);
    if (eq) {
      slots[r] = static_cast<int32_t>(slot);
      return;
    }
    slot = (slot + 1u) & mask;
  }
  slots[r] = -1;
  atomicExch(&stats[1], 1);
}

}  // namespace

// Per shard: stats[s, 0] = rows inserted, stats[s, 1] = overflow flag;
// all zeroed here. Strides are in int32 elements: kstride/vstride between
// rows, kshard/vshard between shards' batches; slots is int32[S, n].
RW_API int rw_probe_insert(const void* bkeys, long long kstride,
                           long long kshard, const void* valid,
                           long long vstride, long long vshard, int n,
                           int k, void* tkeys, void* occ, int cap,
                           int nshards, void* slots, void* stats,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(stats, 0, 2 * sizeof(int32_t) * nshards,
                                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0 && nshards > 0) {
    constexpr int kThreads = 256;
    const dim3 grid(rw::blocks_for(n, kThreads), nshards);
    probe_insert_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int32_t*>(bkeys), kstride, kshard,
        static_cast<const int32_t*>(valid), vstride, vshard, n, k,
        static_cast<int32_t*>(tkeys), static_cast<int32_t*>(occ), cap,
        static_cast<int32_t*>(slots), static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
