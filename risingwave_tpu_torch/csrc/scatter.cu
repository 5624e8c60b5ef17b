// Kernel K9: scatter_rows — set named rows of the state matrix at given
// slots: st[s, rows[j], idx[s, i]] = src[s, j, i].
//
// Replaces risingwave_tpu/ops/hash_agg.py:783 build_patch (the retractable
// MIN/MAX write-back: every accumulator row at the flushed slots) and the
// scatters of GroupedAggKernel.load_groups (:1200-1212: group_rows,
// emitted_valid, emitted_rows, the accumulators and the emitted
// accumulators of reloaded groups) (B10), and, with the shard axis, the
// sharded patch_accs of risingwave_tpu/parallel/agg.py:669 (B23).
//
// Layout: st int32[S, R, cap] (common.cuh), idx int32[S, n], src int32[S,
// k, n] (float rows travel as their bits), rows int32[k] the destination
// row of each source row. An index outside [0, cap) is dropped, as the
// reference's mode="drop": the padding of a batch is idx == cap (each
// shard's own cap), and an unplaced K1 row (-1) writes nothing.
//
// One thread per index i of a shard (blockIdx.y = shard): it reads its
// slot once and copies its k source values, read coalesced along i, into
// the named rows. The callers' indices are distinct within a shard (the
// slots of one flush, or of distinct reloaded keys), so the writes never
// race. The single-device path launches S = 1.
//
// What bounds it on the card. At a reload (1 to ~30 slots) and at
// maxbids' patch (one row at ~2,200 slots) the launch floor (~2.5 us)
// against a byte bound under 0.01 us: only fewer launches help, so the
// barrier's patch no longer comes here (it rides in advance's launch,
// csrc/flush.cu) and this kernel serves reloads, recovery and a patch
// that meets another state operation first. At the table's shape (2^16
// slots x 12 rows of a 2^20-slot state) bytes: 1.96 us of byte bound,
// but each 4-byte store at a scattered slot moves a 32-byte sector,
// 12 x 2^16 x 32 B ~ 25 MB, ~8.5 us with the reads; the kernel takes
// ~25 us there, and a version that held 8 source values a thread in
// flight before storing any took the same: the stores' partial sectors,
// not the loads' round trips, set the pace, and no layout of the same
// scattered writes has fewer sectors to touch.
#include "common.cuh"

namespace {

__global__ void scatter_rows_kernel(int32_t* st, long long cap,
                                    long long stshard,
                                    const int32_t* __restrict__ idx,
                                    long long ishard, int n,
                                    const int32_t* __restrict__ rows, int k,
                                    const int32_t* __restrict__ src,
                                    long long srcshard) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long sh = blockIdx.y;
  const int32_t slot = idx[sh * ishard + i];
  if (slot < 0 || slot >= cap) return;
  st += sh * stshard;
  src += sh * srcshard;
  for (int j = 0; j < k; ++j) {
    st[static_cast<long long>(rows[j]) * cap + slot] =
        src[static_cast<long long>(j) * n + i];
  }
}

}  // namespace

// Strides in int32 elements: stshard between the shards' state matrices,
// ishard between their index rows, srcshard between their source blocks.
RW_API int rw_scatter_rows(void* st, long long cap, long long stshard,
                           const void* idx, long long ishard, int n,
                           const void* rows, int k, const void* src,
                           long long srcshard, int nshards, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && k > 0 && nshards > 0) {
    constexpr int kThreads = 256;
    const dim3 grid(rw::blocks_for(n, kThreads), nshards);
    scatter_rows_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<int32_t*>(st), cap, stshard,
        static_cast<const int32_t*>(idx), ishard, n,
        static_cast<const int32_t*>(rows), k,
        static_cast<const int32_t*>(src), srcshard);
  }
  return static_cast<int>(cudaGetLastError());
}
