// Kernel K3: flush_gather + advance — the barrier flush of grouped-agg
// state.
//
// flush_gather replaces risingwave_tpu/ops/hash_agg.py:596 gather_packed
// (B5); advance replaces :744 advance_state (B6).
//
// flush_gather compacts the dirty slots, in slot order, into one int32
// matrix [1 + flush_cap, W'] in exactly the reference's layout:
//   row 0       header [n_dirty, n_groups, 0, ...]
//   rows 1..    slot | keys | group_rows | accs | emitted_valid |
//               emitted_rows | emitted accs      (f32 accs bitcast)
// Positions come from a hand-written two-pass scan over dirty:
//   count_kernel  one block per 1024-slot tile counts its dirty and
//                 occupied slots (__syncthreads_count);
//   write_kernel  each block sums the counts of the tiles before it,
//                 scans its own tile with warp ballots, and writes its
//                 dirty slots' rows. Block 0 writes the header.
// The header carries the TRUE n_dirty even when it exceeds flush_cap (rows
// past flush_cap are dropped): the host retries with a larger buffer. Rows
// n_dirty..flush_cap-1 hold slot 0's row, as the reference's gather of a
// zero-initialized index leaves them (the host never reads them).
//
// advance: one elementwise launch; for every dirty slot emitted := current
// (emitted_valid = group_rows > 0), then dirty = 0.
//
// Shard axis (risingwave_tpu/parallel/agg.py:219 _shardwise, B23):
// blockIdx.y is the shard. State is keys int32[S, cap, k], occ int32[S,
// cap] and st int32[S, R, cap]; the gather writes out[S, 1 + flush_cap,
// W'], one header per shard, and counts is int32[S, 2 * nb]. One launch of
// each serves every shard; the single-device path launches S = 1.
//
// What bounds them on the card: bytes. The scan reads dirty and occ once
// (8 bytes per slot) plus the dirty slots' rows; at cap = 2^18 that is
// 2 MiB, ~0.6 us at 3.35 TB/s, so launch latency dominates. advance reads
// dirty once and touches only dirty slots' rows.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__global__ void count_kernel(const int32_t* __restrict__ st,
                             const int32_t* __restrict__ occ, long long cap,
                             long long stshard, int32_t* counts, int nb) {
  st += blockIdx.y * stshard;
  occ += blockIdx.y * cap;
  counts += blockIdx.y * 2LL * nb;
  const long long j = blockIdx.x * static_cast<long long>(kTile) +
                      threadIdx.x;
  int d = 0;
  int o = 0;
  if (j < cap) {
    d = st[rw::kRowDirty * cap + j] != 0;
    o = occ[j] != 0;
  }
  const int cd = __syncthreads_count(d);
  const int co = __syncthreads_count(o);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = cd;
    counts[nb + blockIdx.x] = co;
  }
}

// Sum over the block, returned to every thread. `sh` holds 32 ints.
__device__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  int t = 0;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = 0; i < nwarps; ++i) t += sh[i];
  return t;
}

__device__ void gather_row(int32_t* out, long long s,
                           const int32_t* __restrict__ st,
                           const int32_t* __restrict__ keys, long long cap,
                           int k, int nacc) {
  int c = 0;
  out[c++] = static_cast<int32_t>(s);
  for (int i = 0; i < k; ++i) out[c++] = keys[s * k + i];
  out[c++] = st[rw::kRowGroupRows * cap + s];
  for (int a = 0; a < nacc; ++a) out[c++] = st[(rw::kRowAcc0 + a) * cap + s];
  out[c++] = st[rw::kRowEmittedValid * cap + s];
  out[c++] = st[rw::kRowEmittedRows * cap + s];
  for (int a = 0; a < nacc; ++a) {
    out[c++] = st[(rw::kRowAcc0 + nacc + a) * cap + s];
  }
}

__global__ void write_kernel(const int32_t* __restrict__ st,
                             const int32_t* __restrict__ keys, long long cap,
                             long long stshard, int k, int nacc,
                             const int32_t* __restrict__ counts, int nb,
                             int flush_cap, int32_t* out, int wout) {
  __shared__ int sh[32];
  st += blockIdx.y * stshard;
  keys += blockIdx.y * cap * k;
  counts += blockIdx.y * 2LL * nb;
  out += blockIdx.y * (1LL + flush_cap) * wout;
  __shared__ int warp_off[32];
  int pre = 0;
  int td = 0;
  int to = 0;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int c = counts[i];
    td += c;
    if (i < static_cast<int>(blockIdx.x)) pre += c;
    to += counts[nb + i];
  }
  pre = block_sum(pre, sh);
  td = block_sum(td, sh);
  to = block_sum(to, sh);

  const long long j = blockIdx.x * static_cast<long long>(kTile) +
                      threadIdx.x;
  const int d = (j < cap) ? (st[rw::kRowDirty * cap + j] != 0) : 0;
  const unsigned ball = __ballot_sync(0xffffffffu, d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int in_warp = __popc(ball & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) warp_off[warp] = __popc(ball);
  __syncthreads();
  if (warp == 0) {
    const int v = warp_off[lane];
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    warp_off[lane] = incl - v;
  }
  __syncthreads();
  const int pos = pre + warp_off[warp] + in_warp;
  if (d && pos < flush_cap) {
    gather_row(out + static_cast<size_t>(1 + pos) * wout, j, st, keys, cap,
               k, nacc);
  }
  for (long long q = td + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       q < flush_cap; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    gather_row(out + static_cast<size_t>(1 + q) * wout, 0, st, keys, cap, k,
               nacc);
  }
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < wout; c += blockDim.x) {
      out[c] = c == 0 ? td : (c == 1 ? to : 0);
    }
  }
}

__global__ void advance_kernel(int32_t* st, long long cap, long long stshard,
                               int nacc) {
  st += blockIdx.y * stshard;
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= cap || st[rw::kRowDirty * cap + j] == 0) return;
  const int32_t gr = st[rw::kRowGroupRows * cap + j];
  st[rw::kRowEmittedValid * cap + j] = gr > 0;
  st[rw::kRowEmittedRows * cap + j] = gr;
  for (int a = 0; a < nacc; ++a) {
    st[(rw::kRowAcc0 + nacc + a) * cap + j] = st[(rw::kRowAcc0 + a) * cap + j];
  }
  st[rw::kRowDirty * cap + j] = 0;
}

}  // namespace

// counts: int32 scratch of S * 2 * ceil(cap / 1024); out: [S, 1 +
// flush_cap, wout].
RW_API int rw_flush_gather(const void* st, const void* keys, const void* occ,
                           long long cap, int k, int nacc, int nshards,
                           void* counts, int flush_cap, void* out, int wout,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nshards <= 0) return static_cast<int>(cudaGetLastError());
  const int nb = rw::blocks_for(cap, kTile);
  const long long stshard = (rw::kRowAcc0 + 2LL * nacc) * cap;
  const dim3 grid(nb, nshards);
  count_kernel<<<grid, kTile, 0, s>>>(static_cast<const int32_t*>(st),
                                      static_cast<const int32_t*>(occ), cap,
                                      stshard, static_cast<int32_t*>(counts),
                                      nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  write_kernel<<<grid, kTile, 0, s>>>(
      static_cast<const int32_t*>(st), static_cast<const int32_t*>(keys), cap,
      stshard, k, nacc, static_cast<const int32_t*>(counts), nb, flush_cap,
      static_cast<int32_t*>(out), wout);
  return static_cast<int>(cudaGetLastError());
}

RW_API int rw_advance(void* st, long long cap, int nacc, int nshards,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  if (nshards > 0) {
    const dim3 grid(rw::blocks_for(cap, kThreads), nshards);
    advance_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<int32_t*>(st), cap, (rw::kRowAcc0 + 2LL * nacc) * cap,
        nacc);
  }
  return static_cast<int>(cudaGetLastError());
}
