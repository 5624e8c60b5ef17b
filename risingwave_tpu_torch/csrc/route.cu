// Kernel route — the hash exchange of the vnode-sharded operators on one
// card.
//
// Replaces risingwave_tpu/parallel/exchange.py:72 bucketize_by_owner and
// :104 exchange (B21), with the vnode routing of :31 vnodes_from_lanes
// (B1's row hash & 255, then the vnode -> owner map).
//
// Input: S sender blocks of `local` rows each (rows int32[S * local, W],
// any row stride; a valid flag per row, any stride), the owner map
// int32[256], and a bucket size. Output, exactly the reference's receive
// buffer after its all_to_all (split_axis 0, concat_axis 0):
//   recv   int32[S, S * bucket, W]   recv[t, s * bucket + p] is the p-th
//                                    valid row of sender block s owned by
//                                    shard t, in input order
//   rvalid int32[S, S * bucket]      1 where a row landed, else 0
//   ovf    int32[S]                  per sender: a bucket overflowed
// Rows past a bucket's count are zero, so the buffer equals the plain
// version's bit for bit. On one card the all_to_all is only this layout:
// each row is written once, straight into its receiving shard's block.
//
// Design: two launches over the same grid, (tiles, S), 256 threads a
// block. A sender's block is cut into at most kMaxTiles tiles of whole
// 256-row chunks, so a q7-mesh step (8 senders of 4,096 rows) launches
// 128 blocks and large reshards stay at 64 tiles a sender. No atomics
// touch the output: input order inside a bucket decides which row K1's
// plain rule lets win a slot and the order of float SUM's adds.
//   count_kernel  each valid row's owner (the B1 hash of its first kw
//                 lanes, & 255, through the owner map) into a scratch,
//                 and the tile's count per target: the lanes of a warp
//                 with one owner (__match_any_sync) add their number with
//                 one shared atomic, so a batch that goes to one shard
//                 does not serialize on one counter;
//   write_kernel  each block first sums its sender's tile counts (the
//                 scan: tiles before its own give its first position per
//                 target, all tiles the totals and the overflow flag).
//                 The sender's tiles then zero the unused tail of each of
//                 its buckets, one contiguous range of the buffer per
//                 bucket, with 16-byte stores spread over all of them
//                 (first, so the stores overlap the copy's loads). Chunk
//                 by chunk, a row's position is the tile's running offset
//                 + the counts of earlier warps of the chunk + its rank
//                 among its warp's lanes of the same owner, and a warp
//                 copies its rows that fit as one flat run of int32
//                 (neighbouring lanes on neighbouring lanes of a row, and
//                 rows of one owner land on consecutive positions).
// The payload width is a runtime argument: the agg's packed batch and the
// reshard's whole state rows (keys and every state row) use one kernel.
//
// What bounds it on the card: bytes — the rows are read once (W lanes) and
// the receive buffer written once (S * S * bucket rows of W lanes, most of
// them zeros when the bucket is the whole block) — and, at q7-mesh's step,
// whose 10 MB take ~3 µs, the two launches' fixed cost.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // rows of a chunk, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 64;     // tiles a sender
constexpr int kVnodeMask = 255;
constexpr unsigned kAll = 0xffffffffu;

__global__ void count_kernel(const int32_t* __restrict__ rows,
                             long long rstride,
                             const int32_t* __restrict__ valid,
                             long long vstride, int local, int trows, int kw,
                             const int32_t* __restrict__ owner_map, int S,
                             int32_t* __restrict__ own,
                             int32_t* __restrict__ counts, int ntiles) {
  extern __shared__ int sc[];  // S counters
  for (int t = threadIdx.x; t < S; t += blockDim.x) sc[t] = 0;
  __syncthreads();
  const int s = blockIdx.y;
  const unsigned lane_bit = 1u << (threadIdx.x & 31);
  const int end = min(local, (blockIdx.x + 1) * trows);
  for (int r0 = blockIdx.x * trows; r0 < end; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    int o = -1;
    if (r < end) {
      const long long g = static_cast<long long>(s) * local + r;
      if (valid[g * vstride] != 0) {
        o = owner_map[rw::hash_lanes(rows + g * rstride, kw) & kVnodeMask];
      }
      own[g] = o;
    }
    const unsigned peers = __match_any_sync(kAll, o);
    if (o >= 0 && (peers & (lane_bit - 1u)) == 0) {
      atomicAdd(&sc[o], __popc(peers));
    }
  }
  __syncthreads();
  int32_t* c = counts + (static_cast<long long>(s) * ntiles + blockIdx.x) * S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) c[t] = sc[t];
}

// n int32 zeros from d on, by the block: 16-byte stores between a scalar
// head (to 16-byte alignment) and a scalar tail
__device__ void zero_range(int32_t* d, long long n) {
  const long long head =
      min(n, static_cast<long long>(
                 (4 - ((reinterpret_cast<uintptr_t>(d) >> 2) & 3)) & 3));
  if (threadIdx.x < head) d[threadIdx.x] = 0;
  int4* v = reinterpret_cast<int4*>(d + head);
  const long long nv = (n - head) >> 2;
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
    v[i] = make_int4(0, 0, 0, 0);
  }
  const long long done = head + (nv << 2);
  if (done + threadIdx.x < n) d[done + threadIdx.x] = 0;
}

__global__ void write_kernel(const int32_t* __restrict__ rows,
                             long long rstride, int local, int trows, int w,
                             int S, int bucket,
                             const int32_t* __restrict__ own,
                             const int32_t* __restrict__ counts, int ntiles,
                             int32_t* __restrict__ recv,
                             int32_t* __restrict__ rvalid,
                             int32_t* __restrict__ ovf) {
  extern __shared__ int sm[];
  int* base = sm;            // [S] next position per target in this tile
  int* tot = sm + S;         // [S] the sender's rows per target
  int* wc = sm + 2 * S;      // [kWarps][S] a chunk's counts, then offsets
  __shared__ long long src[kWarps][32];   // a warp's rows that fit ...
  __shared__ long long dst[kWarps][32];   // ... and where they land
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lane_bit = 1u << lane;
  for (int t = threadIdx.x; t < S; t += kThreads) base[t] = tot[t] = 0;
  __syncthreads();
  const int32_t* cs = counts + static_cast<long long>(s) * ntiles * S;
  for (int e = threadIdx.x; e < ntiles * S; e += kThreads) {
    const int v = cs[e];
    if (v != 0) {
      atomicAdd(&tot[e % S], v);
      if (e / S < tile) atomicAdd(&base[e % S], v);
    }
  }
  __syncthreads();
  if (tile == 0) {
    int over = 0;
    for (int t = threadIdx.x; t < S; t += kThreads) over |= tot[t] > bucket;
    over = __syncthreads_or(over);
    if (threadIdx.x == 0) ovf[s] = over ? 1 : 0;
  }
  const long long per_target = static_cast<long long>(S) * bucket;
  // the unused tail of each of this sender's buckets, cut evenly over its
  // tiles: written first, so its stores overlap the copy's loads
  for (int t = 0; t < S; ++t) {
    const long long used = min(tot[t], bucket);
    const long long left = bucket - used;
    if (left == 0) continue;
    const long long q0 = t * per_target + static_cast<long long>(s) * bucket +
                         used;
    const long long part = (left + ntiles - 1) / ntiles;
    const long long a = min(left, tile * part);
    const long long b = min(left, a + part);
    if (a == b) continue;
    zero_range(recv + (q0 + a) * w, (b - a) * w);
    zero_range(rvalid + q0 + a, b - a);
  }
  const int end = min(local, (tile + 1) * trows);
  for (int r0 = tile * trows; r0 < end; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const long long g = static_cast<long long>(s) * local + r;
    const int o = r < end ? own[g] : -1;
    const unsigned peers = __match_any_sync(kAll, o);
    const int rank = __popc(peers & (lane_bit - 1u));
    for (int i = threadIdx.x; i < kWarps * S; i += kThreads) wc[i] = 0;
    __syncthreads();
    if (o >= 0 && rank == 0) wc[warp * S + o] = __popc(peers);
    __syncthreads();
    for (int t = threadIdx.x; t < S; t += kThreads) {
      int run = base[t];
      for (int i = 0; i < kWarps; ++i) {
        const int v = wc[i * S + t];
        wc[i * S + t] = run;
        run += v;
      }
      base[t] = run;
    }
    __syncthreads();
    const int pos = o >= 0 ? wc[warp * S + o] + rank : bucket;
    const bool fit = pos < bucket;
    const unsigned fits = __ballot_sync(kAll, fit);
    if (fit) {
      const int k = __popc(fits & (lane_bit - 1u));
      const long long q = o * per_target + static_cast<long long>(s) * bucket +
                          pos;
      src[warp][k] = g;
      dst[warp][k] = q;
      rvalid[q] = 1;
    }
    __syncwarp();
    const int n = __popc(fits) * w;
    for (int e = lane; e < n; e += 32) {
      const int k = e / w;
      const int c = e - k * w;
      recv[dst[warp][k] * w + c] = rows[src[warp][k] * rstride + c];
    }
    __syncthreads();
  }
}

}  // namespace

// rows: int32 rows with `rstride` elements between rows; valid: int32
// flags, `vstride` elements apart. Scratch: own int32[S * local], counts
// int32[S * kMaxTiles * S] (kMaxTiles = 64, the most tiles a sender ever
// has, so the caller needs no copy of the tiling rule). Outputs: recv
// int32[S, S * bucket, w], rvalid int32[S, S * bucket], ovf int32[S].
RW_API int rw_route(const void* rows, long long rstride, const void* valid,
                    long long vstride, int S, int local, int kw, int w,
                    const void* owner_map, int bucket, void* own,
                    void* counts, void* recv, void* rvalid, void* ovf,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S > 256 || local < 0 || bucket < 0 || kw <= 0 || w < kw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (local == 0) {
    // no rows: every flag clear, the buffer all zeros
    const size_t nr = static_cast<size_t>(S) * S * bucket;
    cudaError_t e = cudaMemsetAsync(ovf, 0, sizeof(int32_t) * S, st);
    if (e == cudaSuccess && nr)
      e = cudaMemsetAsync(recv, 0, nr * w * sizeof(int32_t), st);
    if (e == cudaSuccess && nr)
      e = cudaMemsetAsync(rvalid, 0, nr * sizeof(int32_t), st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  // whole chunks a tile, at most kMaxTiles tiles a sender
  const int chunks = rw::blocks_for(local, kThreads);
  const int trows = rw::blocks_for(chunks, kMaxTiles) * kThreads;
  const int ntiles = rw::blocks_for(local, trows);
  const dim3 grid(ntiles, S);
  count_kernel<<<grid, kThreads, S * sizeof(int), st>>>(
      static_cast<const int32_t*>(rows), rstride,
      static_cast<const int32_t*>(valid), vstride, local, trows, kw,
      static_cast<const int32_t*>(owner_map), S, static_cast<int32_t*>(own),
      static_cast<int32_t*>(counts), ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  write_kernel<<<grid, kThreads, (2 + kWarps) * S * sizeof(int), st>>>(
      static_cast<const int32_t*>(rows), rstride, local, trows, w, S, bucket,
      static_cast<const int32_t*>(own), static_cast<const int32_t*>(counts),
      ntiles, static_cast<int32_t*>(recv), static_cast<int32_t*>(rvalid),
      static_cast<int32_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
