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
// Design: a count pass, a scan and a write pass, no atomics on the output
// (the reference keeps input order inside a bucket, and that order decides
// which row K1's plain rule lets win a slot and the order of float SUM's
// adds).
//   count_kernel  grid (tiles, S), one 1024-row tile of one sender block
//                 per block: each valid row's owner (the B1 hash of its
//                 first kw lanes, & 255, through the owner map) into a
//                 scratch, and per-target counts of the tile;
//   scan_kernel   one block per sender: exclusive offsets of each tile per
//                 target, the sender's totals and its overflow flag;
//   write_kernel  grid (tiles, S): a row's position is its tile's offset +
//                 the counts of earlier warps of the tile (a block scan) +
//                 its rank among its warp's lanes of the same owner
//                 (__match_any_sync); rows that fit are copied whole. The
//                 tiles of a sender then zero the unused tail of each of
//                 its buckets.
// The payload width is a runtime argument: the agg's packed batch and the
// reshard's whole state rows (keys and every state row) use one kernel.
//
// What bounds it on the card: bytes — the rows are read once (W lanes) and
// the receive buffer written once (S * S * bucket rows of W lanes, most of
// them zeros when the bucket is the whole block).
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kVnodeMask = 255;

__global__ void count_kernel(const int32_t* __restrict__ rows,
                             long long rstride,
                             const int32_t* __restrict__ valid,
                             long long vstride, int local, int kw,
                             const int32_t* __restrict__ owner_map, int S,
                             int32_t* __restrict__ own,
                             int32_t* __restrict__ counts, int ntiles) {
  extern __shared__ int sc[];  // S counters
  for (int t = threadIdx.x; t < S; t += blockDim.x) sc[t] = 0;
  __syncthreads();
  const int s = blockIdx.y;
  const int r = blockIdx.x * kTile + threadIdx.x;
  if (r < local) {
    const long long g = static_cast<long long>(s) * local + r;
    int o = -1;
    if (valid[g * vstride] != 0) {
      const uint32_t h = rw::hash_lanes(rows + g * rstride, kw);
      o = owner_map[h & kVnodeMask];
      atomicAdd(&sc[o], 1);
    }
    own[g] = o;
  }
  __syncthreads();
  int32_t* c = counts + (static_cast<long long>(s) * ntiles + blockIdx.x) * S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) c[t] = sc[t];
}

// counts become exclusive per-tile offsets; total[s, t]; ovf[s]
__global__ void scan_kernel(int32_t* __restrict__ counts, int ntiles, int S,
                            int bucket, int32_t* __restrict__ total,
                            int32_t* __restrict__ ovf) {
  const int s = blockIdx.x;
  int over = 0;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    int run = 0;
    for (int i = 0; i < ntiles; ++i) {
      int32_t* c = counts + (static_cast<long long>(s) * ntiles + i) * S + t;
      const int v = *c;
      *c = run;
      run += v;
    }
    total[s * S + t] = run;
    over |= run > bucket;
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) ovf[s] = over ? 1 : 0;
}

__global__ void write_kernel(const int32_t* __restrict__ rows,
                             long long rstride, int local, int w, int S,
                             int bucket, const int32_t* __restrict__ own,
                             const int32_t* __restrict__ offs,
                             const int32_t* __restrict__ total, int ntiles,
                             int32_t* __restrict__ recv,
                             int32_t* __restrict__ rvalid) {
  extern __shared__ int wc[];  // [32 warps][S] counts, then offsets
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = threadIdx.x; i < 32 * S; i += blockDim.x) wc[i] = 0;
  __syncthreads();
  const int r = tile * kTile + threadIdx.x;
  const long long g = static_cast<long long>(s) * local + r;
  const int o = r < local ? own[g] : -1;
  const unsigned same = __match_any_sync(0xffffffffu, o);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (o >= 0 && rank == 0) wc[warp * S + o] = __popc(same);
  __syncthreads();
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    int run = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int v = wc[i * S + t];
      wc[i * S + t] = run;
      run += v;
    }
  }
  __syncthreads();
  const long long per_target = static_cast<long long>(S) * bucket;
  if (o >= 0) {
    const int pos = offs[(static_cast<long long>(s) * ntiles + tile) * S + o] +
                    wc[warp * S + o] + rank;
    if (pos < bucket) {
      const long long q = o * per_target + static_cast<long long>(s) * bucket +
                          pos;
      const int32_t* src = rows + g * rstride;
      int32_t* dst = recv + q * w;
      for (int c = 0; c < w; ++c) dst[c] = src[c];
      rvalid[q] = 1;
    }
  }
  // zero the unused tail of each of this sender's buckets, split across its
  // tiles
  for (int t = 0; t < S; ++t) {
    const int used = min(total[s * S + t], bucket);
    const long long b0 = t * per_target + static_cast<long long>(s) * bucket;
    for (long long p = used + static_cast<long long>(tile) * blockDim.x +
                       threadIdx.x;
         p < bucket; p += static_cast<long long>(ntiles) * blockDim.x) {
      int32_t* dst = recv + (b0 + p) * w;
      for (int c = 0; c < w; ++c) dst[c] = 0;
      rvalid[b0 + p] = 0;
    }
  }
}

}  // namespace

// rows: int32 rows with `rstride` elements between rows; valid: int32
// flags, `vstride` elements apart. Scratch: own int32[S * local], counts
// int32[S * ceil(local / 1024) * S], total int32[S * S]. Outputs: recv
// int32[S, S * bucket, w], rvalid int32[S, S * bucket], ovf int32[S].
RW_API int rw_route(const void* rows, long long rstride, const void* valid,
                    long long vstride, int S, int local, int kw, int w,
                    const void* owner_map, int bucket, void* own,
                    void* counts, void* total, void* recv, void* rvalid,
                    void* ovf, void* stream) {
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
  const int ntiles = rw::blocks_for(local, kTile);
  const dim3 grid(ntiles, S);
  count_kernel<<<grid, kTile, S * sizeof(int), st>>>(
      static_cast<const int32_t*>(rows), rstride,
      static_cast<const int32_t*>(valid), vstride, local, kw,
      static_cast<const int32_t*>(owner_map), S, static_cast<int32_t*>(own),
      static_cast<int32_t*>(counts), ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<S, 256, 0, st>>>(static_cast<int32_t*>(counts), ntiles, S,
                                 bucket, static_cast<int32_t*>(total),
                                 static_cast<int32_t*>(ovf));
  e = cudaGetLastError();
  if (e != cudaSuccess || bucket == 0) return static_cast<int>(e);
  write_kernel<<<grid, kTile, 32 * S * sizeof(int), st>>>(
      static_cast<const int32_t*>(rows), rstride, local, w, S, bucket,
      static_cast<const int32_t*>(own), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(total), ntiles,
      static_cast<int32_t*>(recv), static_cast<int32_t*>(rvalid));
  return static_cast<int>(cudaGetLastError());
}
