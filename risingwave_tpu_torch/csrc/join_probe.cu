// Kernel K6: join_probe — probe a batch of rows against a join side's
// chains, each row at its own message sequence, and write the packed
// pair matrix; over S independent join-side shards in one launch.
//
// Replaces risingwave_tpu/ops/hash_join.py:237 epoch_probe (B15) and, with
// no payload, :116 probe_pairs (B13); the read-only key probe of
// risingwave_tpu/ops/hash_table.py:137 lookup (B3) runs inside it. With
// S > 1 and a row-id lane, the per-shard probe of
// risingwave_tpu/parallel/join.py (B24: the steps at :391, :450, :717) on
// the rows `route` delivered to each shard, mapped back to global row ids.
//
// One thread per probe row, two launches over 1024-row tiles, grid.y =
// shard:
//   count_kernel  lookup (linear probe from the row hash, KW lanes
//                 compared, stopping at an empty slot; bounded by cap
//                 steps, stats[1] flags a row that ran out), then a walk
//                 of the slot's chain counting refs visible at the row's
//                 sequence (ins_seq < seq <= del_seq). It keeps the
//                 degree and the chain head per row and the tile's sum.
//   emit_kernel   the exclusive scan of the degrees: each block sums the
//                 tiles before it and scans its own tile with warp
//                 shuffles. Then each row walks its chain again and writes
//                 [probe_row, ref, pay[ref]..., (deg_self[ref])] at its
//                 offsets while they are below out_cap. Block 0 writes the
//                 header [total, 0, ...] with the TRUE total, so a caller
//                 whose buffer overflowed re-dispatches with a larger one;
//                 all blocks fill the pair rows at or past the total with
//                 the reference's padding (-1, -1, 0, ...). With degrees
//                 it also writes the degree rows [deg, 0, ...] and does the
//                 two scatter-adds of epoch_probe: deg_self[ref] += the
//                 probe row's sign for every written pair, and
//                 deg_sink[ins_ref] += deg for every insert row (into
//                 copies the wrapper made: the originals stay untouched for
//                 a re-dispatch).
//
// Shards: shard s reads its n rows at its own shard stride of every row
// input, probes its own table and chains (cap slots, row_cap refs: refs
// are GLOBAL, a ref lives on its key's owner shard only), and writes its
// own block of the output [S, 1 + (n) + out_cap, W], its own scratch and
// its own stats; each block's header keeps that shard's TRUE total, so a
// caller re-dispatches when the worst shard overflowed. With a row-id lane
// (`rid`, the global row of each routed row), a pair row writes rid[row]
// instead of the local row, and a degree row writes (deg, rvalid ? rid :
// -1): route's empty received rows (rvalid 0) are never probed and show
// -1.
//
// Output order equals the reference's: pairs by probe row, then by chain
// order (K5 builds the chains in the reference's order).
//
// What bounds it on the card: the chain walks are dependent loads
// (latency), and bytes beyond them — each row reads its key lanes, aux
// entries and visited chain entries, and writes its pair rows. A hot key
// makes one thread walk a long chain twice; that is left simple. On the
// sharded path each shard also reads the flags of its mostly empty
// receive block and writes its degree rows.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__device__ __forceinline__ int lookup_slot(const int32_t* key, int k,
                                           const int32_t* __restrict__ tkeys,
                                           const int32_t* __restrict__ occ,
                                           long long cap, int32_t* stats) {
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  uint32_t slot = rw::hash_lanes(key, k) & mask;
  for (long long step = 0; step < cap; ++step) {
    if (occ[slot] == 0) return -1;
    const int32_t* cur = tkeys + static_cast<size_t>(slot) * k;
    bool eq = true;
    for (int i = 0; i < k; ++i) eq = eq && (cur[i] == key[i]);
    if (eq) return static_cast<int>(slot);
    slot = (slot + 1u) & mask;
  }
  atomicExch(&stats[1], 1);
  return -1;
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
  __syncthreads();
  return t;
}

struct Probe {
  const int32_t* keys;
  long long key_stride, key_ss;
  int k;
  const int32_t* vis;
  long long vis_stride, vis_ss;
  int vis_bits;
  const int32_t* seq;
  long long seq_stride, seq_ss;
  const int32_t* aux;  // [S, n, 4] or null
  int n;
  const int32_t* rid;  // routed global row ids, or null
  long long rid_stride, rid_ss;
  const int32_t* rvalid;
  long long rvalid_stride, rvalid_ss;
  const int32_t* tkeys;
  const int32_t* occ;
  long long cap;
  const int32_t* head;
  const int32_t* next;
  const int32_t* ins_seq;
  const int32_t* del_seq;
  long long row_cap;
  const int32_t* pay;
  int p;
  const int32_t* deg_self;
  int32_t* deg_self_out;
  int32_t* deg_sink_out;
  long long sink_cap;
  int deg_rows;
  int old_col;
  int scatter;
  int32_t* out;
  long long out_cap;
  int w;
  int ntiles;
  int32_t* deg;
  int32_t* cur0;
  int32_t* tile_sum;
  int32_t* stats;
};

template <typename T>
__device__ __forceinline__ T* adv(T* p, long long off) {
  return p == nullptr ? p : p + off;
}

// The shard's view: every pointer moved to shard s's part.
__device__ __forceinline__ Probe shard_view(Probe q, long long s) {
  q.keys = adv(q.keys, s * q.key_ss);
  q.vis = adv(q.vis, s * q.vis_ss);
  q.seq = adv(q.seq, s * q.seq_ss);
  q.aux = adv(q.aux, s * q.n * 4);
  q.rid = adv(q.rid, s * q.rid_ss);
  q.rvalid = adv(q.rvalid, s * q.rvalid_ss);
  q.tkeys = adv(q.tkeys, s * q.cap * q.k);
  q.occ = adv(q.occ, s * q.cap);
  q.head = adv(q.head, s * q.cap);
  q.next = adv(q.next, s * q.row_cap);
  q.ins_seq = adv(q.ins_seq, s * q.row_cap);
  q.del_seq = adv(q.del_seq, s * q.row_cap);
  q.pay = adv(q.pay, s * q.row_cap * q.p);
  q.deg_self = adv(q.deg_self, s * q.row_cap);
  q.deg_self_out = adv(q.deg_self_out, s * q.row_cap);
  q.deg_sink_out = adv(q.deg_sink_out, s * q.sink_cap);
  q.out = adv(q.out, s * (1 + (q.deg_rows ? q.n : 0) + q.out_cap) * q.w);
  q.deg = adv(q.deg, s * (2LL * q.n + q.ntiles));
  q.cur0 = q.deg + q.n;
  q.tile_sum = q.cur0 + q.n;
  q.stats = adv(q.stats, s * 2);
  return q;
}

__global__ void count_kernel(Probe q0) {
  __shared__ int sh[32];
  const Probe q = shard_view(q0, blockIdx.y);
  const int i = blockIdx.x * kTile + threadIdx.x;
  int d = 0;
  if (i < q.n) {
    int c = -1;
    if ((q.vis[static_cast<long long>(i) * q.vis_stride] & q.vis_bits) != 0) {
      const int s = lookup_slot(q.keys + static_cast<long long>(i) *
                                             q.key_stride,
                                q.k, q.tkeys, q.occ, q.cap, q.stats);
      if (s >= 0) c = q.head[s];
    }
    const int32_t sq = q.seq[static_cast<long long>(i) * q.seq_stride];
    for (int cur = c; cur >= 0; cur = q.next[cur]) {
      if (q.ins_seq[cur] < sq && q.del_seq[cur] >= sq) ++d;
    }
    q.deg[i] = d;
    q.cur0[i] = c;
  }
  const int t = block_sum(d, sh);
  if (threadIdx.x == 0) q.tile_sum[blockIdx.x] = t;
}

__global__ void emit_kernel(Probe q0) {
  __shared__ int sh[32];
  __shared__ int warp_sums[kTile / 32];
  const Probe q = shard_view(q0, blockIdx.y);
  // tiles before this one, and all tiles
  int before = 0;
  int all = 0;
  for (int j = threadIdx.x; j < q.ntiles; j += blockDim.x) {
    const int v = q.tile_sum[j];
    all += v;
    if (j < static_cast<int>(blockIdx.x)) before += v;
  }
  const int base = block_sum(before, sh);
  const int total = block_sum(all, sh);
  // exclusive scan of this tile's degrees
  const int i = blockIdx.x * kTile + threadIdx.x;
  const int d = i < q.n ? q.deg[i] : 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = d;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int wbase = 0;
  for (int j = 0; j < warp; ++j) wbase += warp_sums[j];
  const long long pair0 = 1 + (q.deg_rows ? q.n : 0);
  if (i < q.n) {
    long long wp = base + wbase + incl - d;
    const int32_t row_id =
        q.rid != nullptr ? q.rid[static_cast<long long>(i) * q.rid_stride]
                         : i;
    if (q.deg_rows) {
      int32_t* row = q.out + (1 + static_cast<long long>(i)) * q.w;
      row[0] = d;
      for (int c = 1; c < q.w; ++c) row[c] = 0;
      if (q.rid != nullptr) {
        row[1] = q.rvalid[static_cast<long long>(i) * q.rvalid_stride] != 0
                     ? row_id
                     : -1;
      }
    }
    const int32_t sq = q.seq[static_cast<long long>(i) * q.seq_stride];
    const bool neg = q.scatter && (q.aux[i * 4 + 2] & 8) != 0;  // FLAG_NEG
    for (int cur = q.cur0[i]; cur >= 0; cur = q.next[cur]) {
      if (!(q.ins_seq[cur] < sq && q.del_seq[cur] >= sq)) continue;
      if (wp < q.out_cap) {
        int32_t* row = q.out + (pair0 + wp) * q.w;
        row[0] = row_id;
        row[1] = cur;
        const int32_t* src = q.pay + static_cast<long long>(cur) * q.p;
        for (int c = 0; c < q.p; ++c) row[2 + c] = src[c];
        if (q.old_col) row[2 + q.p] = q.deg_self[cur];
        if (q.scatter) atomicAdd(&q.deg_self_out[cur], neg ? -1 : 1);
      }
      ++wp;
    }
    if (q.scatter && (q.aux[i * 4 + 2] & 2) != 0) {  // FLAG_INS
      const long long r = q.aux[i * 4 + 0];
      if (r >= 0 && r < q.sink_cap) atomicAdd(&q.deg_sink_out[r], d);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    q.out[0] = total;
    for (int c = 1; c < q.w; ++c) q.out[c] = 0;
  }
  for (long long r = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
       r < q.out_cap; r += static_cast<long long>(gridDim.x) * kTile) {
    if (r < total) continue;
    int32_t* row = q.out + (pair0 + r) * q.w;
    row[0] = -1;
    row[1] = -1;
    for (int c = 2; c < q.w; ++c) row[c] = 0;
  }
}

}  // namespace

// Row inputs have a row stride and a shard stride (seq may have both 0:
// one scalar). The table is keys int32[S, cap, k] + occ int32[S, cap], the
// chains head int32[S, cap] + next/ins_seq/del_seq int32[S, row_cap]; pay,
// degrees and aux (S = 1 only on the paths that use them) follow the same
// shard layout. rid/rvalid: the routed row-id lane and the route's valid
// flags, or null (pair rows then carry the local row). out: int32[S, 1 +
// (deg_rows ? n : 0) + out_cap, w]. scratch: int32[S, 2n + ntiles]
// (degrees, chain heads, tile sums); stats: int32[S, 2] = [0, lookup
// overflow], zeroed here.
RW_API int rw_join_probe(
    const void* keys, long long key_stride, long long key_ss, int k,
    const void* vis, long long vis_stride, long long vis_ss, int vis_bits,
    const void* seq, long long seq_stride, long long seq_ss, const void* aux,
    int n, int shards, const void* rid, long long rid_stride,
    long long rid_ss, const void* rvalid, long long rvalid_stride,
    long long rvalid_ss, const void* tkeys, const void* occ, long long cap,
    const void* head, const void* next, const void* ins_seq,
    const void* del_seq, long long row_cap, const void* pay, int p,
    const void* deg_self, void* deg_self_out, void* deg_sink_out,
    long long sink_cap, int deg_rows, int old_col, int scatter, void* out,
    long long out_cap, int w, void* scratch, void* stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shards <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e =
      cudaMemsetAsync(stats, 0, 2 * sizeof(int32_t) * shards, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  Probe q;
  q.keys = static_cast<const int32_t*>(keys);
  q.key_stride = key_stride;
  q.key_ss = key_ss;
  q.k = k;
  q.vis = static_cast<const int32_t*>(vis);
  q.vis_stride = vis_stride;
  q.vis_ss = vis_ss;
  q.vis_bits = vis_bits;
  q.seq = static_cast<const int32_t*>(seq);
  q.seq_stride = seq_stride;
  q.seq_ss = seq_ss;
  q.aux = static_cast<const int32_t*>(aux);
  q.n = n;
  q.rid = static_cast<const int32_t*>(rid);
  q.rid_stride = rid_stride;
  q.rid_ss = rid_ss;
  q.rvalid = static_cast<const int32_t*>(rvalid);
  q.rvalid_stride = rvalid_stride;
  q.rvalid_ss = rvalid_ss;
  q.tkeys = static_cast<const int32_t*>(tkeys);
  q.occ = static_cast<const int32_t*>(occ);
  q.cap = cap;
  q.head = static_cast<const int32_t*>(head);
  q.next = static_cast<const int32_t*>(next);
  q.ins_seq = static_cast<const int32_t*>(ins_seq);
  q.del_seq = static_cast<const int32_t*>(del_seq);
  q.row_cap = row_cap;
  q.pay = static_cast<const int32_t*>(pay);
  q.p = p;
  q.deg_self = static_cast<const int32_t*>(deg_self);
  q.deg_self_out = static_cast<int32_t*>(deg_self_out);
  q.deg_sink_out = static_cast<int32_t*>(deg_sink_out);
  q.sink_cap = sink_cap;
  q.deg_rows = deg_rows;
  q.old_col = old_col;
  q.scatter = scatter;
  q.out = static_cast<int32_t*>(out);
  q.out_cap = out_cap;
  q.w = w;
  q.ntiles = ntiles;
  q.deg = static_cast<int32_t*>(scratch);
  q.cur0 = q.deg + n;
  q.tile_sum = q.cur0 + n;
  q.stats = static_cast<int32_t*>(stats);
  const dim3 grid(ntiles, shards);
  if (n > 0) {
    count_kernel<<<grid, kTile, 0, st>>>(q);
  } else {
    e = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * shards, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  emit_kernel<<<grid, kTile, 0, st>>>(q);
  return static_cast<int>(cudaGetLastError());
}
