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
// Two launches a call, one thread per probe row, 256-row tiles (a 2^16-row
// epoch is 256 blocks), grid.y = shard:
//   count_kernel  the lookup through rw::find_slot (common.cuh: a group
//                 of 4 slots a step, their occ words and lanes loaded
//                 together, K <= 8 lanes held in registers; a shard's
//                 chains run ~50 slots to a stored key, ~110 to an empty
//                 one; bounded by cap slots, a row that runs out
//                 sets the tile's overflow flag), then one walk of the
//                 slot's chain counting the refs visible at the row's
//                 sequence (ins_seq < seq <= del_seq). Each row keeps
//                 (degree, first visible ref, second visible ref, the
//                 chain entry after the second) in one 16-byte scratch
//                 entry; each tile keeps (sum of degrees, overflow flag).
//   emit_kernel   every block sums the tile entries before its own and
//                 all of them (the tiles are few: one load a thread), and
//                 scans its tile's degrees with warp shuffles and one
//                 barrier. Each row writes [probe_row, ref, pay[ref]...,
//                 (deg_self[ref])] at its offsets while they are below
//                 out_cap: its first two refs from scratch (q8's chains
//                 hold one ref: no second walk), then the rest of a longer
//                 chain from the kept entry on. Block 0 writes the header
//                 [total, 0, ...] with the TRUE total, so a caller whose
//                 buffer overflowed re-dispatches with a larger one, and
//                 stats [0, overflow] (no memset launch). The pair rows
//                 at or past the total get the reference's padding (-1,
//                 -1, 0, ...): one flat range of the shard's block, cut
//                 among all blocks and written with 16-byte stores. With
//                 degrees it also writes the degree rows [deg, 0, ...]
//                 and does the two scatter-adds of epoch_probe:
//                 deg_self[ref] += the probe row's sign for every written
//                 pair, and deg_sink[ins_ref] += deg for every insert row
//                 (into copies the wrapper made: the originals stay
//                 untouched for a re-dispatch).
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
// (latency): a probe row costs the lookup's trip (occ and lanes), the
// head's, and one a chain entry (next, ins_seq, del_seq together); bytes
// beyond them — each row's key lanes, aux entries and visited chain
// entries read, its pair rows and the padding written. A hot key makes
// one thread walk a long chain, once to count and once past its first
// two refs to emit; that is left simple.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kWarps = kTile / 32;
constexpr int kPadInts = kTile * 16;   // padding ints a block takes

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
  int4* rows;   // [S, n]: degree, ref0, ref1, the entry after ref1
  int2* tiles;  // [S, ntiles]: degree sum, overflow flag
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
  q.rows = adv(q.rows, s * q.n);
  q.tiles = adv(q.tiles, s * q.ntiles);
  q.stats = adv(q.stats, s * 2);
  return q;
}

__device__ __forceinline__ bool visible(const Probe& q, int cur,
                                        int32_t sq) {
  return __ldg(q.ins_seq + cur) < sq && __ldg(q.del_seq + cur) >= sq;
}

// Write w ints val(0..w-1) at row: 16-byte stores where the row and w
// allow, else 8-byte, else one by one.
template <class F>
__device__ __forceinline__ void store_row(int32_t* row, int w, F val) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  if ((w & 3) == 0 && (a & 15) == 0) {
    for (int c = 0; c < w; c += 4) {
      reinterpret_cast<int4*>(row)[c >> 2] =
          make_int4(val(c), val(c + 1), val(c + 2), val(c + 3));
    }
  } else if ((w & 1) == 0 && (a & 7) == 0) {
    for (int c = 0; c < w; c += 2) {
      reinterpret_cast<int2*>(row)[c >> 1] = make_int2(val(c), val(c + 1));
    }
  } else {
    for (int c = 0; c < w; ++c) row[c] = val(c);
  }
}

template <class Key>
__global__ void __launch_bounds__(kTile) count_kernel(Probe q0) {
  __shared__ int s_sum[kWarps];
  __shared__ int s_ovf[kWarps];
  const Probe q = shard_view(q0, blockIdx.y);
  const int i = blockIdx.x * kTile + threadIdx.x;
  int d = 0;
  bool ovf = false;
  if (i < q.n) {
    int c = -1;
    if ((q.vis[static_cast<long long>(i) * q.vis_stride] & q.vis_bits) != 0) {
      Key key(q.k);
      key.load(q.keys + static_cast<long long>(i) * q.key_stride);
      const int s = rw::find_slot(key, q.tkeys, q.occ,
                                  static_cast<uint32_t>(q.cap));
      ovf = s == -2;
      if (s >= 0) c = __ldg(q.head + s);
    }
    const int32_t sq = q.seq[static_cast<long long>(i) * q.seq_stride];
    int r0 = -1, r1 = -1, after = -1;
    for (int cur = c; cur >= 0;) {
      const int nx = __ldg(q.next + cur);
      if (visible(q, cur, sq)) {
        if (d == 0) {
          r0 = cur;
        } else if (d == 1) {
          r1 = cur;
          after = nx;
        }
        ++d;
      }
      cur = nx;
    }
    q.rows[i] = make_int4(d, r0, r1, after);
  }
  const int sum = __reduce_add_sync(0xffffffffu, d);
  const unsigned f = __ballot_sync(0xffffffffu, ovf);
  if ((threadIdx.x & 31) == 0) {
    s_sum[threadIdx.x >> 5] = sum;
    s_ovf[threadIdx.x >> 5] = f != 0u;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0, o = 0;
    for (int j = 0; j < kWarps; ++j) {
      t += s_sum[j];
      o |= s_ovf[j];
    }
    q.tiles[blockIdx.x] = make_int2(t, o);
  }
}

// One pair row at offset wp (dropped past out_cap), and its degree add.
__device__ __forceinline__ void emit_pair(const Probe& q, long long pair0,
                                          long long wp, int32_t row_id,
                                          int cur, bool neg) {
  if (wp >= q.out_cap) return;
  const int32_t* src = q.pay + static_cast<long long>(cur) * q.p;
  store_row(q.out + (pair0 + wp) * q.w, q.w, [&](int c) -> int32_t {
    return c == 0           ? row_id
           : c == 1         ? cur
           : c < 2 + q.p    ? __ldg(src + c - 2)
                            : __ldg(q.deg_self + cur);
  });
  if (q.scatter) atomicAdd(&q.deg_self_out[cur], neg ? -1 : 1);
}

__global__ void __launch_bounds__(kTile) emit_kernel(Probe q0) {
  __shared__ int s_scan[kWarps], s_before[kWarps], s_all[kWarps],
      s_ovf[kWarps];
  const Probe q = shard_view(q0, blockIdx.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the tiles before this block's, all tiles, any overflow
  int before = 0, all = 0, ovf = 0;
  for (int t = threadIdx.x; t < q.ntiles; t += kTile) {
    const int2 v = q.tiles[t];
    all += v.x;
    ovf |= v.y;
    if (t < static_cast<int>(blockIdx.x)) before += v.x;
  }
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool mine = static_cast<int>(blockIdx.x) < q.ntiles && i < q.n;
  const int4 e = mine ? q.rows[i] : make_int4(0, -1, -1, -1);
  const int d = e.x;
  int incl = d;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  before = __reduce_add_sync(0xffffffffu, before);
  all = __reduce_add_sync(0xffffffffu, all);
  ovf = static_cast<int>(
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(ovf)));
  if (lane == 31) s_scan[warp] = incl;
  if (lane == 0) {
    s_before[warp] = before;
    s_all[warp] = all;
    s_ovf[warp] = ovf;
  }
  __syncthreads();
  int base = 0, total = 0, any = 0, wbase = 0;
  for (int j = 0; j < kWarps; ++j) {
    base += s_before[j];
    total += s_all[j];
    any |= s_ovf[j];
    if (j < warp) wbase += s_scan[j];
  }
  const long long pair0 = 1 + (q.deg_rows ? q.n : 0);
  if (mine) {
    long long wp = static_cast<long long>(base) + wbase + incl - d;
    const int32_t row_id =
        q.rid != nullptr ? q.rid[static_cast<long long>(i) * q.rid_stride]
                         : i;
    if (q.deg_rows) {
      const int32_t second =
          q.rid == nullptr ? 0
          : q.rvalid[static_cast<long long>(i) * q.rvalid_stride] != 0
              ? row_id
              : -1;
      store_row(q.out + (1 + static_cast<long long>(i)) * q.w, q.w,
                [&](int c) -> int32_t {
                  return c == 0 ? d : c == 1 ? second : 0;
                });
    }
    const bool neg = q.scatter && (q.aux[i * 4 + 2] & 8) != 0;  // FLAG_NEG
    if (d > 0) emit_pair(q, pair0, wp++, row_id, e.y, neg);
    if (d > 1) emit_pair(q, pair0, wp++, row_id, e.z, neg);
    if (d > 2) {
      const int32_t sq = q.seq[static_cast<long long>(i) * q.seq_stride];
      for (int cur = e.w, left = d - 2; left > 0;) {
        const int nx = __ldg(q.next + cur);
        if (visible(q, cur, sq)) {
          emit_pair(q, pair0, wp++, row_id, cur, neg);
          --left;
        }
        cur = nx;
      }
    }
    if (q.scatter && (q.aux[i * 4 + 2] & 2) != 0) {  // FLAG_INS
      const long long r = q.aux[i * 4 + 0];
      if (r >= 0 && r < q.sink_cap) atomicAdd(&q.deg_sink_out[r], d);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    q.out[0] = total;
    for (int c = 1; c < q.w; ++c) q.out[c] = 0;
    q.stats[0] = 0;
    q.stats[1] = any;
  }
  // padding: elements [first, end) of the shard's block, column c of a
  // row -1 for c < 2, else 0; 16-byte stores over the aligned body
  const long long rel0 = pair0 * q.w;
  const long long first =
      rel0 + (total < q.out_cap ? static_cast<long long>(total) : q.out_cap) *
                 q.w;
  const long long end = rel0 + q.out_cap * q.w;
  if (first >= end) return;
  auto pad = [&](long long x) -> int32_t {
    return (x - rel0) % q.w < 2 ? -1 : 0;
  };
  const long long head =
      ((16 - (reinterpret_cast<uintptr_t>(q.out + first) & 15)) & 15) / 4;
  const long long body0 = first + head < end ? first + head : end;
  const long long nvec = (end - body0) / 4;
  const long long body1 = body0 + nvec * 4;
  if (blockIdx.x == 0) {
    if (threadIdx.x < body0 - first) {
      q.out[first + threadIdx.x] = pad(first + threadIdx.x);
    }
    if (threadIdx.x < end - body1) {
      q.out[body1 + threadIdx.x] = pad(body1 + threadIdx.x);
    }
  }
  for (long long j = static_cast<long long>(blockIdx.x) * kTile +
                     threadIdx.x;
       j < nvec; j += static_cast<long long>(gridDim.x) * kTile) {
    const long long x = body0 + 4 * j;
    reinterpret_cast<int4*>(q.out + x)[0] =
        make_int4(pad(x), pad(x + 1), pad(x + 2), pad(x + 3));
  }
}

}  // namespace

// Row inputs have a row stride and a shard stride (seq may have both 0:
// one scalar). The table is keys int32[S, cap, k] + occ int32[S, cap], the
// chains head int32[S, cap] + next/ins_seq/del_seq int32[S, row_cap]; pay,
// degrees and aux (S = 1 only on the paths that use them) follow the same
// shard layout. rid/rvalid: the routed row-id lane and the route's valid
// flags, or null (pair rows then carry the local row). out: int32[S, 1 +
// (deg_rows ? n : 0) + out_cap, w]. scratch: int32[S * (4n + 2 *
// ceil(n / 256))] (16-byte aligned; per-row entries, then per-tile
// entries); stats: int32[S, 2] = [0, lookup overflow], written by the
// launches.
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
  const int ntiles = (n + kTile - 1) / kTile;
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
  q.rows = static_cast<int4*>(scratch);
  q.tiles = reinterpret_cast<int2*>(q.rows + static_cast<long long>(shards) *
                                                 n);
  q.stats = static_cast<int32_t*>(stats);
  if (n > 0) {
    const dim3 grid(ntiles, shards);
#define RW_LAUNCH(KEY) count_kernel<KEY><<<grid, kTile, 0, st>>>(q)
    RW_LANES_SWITCH(k, rw::groups_aligned(tkeys, occ, cap), RW_LAUNCH)
#undef RW_LAUNCH
  }
  const long long pad_blocks = (out_cap * w + kPadInts - 1) / kPadInts;
  long long blocks = ntiles > pad_blocks ? ntiles : pad_blocks;
  if (blocks < 1) blocks = 1;
  emit_kernel<<<dim3(static_cast<unsigned>(blocks), shards), kTile, 0, st>>>(
      q);
  return static_cast<int>(cudaGetLastError());
}
