// Kernel K5: join_apply — link a batch of rows into their key chains,
// tombstone deletes, and scatter the inserted rows' payload lanes, over S
// independent join-side shards in one launch.
//
// Replaces risingwave_tpu/ops/hash_join.py:68 link_rows (B11), :106
// tombstone_rows (B12) and the rest of :203 epoch_apply (B14) after K1
// (probe_insert) has given each insert row its key slot; with S > 1, the
// per-shard apply of risingwave_tpu/parallel/join.py (B24: the steps at
// :391, :489, :514, :645) on the rows `route` delivered to each shard.
//
// Chain order is the point of this kernel. link_rows keeps BATCH ORDER
// among the rows of one slot (the reference's stable sort by slot): the
// first row (lowest batch index) becomes the new head, each row's next is
// the next same-slot row, and the last row points at the old head. Probe
// pairs come out in chain order, so the emitted chunks depend on it.
//
// What bounds it on the card: bytes for the common case (each row reads
// its flags, slot, ref and sequence and writes its next, ins_seq and P
// payload lanes; the chain arrays are touched only at the batch's refs
// and slots: ~1.6 us at q8's 2^16-row side-epoch), so the launch floor and
// the round trips on a row's path decide its time. The design:
//
//   - ONE launch a call. A warp takes a tile of 32 consecutive rows of one
//     shard (tiles over every shard, so a mostly empty receive block of
//     `route` costs only its flag reads). Phase A pushes, phase B links;
//     between them one grid-wide barrier, so the launch is cooperative
//     (every block resident). A row's inputs are loaded at once, and with
//     one round of tiles (the paths' shapes) they stay in registers
//     across the barrier. Only the pushes come before the barrier: a
//     row's own writes (tombstone, insert sequence, payload), which no
//     row of the launch reads, come after it, so the barrier's fence
//     waits for the pushes alone.
//   - Rows of a warp that share a slot are matched with __match_any_sync:
//     the group's lanes are in batch order, each lane's successor is the
//     next lane of its group, and only the group's first lane (its leader)
//     joins the slot's cross-warp list: phase A pushes it with one 64-bit
//     atomicExch of (generation << 32 | row) on the slot's bucket word and
//     keeps (previous leader, old head) beside its row. The old head is
//     read in phase A, before any head is written, so the slot's last row
//     takes it from its own group's leader in phase B; only the slot's
//     first row writes the head.
//   - No restore pass: a bucket word of an older generation reads as
//     empty. The wrapper hands each launch a new generation (a counter
//     kept with the scratch, which is zeroed again only when the 32-bit
//     counter wraps); the grid barrier's word is tagged the same way.
//   - Batch order without a quadratic walk: in phase B each leader reads
//     its slot's bucket word and its own entry at once; a lone group (a
//     key whose rows of the batch fall in one warp, as q8's do: the
//     bucket holds it and it pushed first) needs nothing more. Otherwise
//     the leader walks the slot's list, up to kWalk groups, for the next
//     group and whether an earlier one exists. A group of a slot of more
//     groups (a hot key spread over the batch) finds its neighbours in
//     the batch itself: its warp reads the slot column from its tile,
//     coalesced, forward to the slot's next row and backward to any
//     earlier one, so each scan ends at the nearest row of the slot and
//     the groups together read the batch about once (no sort, no walk).
//   - Payload stores are coalesced: a warp copies its 32 rows' P lanes
//     word by word (lane l takes words l, l + 32, ... of the tile, loaded
//     before any is stored), so the refs of a fresh epoch, which are
//     consecutive, give neighbouring threads neighbouring words of
//     pay[row_cap, P].
//
// Every part is optional: link only (JoinSideKernel.insert, rebuild),
// tombstone only (delete: no barrier, an ordinary launch), or everything
// (epoch_apply). Shard s reads its n rows at its own shard stride of every
// row input (the routed receive block of `route`, or one batch with S =
// 1), and writes its own head (cap per shard) and next/ins_seq/del_seq/pay
// (row_cap per shard, indexed by the GLOBAL row ref: a ref lives on its
// key's owner shard only). Rows whose insert and delete bits are both off
// touch nothing: route's empty received rows carry zero flags (their ref
// 0 is a real ref, so the flags decide).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWalk = 8;         // warp groups a leader walks; more: each
                                 // group scans for its neighbours
constexpr int kScanRegs = 8;     // 32-row chunks a lane loads at once there
constexpr int kPayRegs = 8;      // payload words a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kLow = 0xffffffffull;

struct Apply {
  const int32_t* slots;
  long long slots_ss;
  const int32_t* ins_ok;
  long long ins_ok_st, ins_ok_ss;
  int ins_bits;
  const int32_t* ins_ref;
  long long ins_ref_st, ins_ref_ss;
  const int32_t* seq;           // null: every row's sequence is seq_value
  long long seq_st, seq_ss;
  int32_t seq_value;
  const int32_t* del_ok;
  long long del_ok_st, del_ok_ss;
  int del_bits;
  const int32_t* del_ref;
  long long del_ref_st, del_ref_ss;
  const int32_t* pay_src;
  long long pay_src_st, pay_src_ss;
  int p;
  int n;
  int shards;
  int32_t* head;                  // [S, cap]
  long long cap;
  int32_t* next;                  // [S, row_cap]
  int32_t* ins_seq;
  int32_t* del_seq;
  long long row_cap;
  int32_t* pay;                   // [S, row_cap, p]
  unsigned long long* bucket;     // [S, cap] gen | last pushed leader row
  unsigned long long* barrier;    // gen | blocks arrived
  int2* link;                     // [S, n] (previous leader, old head)
  unsigned long long gen;         // this launch's generation, << 32
  int tiles;                      // 32-row tiles a shard
};

__device__ __forceinline__ bool on(const int32_t* p, long long st,
                                   long long ss, int bits, long long s,
                                   int i) {
  return p != nullptr &&
         (p[s * ss + static_cast<long long>(i) * st] & bits) != 0;
}

__device__ __forceinline__ int32_t at(const int32_t* p, long long st,
                                      long long ss, long long s, int i) {
  return p[s * ss + static_cast<long long>(i) * st];
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// One row of a tile, every input loaded at once (one round trip).
struct Row {
  long long s;          // shard
  int i;                // row within the shard (may be >= n: no row)
  bool ins, del;
  int32_t ref;          // insert ref
  bool in_range;
  int32_t slot;         // -1 when the row does not link
  int32_t sq;           // sequence
  int32_t dref;         // delete ref
};

template <bool kLink>
__device__ __forceinline__ Row load_row(const Apply& a, int tile) {
  Row r;
  r.s = tile / a.tiles;
  r.i = (tile - static_cast<int>(r.s) * a.tiles) * 32 + (threadIdx.x & 31);
  r.ins = r.del = false;
  r.ref = r.dref = r.sq = 0;
  r.slot = -1;
  if (r.i < a.n) {
    r.ins = on(a.ins_ok, a.ins_ok_st, a.ins_ok_ss, a.ins_bits, r.s, r.i);
    r.del = on(a.del_ok, a.del_ok_st, a.del_ok_ss, a.del_bits, r.s, r.i);
    if (a.ins_ref != nullptr) {
      r.ref = at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, r.s, r.i);
    }
    if (a.del_ref != nullptr) {
      r.dref = at(a.del_ref, a.del_ref_st, a.del_ref_ss, r.s, r.i);
    }
    r.sq = a.seq != nullptr ? at(a.seq, a.seq_st, a.seq_ss, r.s, r.i)
                            : a.seq_value;
    if (kLink) r.slot = a.slots[r.s * a.slots_ss + r.i];
  }
  r.in_range = r.ref >= 0 && r.ref < a.row_cap;
  if (!r.ins || r.slot < 0 || r.slot >= a.cap) r.slot = -1;
  return r;
}

// Lanes of the warp whose rows link into the same slot (a lane that does
// not link matches only lanes that do not link either).
__device__ __forceinline__ unsigned peers_of(const Row& r) {
  return __match_any_sync(kFull, static_cast<unsigned>(r.slot));
}

// A row's own writes: its tombstone, its insert sequence (linked rows
// only), and the tile's payload word by word (lane l takes words l, l +
// 32, ... of the tile's rows; kPayRegs words a lane loaded before any
// store). No row of the launch reads them, so with a link they come after
// the barrier, off the path to it.
__device__ void write_tile(const Apply& a, const Row& r) {
  const int lane = threadIdx.x & 31;
  const long long rows = r.s * a.row_cap;
  if (r.del && r.dref >= 0 && r.dref < a.row_cap) {
    a.del_seq[rows + r.dref] = r.sq;
  }
  if (r.slot >= 0 && r.in_range) a.ins_seq[rows + r.ref] = r.sq;
  if (a.pay_src == nullptr) return;
  const bool ok = r.ins && r.in_range;
  if (__ballot_sync(kFull, ok) == 0u) return;
  const int32_t* src = a.pay_src + r.s * a.pay_src_ss;
  const int base = r.i - lane;
  for (int q0 = 0; q0 < a.p; q0 += kPayRegs) {
    int32_t v[kPayRegs];
#pragma unroll
    for (int u = 0; u < kPayRegs; ++u) {
      const int w = (q0 + u) * 32 + lane;
      const int j = w / a.p;
      v[u] = q0 + u < a.p && base + j < a.n
                 ? src[static_cast<long long>(base + j) * a.pay_src_st +
                       (w - j * a.p)]
                 : 0;
    }
#pragma unroll
    for (int u = 0; u < kPayRegs; ++u) {
      if (q0 + u >= a.p) break;
      const int w = (q0 + u) * 32 + lane;
      const int j = w / a.p;
      const bool ok_j = __shfl_sync(kFull, ok, j);
      const int32_t ref_j = __shfl_sync(kFull, r.ref, j);
      if (ok_j) a.pay[(rows + ref_j) * a.p + (w - j * a.p)] = v[u];
    }
  }
}

// Phase A of one tile: the push of each warp group's leader onto its
// slot's list, with (previous leader, old head) kept beside its row.
__device__ void push_tile(const Apply& a, const Row& r) {
  const unsigned peers = peers_of(r);
  if (r.slot >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    const long long b = r.s * a.cap + r.slot;
    const unsigned long long old =
        atomicExch(a.bucket + b, a.gen | static_cast<unsigned>(r.i));
    const int prev =
        (old & ~kLow) == a.gen ? static_cast<int>(old & kLow) : -1;
    a.link[r.s * a.n + r.i] = make_int2(prev, a.head[b]);
  }
}

// Every block arrives once (its phase-A writes fenced first) and waits
// until all have: the barrier word is moved to this launch's generation
// (a word of an older one is smaller) before any block counts on it.
__device__ void grid_barrier(const Apply& a) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicMax(a.barrier, a.gen);
    atomicAdd(a.barrier, 1ull);
    const unsigned long long want = a.gen | gridDim.x;
    while (ld_acquire64(a.barrier) < want) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// The warp's scanned slots (those of more than kWalk groups; lane j < nb
// holds the j-th, `mine`): for each, from the slot column of shard s read
// by the whole warp, coalesced (kScanRegs 32-row chunks a lane in
// flight, then the flags and refs of the rows on any of the slots
// together), the first insert row at or after row `from` (*found, *ref:
// forward) or whether any lies before row `from` (*found: kBack). One
// pass serves every slot and ends when each has its row.
template <bool kBack>
__device__ __forceinline__ void nearest_rows(const Apply& a, long long s,
                                          int nb, int32_t mine, int from,
                                          bool* found, int32_t* ref) {
  const int lane = threadIdx.x & 31;
  const int32_t* col = a.slots + s * a.slots_ss;
  constexpr int kBatch = 32 * kScanRegs;
  for (int c = kBack ? from - kBatch : from;
       kBack ? c + kBatch > 0 : c < a.n; c += kBack ? -kBatch : kBatch) {
    if (__ballot_sync(kFull, lane < nb && !*found) == 0u) return;
    int32_t sl[kScanRegs];
#pragma unroll
    for (int u = 0; u < kScanRegs; ++u) {
      const int i = c + u * 32 + lane;
      sl[u] = i >= 0 && i < a.n && (!kBack || i < from) ? __ldg(col + i)
                                                        : -1;
    }
    unsigned cand = 0u;                 // bit u: row u is on a slot
    for (int j = 0; j < nb; ++j) {
      const int32_t sj = __shfl_sync(kFull, mine, j);
#pragma unroll
      for (int u = 0; u < kScanRegs; ++u) {
        if (sl[u] == sj) cand |= 1u << u;
      }
    }
    if (__ballot_sync(kFull, cand != 0u) == 0u) continue;
    unsigned hit = 0u;
    int32_t rf[kScanRegs];
#pragma unroll
    for (int u = 0; u < kScanRegs; ++u) {
      const int i = c + u * 32 + lane;
      const bool cu = (cand >> u) & 1u;
      if (cu && on(a.ins_ok, a.ins_ok_st, a.ins_ok_ss, a.ins_bits, s, i)) {
        hit |= 1u << u;
      }
      rf[u] = cu && !kBack ? at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, s, i)
                           : 0;
    }
    for (int j = 0; j < nb; ++j) {
      const int32_t sj = __shfl_sync(kFull, mine, j);
      if (__shfl_sync(kFull, *found, j)) continue;
#pragma unroll
      for (int u = 0; u < kScanRegs; ++u) {
        const unsigned m =
            __ballot_sync(kFull, ((hit >> u) & 1u) && sl[u] == sj);
        if (m == 0u) continue;
        const int32_t r = __shfl_sync(kFull, rf[u], __ffs(m) - 1);
        if (lane == j) {
          *found = true;
          if (!kBack) *ref = r;
        }
        break;
      }
    }
  }
}

// Phase B of one tile: the links. A lone group of its slot (the bucket
// word holds its leader, which pushed first) needs nothing more; a slot of
// up to kWalk groups is walked for the next group's leader row and
// whether an earlier group exists; a group of a slot of more groups (a
// hot key spread over the batch) finds its neighbours in the slot column
// instead (nearest_row: the scans end at the next and the previous row
// of the slot, so together they read the batch about once).
__device__ void link_tile(const Apply& a, const Row& r) {
  const int lane = threadIdx.x & 31;
  const long long rows = r.s * a.row_cap;
  const unsigned peers = peers_of(r);
  const int leader = __ffs(peers) - 1;
  const unsigned higher = peers & ~((2u << lane) - 1u);
  const int32_t nxt_ref = __shfl_sync(
      kFull, r.ref, higher != 0u ? __ffs(higher) - 1 : lane);
  int succ = 0x7fffffff;
  int flags = 0;                // 1 an earlier group, 2 a scanned slot
  int32_t old_head = -1;
  if (r.slot >= 0 && lane == leader) {
    const long long b = r.s * a.cap + r.slot;
    const int2* link = a.link + r.s * a.n;
    const int top = static_cast<int>(__ldcg(a.bucket + b) & kLow);
    const int2 own = __ldcg(link + r.i);
    old_head = own.y;
    if (top != r.i || own.x >= 0) {
      int j = top;
      for (int k = 0; j >= 0; j = __ldcg(&link[j].x)) {
        if (++k > kWalk) {
          flags = 2;
          succ = 0x7fffffff;
          break;
        }
        if (j < r.i) {
          flags |= 1;
        } else if (j > r.i && j < succ) {
          succ = j;
        }
      }
    }
  }
  succ = __shfl_sync(kFull, succ, leader);
  flags = __shfl_sync(kFull, flags, leader);
  old_head = __shfl_sync(kFull, old_head, leader);
  int32_t succ_ref = 0;
  if (succ != 0x7fffffff && higher == 0u) {
    succ_ref = at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, r.s, succ);
  }
  // the warp's groups of scanned slots, all in one pass each way: the
  // next row of the slot after the tile, and any row of it before
  const unsigned bigm =
      __ballot_sync(kFull, lane == leader && (flags & 2) != 0);
  if (bigm != 0u) {
    const int nb = __popc(bigm);
    int32_t mine = -1;                  // lane j < nb: the j-th slot
    unsigned mm = bigm;
    for (int j = 0; j < nb; ++j, mm &= mm - 1u) {
      const int32_t sj = __shfl_sync(kFull, r.slot, __ffs(mm) - 1);
      if (lane == j) mine = sj;
    }
    const int base = r.i - lane;
    bool nxt = false, before = false;
    int32_t ref = 0;
    nearest_rows<false>(a, r.s, nb, mine, base + 32, &nxt, &ref);
    nearest_rows<true>(a, r.s, nb, mine, base, &before, nullptr);
    for (int j = 0; j < nb; ++j) {
      const int32_t sj = __shfl_sync(kFull, mine, j);
      const bool fj = __shfl_sync(kFull, nxt, j);
      const int32_t rj = __shfl_sync(kFull, ref, j);
      const bool bj = __shfl_sync(kFull, before, j);
      if (r.slot == sj) {
        if (fj) {
          succ = 0;
          succ_ref = rj;
        }
        flags = bj ? 3 : 2;
      }
    }
  }
  if (r.slot < 0) return;
  if (r.in_range) {
    int32_t v;
    if (higher != 0u) {
      v = nxt_ref;                              // next lane of the group
    } else if (succ != 0x7fffffff) {
      v = succ_ref;                             // the next group's first
    } else {
      v = old_head;                             // the slot's last row
    }
    a.next[rows + r.ref] = v;
  }
  if (lane == leader && (flags & 1) == 0) {
    a.head[r.s * a.cap + r.slot] = r.ref;       // the slot's first row
  }
}

template <bool kLink>
__global__ void __launch_bounds__(kThreads, 2) apply_kernel(const Apply a) {
  const int total = a.shards * a.tiles;
  const int per_round = gridDim.x * kWarps;
  const int rounds = (total + per_round - 1) / per_round;
  const int warp = threadIdx.x >> 5;
  if constexpr (!kLink) {
    for (int k = 0; k < rounds; ++k) {
      const int t = (k * gridDim.x + blockIdx.x) * kWarps + warp;
      if (t < total) write_tile(a, load_row<false>(a, t));
    }
  } else {
    // one round (the common case) keeps its rows in registers across the
    // barrier; more rounds load them again in phase B
    const int t0 = blockIdx.x * kWarps + warp;
    const Row r0 = load_row<true>(a, t0 < total ? t0 : 0);
    if (t0 < total) push_tile(a, r0);
    for (int k = 1; k < rounds; ++k) {
      const int t = (k * gridDim.x + blockIdx.x) * kWarps + warp;
      if (t < total) push_tile(a, load_row<true>(a, t));
    }
    grid_barrier(a);
    for (int k = 0; k < rounds; ++k) {
      const int t = (k * gridDim.x + blockIdx.x) * kWarps + warp;
      if (t < total) {
        const Row r = k == 0 ? r0 : load_row<true>(a, t);
        write_tile(a, r);
        link_tile(a, r);
      }
    }
  }
}

// Blocks of apply_kernel<true> that can be resident at once on the
// current device (cached a device).
int resident_blocks(int* out) {
  static int cached[rw::kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  const int rc = rw::sm_count(&dev, &sms);
  if (rc != 0) return rc;
  if (dev < rw::kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, apply_kernel<true>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = per_sm * sms;
  if (dev < rw::kMaxDevices) cached[dev] = *out;
  return 0;
}

}  // namespace

// Null pointers switch parts off: slots (no link), del_ok (no tombstone),
// pay_src (no payload), seq (every row's sequence is seq_value). Every
// row input has a row stride (_st) and a shard stride (_ss); slots' row
// stride is 1. head is int32[S, cap], next/ins_seq/del_seq int32[S,
// row_cap], pay int32[S, row_cap, p]. With slots: bucket is S * cap + 1
// uint64 words (a slot's, then the grid barrier's) that no launch
// resets: a word holds (generation << 32 | value), and `gen` (1 .. 2^32 -
// 1) must exceed every generation already written there; rows is
// int32[2 * S * n] scratch.
RW_API int rw_join_apply(
    const void* slots, long long slots_ss, const void* ins_ok,
    long long ins_ok_st, long long ins_ok_ss, int ins_bits,
    const void* ins_ref, long long ins_ref_st, long long ins_ref_ss,
    const void* seq, long long seq_st, long long seq_ss, int seq_value,
    const void* del_ok,
    long long del_ok_st, long long del_ok_ss, int del_bits,
    const void* del_ref, long long del_ref_st, long long del_ref_ss,
    const void* pay_src, long long pay_src_st, long long pay_src_ss, int p,
    int n, int shards, void* head, long long cap, void* next, void* ins_seq,
    void* del_seq, long long row_cap, void* pay, void* bucket,
    unsigned int gen, void* rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || shards <= 0) return static_cast<int>(cudaGetLastError());
  Apply a;
  a.slots = static_cast<const int32_t*>(slots);
  a.slots_ss = slots_ss;
  a.ins_ok = static_cast<const int32_t*>(ins_ok);
  a.ins_ok_st = ins_ok_st;
  a.ins_ok_ss = ins_ok_ss;
  a.ins_bits = ins_bits;
  a.ins_ref = static_cast<const int32_t*>(ins_ref);
  a.ins_ref_st = ins_ref_st;
  a.ins_ref_ss = ins_ref_ss;
  a.seq = static_cast<const int32_t*>(seq);
  a.seq_st = seq_st;
  a.seq_ss = seq_ss;
  a.seq_value = seq_value;
  a.del_ok = static_cast<const int32_t*>(del_ok);
  a.del_ok_st = del_ok_st;
  a.del_ok_ss = del_ok_ss;
  a.del_bits = del_bits;
  a.del_ref = static_cast<const int32_t*>(del_ref);
  a.del_ref_st = del_ref_st;
  a.del_ref_ss = del_ref_ss;
  a.pay_src = p > 0 ? static_cast<const int32_t*>(pay_src) : nullptr;
  a.pay_src_st = pay_src_st;
  a.pay_src_ss = pay_src_ss;
  a.p = p;
  a.n = n;
  a.shards = shards;
  a.head = static_cast<int32_t*>(head);
  a.cap = cap;
  a.next = static_cast<int32_t*>(next);
  a.ins_seq = static_cast<int32_t*>(ins_seq);
  a.del_seq = static_cast<int32_t*>(del_seq);
  a.row_cap = row_cap;
  a.pay = static_cast<int32_t*>(pay);
  a.bucket = static_cast<unsigned long long*>(bucket);
  a.barrier = a.bucket == nullptr ? nullptr
                                  : a.bucket + static_cast<long long>(
                                                   shards) * cap;
  a.link = static_cast<int2*>(rows);
  a.gen = static_cast<unsigned long long>(gen) << 32;
  a.tiles = rw::blocks_for(n, 32);
  const long long total = static_cast<long long>(shards) * a.tiles;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int want = rw::blocks_for(total, kWarps);
  if (a.slots == nullptr) {
    apply_kernel<false><<<want, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.bucket == nullptr || a.link == nullptr || gen == 0u ||
      reinterpret_cast<uintptr_t>(bucket) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc != 0) return rc;
  const int grid = want < resident ? want : resident;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(apply_kernel<true>), dim3(grid),
      dim3(kThreads), args, 0, st));
}
