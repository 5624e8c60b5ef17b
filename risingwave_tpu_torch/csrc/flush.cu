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
// The header carries the TRUE n_dirty even when it exceeds flush_cap (rows
// past flush_cap are dropped): the host retries with a larger buffer. Rows
// n_dirty..flush_cap-1 hold slot 0's row, as the reference's gather of a
// zero-initialized index leaves them (the host never reads them).
//
// advance: for every dirty slot emitted := current (emitted_valid =
// group_rows > 0), then dirty = 0. It is driven by the flush's own list:
// the host keeps the gather's device matrix with the state until the
// advance (nothing between them dirties a slot: a patch writes
// accumulator rows only), and the kernel reads each shard's n_dirty on
// the device and advances the listed slots, a few blocks a shard sized by
// flush_cap, not by cap; the host skips the launch when the flush found
// nothing dirty. When nothing wrote the state since the gather either (no
// patch: the host knows), each matrix row already holds the group_rows and
// accumulators to copy, so a slot costs one round trip. A truncated
// matrix, or no matrix (tests, recovery), makes it sweep every slot's
// dirty word as before.
//
// The patched mode carries the retractable MIN/MAX write-back of
// hash_agg.py:783 build_patch (B10) in the same launch: the host uploads
// the corrected accumulators once as columns [S, nacc, pad], column i for
// list row i, and each listed slot takes its column as both its
// accumulators and their emitted copy. The patch's slots are the list's
// own, so no index array travels, and K9's launch before the advance is
// gone. What bounds advance in every mode is one launch floor (~2.5 us):
// its bytes are ~2,200 rows at most on the paths (under 0.03 us), so the
// design's lever is launches, and each mode keeps a listed slot to one
// round trip (its row, or its row and column, load together). The
// unpatched modes are the kernel's template instance without a patch, so
// their code is as before.
//
// Shard axis (risingwave_tpu/parallel/agg.py:219 _shardwise, B23): state
// is keys int32[S, cap, k], occ int32[S, cap] and st int32[S, R, cap]; the
// gather writes out[S, 1 + flush_cap, W'], one header per shard. One
// launch of each serves every shard; the single-device path launches
// S = 1.
//
// What bounds flush_gather on the card: bytes and latency. It reads dirty
// and occ once (8 bytes a slot) plus the dirty slots' columns, and writes
// the matrix once: at q7's 2^18 slots and flush_cap 1024, ~2.1 MB, ~0.64 us
// at 3.35 TB/s, under one launch (~2.3 us). So the design spends one
// launch, fills the card with tiles, keeps the round trips to memory on a
// tile's path to two, and stores the matrix coalesced:
//   - one launch, a single-pass scan with decoupled look-back over tiles of
//     2,048 slots. A block counts its tile's dirty and occupied slots (warp
//     shuffles, one shared pass over the 16 warp sums) and publishes them
//     at once; then its threads read the counts of all the tiles before it
//     in parallel, a thread a tile, so the look-back costs one round trip
//     to L2 and no chain of prefixes: one 64-bit word a tile holds the flag
//     and both counts, so a word is read whole and needs no fence. Each
//     shard's tiles look back on their own; the shard's last 8 tiles also
//     read the tiles after them, so each knows the shard's totals: the
//     last writes the header, and the 8 share the padding rows.
//   - the launch is cooperative, so every block is resident and a tile can
//     wait on any other tile's word; blocks take tiles by index (b, b +
//     grid, ...), so no ticket costs a round trip. Slot 0's row (the
//     padding) is loaded beside the tile's flags, and the tile's first
//     dirty rows beside the look-back.
//   - the status words are not reset by the launch: they come from the
//     stats chain (risingwave_tpu_torch/ops/cuda.py stats_chain, the
//     "flush" chain), zeroed by the flush launch before this one on the
//     stream, and this launch's first block zeroes the block the next one
//     will use. A launch that fails to start hands on nothing, and the
//     next launch gets a freshly zeroed block; a launch that faults on the
//     card leaves the context unusable, so no later launch can read its
//     words.
//   - a tile's dirty rows are gathered column by column into shared memory
//     (neighbouring threads read neighbouring dirty slots of one state
//     row) and leave as one contiguous range of 16-byte stores; the
//     padding rows are one contiguous 16-byte fill of slot 0's row.
// No device-wide library primitive is used; the scans are hand-written.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;                       // slots a thread: one int4
constexpr int kTile = kThreads * kPer;        // 2,048 slots a tile
constexpr int kWarps = kThreads / 32;
constexpr int kPre = 4;                       // gathered values a thread
                                              // loads before the look-back
constexpr int kStageBytes = 32 << 10;         // staging of gathered rows
constexpr int kPadTiles = 8;                  // a shard's last tiles, which
                                              // share the padding rows

// status word of one tile: flag in bits 62-63 (0 not yet, 1 the tile's
// own counts published), dirty count in bits 31-61, occupied count in
// bits 0-30
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kCountMask = (1ull << 31) - 1ull;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   int d, int o) {
  return flag | (static_cast<unsigned long long>(d) << 31) |
         static_cast<unsigned long long>(o);
}

__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// column c of slot s's flush row (the reference's gather_packed layout)
__device__ __forceinline__ int32_t flush_col(
    int c, long long s, const int32_t* __restrict__ st,
    const int32_t* __restrict__ keys, long long cap, int k, int nacc) {
  if (c == 0) return static_cast<int32_t>(s);
  if (c <= k) return keys[s * k + (c - 1)];
  c -= k + 1;
  int row;
  if (c == 0) {
    row = rw::kRowGroupRows;
  } else if (c <= nacc) {
    row = rw::kRowAcc0 + c - 1;
  } else if (c == nacc + 1) {
    row = rw::kRowEmittedValid;
  } else if (c == nacc + 2) {
    row = rw::kRowEmittedRows;
  } else {
    row = rw::kRowAcc0 + c - 3;             // emitted accs follow the accs
  }
  return st[row * cap + s];
}

// the dynamic shared memory of gather_kernel in ints: the staging tile
// (and up to 3 ints of alignment), slot 0's row, the padding pattern
__host__ __device__ inline int stage_ints(int stage_rows, int wout) {
  return (stage_rows * wout + 4 + 3) & ~3;
}

__host__ __device__ inline int smem_ints(int stage_rows, int wout) {
  return stage_ints(stage_rows, wout) + ((wout + 3) & ~3) + 4 * wout;
}

struct Gather {
  const int32_t* st;
  const int32_t* keys;
  const int32_t* occ;
  long long cap, stshard;
  int k, nacc, tiles, nshards;
  unsigned long long* stat;     // S x tiles status words
  int32_t* next;
  int n_next;
  int flush_cap;
  int32_t* out;
  int wout, stage_rows;
};

__global__ void __launch_bounds__(kThreads) gather_kernel(const Gather g) {
  extern __shared__ int4 dyn[];
  int32_t* stage = reinterpret_cast<int32_t*>(dyn);
  int32_t* row0 = stage + stage_ints(g.stage_rows, g.wout);
  int32_t* pat = row0 + ((g.wout + 3) & ~3);
  __shared__ int s_slots[kTile];              // the tile's dirty slots
  __shared__ int s_wd[kWarps];                // warp dirty counts, then
  __shared__ int s_wo[kWarps];                // exclusive offsets
  __shared__ int s_tile_d, s_tile_o;
  __shared__ int s_sum[3];     // dirty before the tile; dirty, occupied
                               // in the tiles read
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wout = g.wout;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < g.n_next; i += blockDim.x) g.next[i] = 0;
  }
  const int pad_from = g.tiles > kPadTiles ? g.tiles - kPadTiles : 0;
  for (int t = blockIdx.x; t < g.nshards * g.tiles; t += gridDim.x) {
    const int shard = t / g.tiles;
    const int tile = t - shard * g.tiles;
    const int32_t* st = g.st + shard * g.stshard;
    const int32_t* keys = g.keys + shard * g.cap * g.k;
    const int32_t* occ = g.occ + shard * g.cap;
    int32_t* out = g.out + shard * (1LL + g.flush_cap) * wout;
    unsigned long long* stat = g.stat + static_cast<long long>(shard) *
                                            g.tiles;
    const long long cap = g.cap;
    if (threadIdx.x < 3) s_sum[threadIdx.x] = 0;
    // slot 0's row for the padding, loaded beside the tile's flags
    const bool pad_tile = tile >= pad_from;
    int32_t r0 = 0;
    if (pad_tile && threadIdx.x < wout) {
      r0 = flush_col(threadIdx.x, 0, st, keys, cap, g.k, g.nacc);
    }
    // the thread's 4 slots: dirty and occupied flags
    const long long j0 = static_cast<long long>(tile) * kTile +
                         static_cast<long long>(threadIdx.x) * kPer;
    const int32_t* dirty = st + rw::kRowDirty * cap;
    unsigned mask = 0;
    int n_occ = 0;
    const bool vec = ((reinterpret_cast<uintptr_t>(dirty) |
                       reinterpret_cast<uintptr_t>(occ)) & 15) == 0;
    if (vec && j0 + kPer <= cap) {
      const int4 d = *reinterpret_cast<const int4*>(dirty + j0);
      const int4 o = *reinterpret_cast<const int4*>(occ + j0);
      mask = (d.x != 0) | ((d.y != 0) << 1) | ((d.z != 0) << 2) |
             ((d.w != 0) << 3);
      n_occ = (o.x != 0) + (o.y != 0) + (o.z != 0) + (o.w != 0);
    } else {
      for (int i = 0; i < kPer; ++i) {
        if (j0 + i < cap) {
          mask |= static_cast<unsigned>(dirty[j0 + i] != 0) << i;
          n_occ += occ[j0 + i] != 0;
        }
      }
    }
    const int n_d = __popc(mask);
    int incl = n_d;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const int w_occ = __reduce_add_sync(0xffffffffu, n_occ);
    if (lane == 31) {
      s_wd[warp] = incl;
      s_wo[warp] = w_occ;
    }
    if (pad_tile && threadIdx.x < wout) row0[threadIdx.x] = r0;
    __syncthreads();
    if (warp == 0) {
      // the tile's counts, one pass over the warp sums, published at once
      const int v = lane < kWarps ? s_wd[lane] : 0;
      int sc = v;
      for (int o = 1; o < kWarps; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, sc, o);
        if (lane >= o) sc += u;
      }
      const int tile_o =
          __reduce_add_sync(0xffffffffu, lane < kWarps ? s_wo[lane] : 0);
      const int tile_d = __shfl_sync(0xffffffffu, sc, kWarps - 1);
      if (lane < kWarps) s_wd[lane] = sc - v;
      if (lane == 0) {
        s_tile_d = tile_d;
        s_tile_o = tile_o;
        st_relaxed64(stat + tile, pack(kFlagAgg, tile_d, tile_o));
      }
    }
    __syncthreads();
    {
      // the tile's dirty slots in slot order
      int li = s_wd[warp] + incl - n_d;
      for (int i = 0; i < kPer; ++i) {
        if (mask & (1u << i)) s_slots[li++] = static_cast<int>(j0 + i);
      }
    }
    __syncthreads();
    // The first chunk of the tile's dirty rows is loaded into registers
    // (kPre values a thread, column by column: neighbouring threads read
    // neighbouring dirty slots of one state row) while the look-back runs.
    const int tile_d = s_tile_d;
    const int nr0 = min(tile_d, g.stage_rows);
    int32_t pre[kPre];
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
      const int e = threadIdx.x + q * kThreads;
      pre[q] = 0;
      if (e < nr0 * wout) {
        const int c = e / nr0;
        pre[q] = flush_col(c, s_slots[e - c * nr0], st, keys, cap, g.k,
                           g.nacc);
      }
    }
    // Look-back: the block reads the published counts of the tiles before
    // it, kThreads at a time (a thread a tile, spinning until that tile
    // has published), so the walk is one round trip however many tiles
    // came first. The shard's last kPadTiles tiles also read the tiles
    // after them, for the shard's totals. Every block of the launch is
    // resident (a cooperative launch), a tile publishes before it waits
    // on anything, and a block's later tiles are never among the tiles an
    // earlier one of its tiles waits for, so no wait closes a cycle.
    const int need = pad_tile ? g.tiles : tile;
    for (int base = 0; base < need; base += kThreads) {
      const int i = base + threadIdx.x;
      int d = 0, o = 0;
      if (i < need && i != tile) {
        unsigned long long w;
        while (((w = ld_relaxed64(stat + i)) >> 62) == 0ull) {
        }
        d = static_cast<int>((w >> 31) & kCountMask);
        o = static_cast<int>(w & kCountMask);
      }
      const int sb = __reduce_add_sync(0xffffffffu, i < tile ? d : 0);
      const int sd = __reduce_add_sync(0xffffffffu, d);
      const int so = __reduce_add_sync(0xffffffffu, o);
      if (lane == 0 && (sd | so) != 0) {
        atomicAdd(&s_sum[0], sb);
        atomicAdd(&s_sum[1], sd);
        atomicAdd(&s_sum[2], so);
      }
    }
    __syncthreads();
    const int excl = s_sum[0];
    const int lim = min(tile_d, g.flush_cap - excl);
    for (int c0 = 0; c0 < lim; c0 += g.stage_rows) {
      const int nr = min(g.stage_rows, lim - c0);
      int32_t* dst = out + (1LL + excl + c0) * wout;
      int32_t* tilebuf = stage +
          static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
      if (c0 == 0) {
        // the chunk the registers hold, then any rest of it
#pragma unroll
        for (int q = 0; q < kPre; ++q) {
          const int e = threadIdx.x + q * kThreads;
          const int c = e / nr0;
          const int r = e - c * nr0;
          if (e < nr0 * wout && r < nr) tilebuf[r * wout + c] = pre[q];
        }
        for (int e = kPre * kThreads + threadIdx.x; e < nr0 * wout;
             e += kThreads) {
          const int c = e / nr0;
          const int r = e - c * nr0;
          if (r < nr) {
            tilebuf[r * wout + c] =
                flush_col(c, s_slots[r], st, keys, cap, g.k, g.nacc);
          }
        }
      } else {
        for (int e = threadIdx.x; e < nr * wout; e += kThreads) {
          const int c = e / nr;
          const int r = e - c * nr;
          tilebuf[r * wout + c] =
              flush_col(c, s_slots[c0 + r], st, keys, cap, g.k, g.nacc);
        }
      }
      __syncthreads();
      rw::store_ints(dst, tilebuf, static_cast<long long>(nr) * wout);
      __syncthreads();
    }
    // the shard's last tiles: the header (the last one) and an even share
    // each of the padding rows, slot 0's row as one 16-byte fill
    const int n_dirty = s_sum[1] + tile_d;
    if (pad_tile && tile == g.tiles - 1) {
      for (int c = threadIdx.x; c < wout; c += kThreads) {
        out[c] = c == 0 ? n_dirty : (c == 1 ? s_sum[2] + s_tile_o : 0);
      }
    }
    const int n_pad_tiles = g.tiles - pad_from;
    const int per = max(0, g.flush_cap - n_dirty + n_pad_tiles - 1) /
                    n_pad_tiles;
    const int r_lo = n_dirty + (tile - pad_from) * per;
    const int r_hi = min(g.flush_cap, r_lo + per);
    if (pad_tile && r_lo < r_hi) {
      int32_t* dst = out + (1LL + r_lo) * wout;
      const int n = (r_hi - r_lo) * wout;
      const int head = min(n, static_cast<int>(
          ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
      // the int4 stores from `head` on repeat every lcm(wout, 4) ints
      const int period = (wout & 3) == 0 ? wout
                         : ((wout & 1) == 0 ? 2 * wout : 4 * wout);
      for (int i = threadIdx.x; i < period; i += kThreads) {
        pat[i] = row0[(head + i) % wout];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = row0[i];
      const int n4 = (n - head) >> 2;
      const int p4 = period >> 2;
      int4* d4 = reinterpret_cast<int4*>(dst + head);
      const int4* s4 = reinterpret_cast<const int4*>(pat);
      for (int q = threadIdx.x; q < n4; q += kThreads) d4[q] = s4[q % p4];
      for (int i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads) {
        dst[i] = row0[i % wout];
      }
    }
    __syncthreads();
  }
}

// emitted := current for slot j of one shard's state; dirty := 0
__device__ __forceinline__ void advance_slot(int32_t* st, long long cap,
                                             long long j, int nacc) {
  const int32_t gr = st[rw::kRowGroupRows * cap + j];
  st[rw::kRowEmittedValid * cap + j] = gr > 0;
  st[rw::kRowEmittedRows * cap + j] = gr;
  for (int a = 0; a < nacc; ++a) {
    st[(rw::kRowAcc0 + nacc + a) * cap + j] = st[(rw::kRowAcc0 + a) * cap + j];
  }
  st[rw::kRowDirty * cap + j] = 0;
}

constexpr int kAdvThreads = 256;

// One listed dirty row of the flush matrix: its slot, and, when the
// matrix is `current` (nothing wrote the state since the gather), the
// group_rows and accumulators the advance copies, all from the row.
__device__ __forceinline__ void advance_row(int32_t* st, long long cap,
                                            int nacc, const int32_t* row,
                                            int32_t slot, bool current,
                                            int k) {
  if (!current) {
    advance_slot(st, cap, slot, nacc);
    return;
  }
  const int32_t gr = __ldg(row + 1 + k);
  for (int a = 0; a < nacc; ++a) {
    st[(rw::kRowAcc0 + nacc + a) * cap + slot] = __ldg(row + 2 + k + a);
  }
  st[rw::kRowEmittedValid * cap + slot] = gr > 0;
  st[rw::kRowEmittedRows * cap + slot] = gr;
  st[rw::kRowDirty * cap + slot] = 0;
}

// One listed dirty row carrying its patch column (`col`, stride pad):
// the accumulators and their emitted copies from the column, the
// emitted row count and flag from the row's group_rows (the patch writes
// accumulator rows only, so the row's group_rows is still the state's).
__device__ __forceinline__ void patch_row(int32_t* st, long long cap,
                                          int nacc, int32_t slot,
                                          int32_t gr,
                                          const int32_t* __restrict__ col,
                                          int pad) {
  for (int a = 0; a < nacc; ++a) {
    const int32_t v = __ldg(col + static_cast<long long>(a) * pad);
    st[(rw::kRowAcc0 + a) * cap + slot] = v;
    st[(rw::kRowAcc0 + nacc + a) * cap + slot] = v;
  }
  st[rw::kRowEmittedValid * cap + slot] = gr > 0;
  st[rw::kRowEmittedRows * cap + slot] = gr;
  st[rw::kRowDirty * cap + slot] = 0;
}

// With a flush matrix (`list`, the gather's [S, 1 + flush_cap, wout]
// output for this state): shard blockIdx.y reads its header's n_dirty and
// advances the slots of column 0 of rows 1..n_dirty (the header and a
// thread's first row load together; with `current`, the row also holds
// the values to copy, so a slot costs one round trip); a truncated matrix
// (n_dirty > flush_cap) sweeps every slot's dirty word instead, decided
// here with no host read. Without one: the sweep. Blocks stride over the
// list (or the slots) by gridDim.x.
//
// kPatched: the list carries a patch, patch[S, nacc, pad] (column i is
// list row i's accumulators, the retractable MIN/MAX write-back of
// hash_agg.py:783 build_patch): row i's slot, group_rows and column load
// together, and the slot is patched and advanced in one pass. A list that
// is truncated or longer than the patch writes nothing (the host never
// passes one: its flush retries until the list fits).
template <bool kPatched>
__global__ void __launch_bounds__(kAdvThreads) advance_kernel(
    int32_t* st, long long cap, long long stshard, int nacc,
    const int32_t* __restrict__ list, int flush_cap, int wout,
    bool current, const int32_t* __restrict__ patch, int pad) {
  st += blockIdx.y * stshard;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long j0 = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
  if constexpr (kPatched) {
    list += blockIdx.y * (1LL + flush_cap) * wout;
    patch += blockIdx.y * static_cast<long long>(nacc) * pad;
    const int k = wout - 4 - 2 * nacc;
    const int lim = min(flush_cap, pad);
    const int32_t* row = list + (1 + j0) * wout;
    int32_t slot = 0, gr = 0;
    if (j0 < lim) {
      slot = __ldg(row);
      gr = __ldg(row + 1 + k);
    }
    const int n = __ldg(list);
    if (n > lim) return;
    for (long long r = j0; r < n; r += stride) {
      if (r != j0) {
        row = list + (1 + r) * wout;
        slot = __ldg(row);
        gr = __ldg(row + 1 + k);
      }
      patch_row(st, cap, nacc, slot, gr, patch + r, pad);
    }
    return;
  }
  if (list != nullptr) {
    // every row of the matrix exists; rows past n_dirty are not used
    list += blockIdx.y * (1LL + flush_cap) * wout;
    const int k = wout - 4 - 2 * nacc;
    const int32_t* row = list + (1 + j0) * wout;
    const int32_t slot0 = j0 < flush_cap ? __ldg(row) : 0;
    const int n = __ldg(list);
    if (n <= flush_cap) {
      if (j0 < n) advance_row(st, cap, nacc, row, slot0, current, k);
      for (long long r = j0 + stride; r < n; r += stride) {
        row = list + (1 + r) * wout;
        advance_row(st, cap, nacc, row, __ldg(row), current, k);
      }
      return;
    }
  }
  for (long long j = j0; j < cap; j += stride) {
    if (st[rw::kRowDirty * cap + j] != 0) advance_slot(st, cap, j, nacc);
  }
}


// Blocks of gather_kernel that can be resident at once on the current
// device with `smem` bytes of dynamic shared memory (cached a device, for
// the last size asked there).
int resident_blocks(size_t smem, int* out) {
  static size_t cached_smem[rw::kMaxDevices];
  static int cached[rw::kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  const int rc = rw::sm_count(&dev, &sms);
  if (rc != 0) return rc;
  const bool keep = dev < rw::kMaxDevices;
  if (keep && cached[dev] > 0 && cached_smem[dev] == smem) {
    *out = cached[dev];
    return 0;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *out = per_sm * sms;
  if (keep) {
    cached[dev] = *out;
    cached_smem[dev] = smem;
  }
  return 0;
}

}  // namespace

// status: 2 * S * ceil(cap / 2048) int32 words from the stats chain,
// zeroed, 16-byte aligned (ops/hash_agg.py flush_status_words); next: the
// n_next words this launch zeroes for the next flush on the stream; out:
// [S, 1 + flush_cap, wout]. A cooperative launch of at most as many
// blocks as can be resident; block b takes tiles b, b + gridDim.x, ...
RW_API int rw_flush_gather(const void* st, const void* keys, const void* occ,
                           long long cap, int k, int nacc, int nshards,
                           void* status, void* next, int n_next,
                           int flush_cap, void* out, int wout,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nshards <= 0) return static_cast<int>(cudaGetLastError());
  if (cap <= 0 || flush_cap < 0 || wout <= 0 || wout > kThreads ||
      reinterpret_cast<uintptr_t>(status) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Gather g;
  g.st = static_cast<const int32_t*>(st);
  g.keys = static_cast<const int32_t*>(keys);
  g.occ = static_cast<const int32_t*>(occ);
  g.cap = cap;
  g.stshard = (rw::kRowAcc0 + 2LL * nacc) * cap;
  g.k = k;
  g.nacc = nacc;
  g.tiles = rw::blocks_for(cap, kTile);
  g.nshards = nshards;
  g.stat = static_cast<unsigned long long*>(status);
  g.next = static_cast<int32_t*>(next);
  g.n_next = n_next;
  g.flush_cap = flush_cap;
  g.out = static_cast<int32_t*>(out);
  g.wout = wout;
  const int fit = (kStageBytes / 4 - 4) / wout;
  g.stage_rows = fit > 0 ? fit : 1;
  const size_t smem = static_cast<size_t>(smem_ints(g.stage_rows, wout)) * 4;
  int resident = 0;
  const int rc = resident_blocks(smem, &resident);
  if (rc != 0) return rc;
  const long long total = static_cast<long long>(nshards) * g.tiles;
  const int grid = static_cast<int>(total < resident ? total : resident);
  if (grid < kPadTiles && grid < total)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&g};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(gather_kernel), dim3(grid), dim3(kThreads),
      args, smem, s));
}

// list: the flush matrix [S, 1 + flush_cap, wout] that the gather wrote
// for this state with nothing stepped since (its dirty slots are the
// header's n_dirty rows), or null for a sweep of every slot; current: 1
// when nothing wrote the state since the gather either (no patch), so the
// matrix holds the values to copy; patch: null, or the columns
// int32[S, nacc, pad] the listed slots take as their accumulators (list
// row i, column i), which needs a list. With a list the grid covers
// flush_cap rows a shard (with a patch, min(flush_cap, pad)); a truncated
// list sweeps with it, unless it carries a patch.
RW_API int rw_advance(void* st, long long cap, int nacc, int nshards,
                      const void* list, int flush_cap, int wout,
                      int current, const void* patch, int pad,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (patch != nullptr && (list == nullptr || pad <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nshards > 0) {
    const long long stshard = (rw::kRowAcc0 + 2LL * nacc) * cap;
    int32_t* st32 = static_cast<int32_t*>(st);
    const int32_t* list32 = static_cast<const int32_t*>(list);
    const int32_t* patch32 = static_cast<const int32_t*>(patch);
    if (patch != nullptr) {
      const int rows = flush_cap < pad ? flush_cap : pad;
      const dim3 grid(rw::blocks_for(rows > 0 ? rows : 1, kAdvThreads),
                      nshards);
      advance_kernel<true><<<grid, kAdvThreads, 0, s>>>(
          st32, cap, stshard, nacc, list32, flush_cap, wout, false,
          patch32, pad);
    } else {
      const long long work = list != nullptr ? flush_cap : cap;
      const dim3 grid(rw::blocks_for(work > 0 ? work : 1, kAdvThreads),
                      nshards);
      advance_kernel<false><<<grid, kAdvThreads, 0, s>>>(
          st32, cap, stshard, nacc, list32, flush_cap, wout,
          current != 0, nullptr, 0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
