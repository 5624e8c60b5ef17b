// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Every source in this directory is compiled by nvcc into its own shared
// library and bound from Python with ctypes (risingwave_tpu_torch/ops/
// cuda.py). Each exported entry point launches on the stream it is given
// and returns cudaGetLastError() as an int, so a refused launch surfaces
// in the Python wrapper instead of being lost.
//
// Device state layout shared with risingwave_tpu_torch/ops/hash_agg.py:
// every slot-indexed array of one grouped-agg operator is a row of one
// int32 matrix st[R, cap] (float accumulators travel bitcast):
//   row 0  group_rows      row 1  dirty (0/1)
//   row 2  emitted_valid   row 3  emitted_rows
//   rows 4 .. 4+n_acc-1            accumulators
//   rows 4+n_acc .. 4+2*n_acc-1    emitted accumulators
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RW_API extern "C" __attribute__((visibility("default")))

namespace rw {

constexpr int kRowGroupRows = 0;
constexpr int kRowDirty = 1;
constexpr int kRowEmittedValid = 2;
constexpr int kRowEmittedRows = 3;
constexpr int kRowAcc0 = 4;

// murmur3 fmix32 (risingwave_tpu/common/hash.py:28 _mix32)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Row hash of k int32 key lanes: the seeded boost-style combine of
// risingwave_tpu/common/hash.py:58 hash_columns over uint32 lanes.
__device__ __forceinline__ uint32_t hash_lanes(const int32_t* row, int k) {
  uint32_t h = 0x9E3779B9u;
  for (int i = 0; i < k; ++i) {
    const uint32_t lane = static_cast<uint32_t>(row[i]);
    h = mix32(h ^ (lane + 0x9E3779B9u + (h << 6) + (h >> 2)));
  }
  return h;
}

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

constexpr int kMaxDevices = 64;   // devices whose figures are cached

// The current device (*dev) and its streaming multiprocessors (*sms),
// cached a device: 0 or a CUDA error code.
inline int sm_count(int* dev, int* sms) {
  static int cached[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < kMaxDevices && cached[*dev] > 0) {
    *sms = cached[*dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*dev < kMaxDevices) cached[*dev] = *sms;
  return 0;
}

// The block stores n ints of shared `src` to global `dst` with 16-byte
// stores (ints only at the range's unaligned ends). `src` and `dst` must
// be equal modulo 16 bytes: a staging tile is placed at the output's
// offset within 16 bytes (flush_gather, the fused kernel).
__device__ __forceinline__ void store_ints(int32_t* dst, const int32_t* src,
                                           long long n) {
  const long long head = min(n, static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
  const long long n4 = (n - head) >> 2;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  for (long long i = head + 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
    dst[i] = src[i];
  }
}

// -- the open-addressing table (risingwave_tpu_torch/ops/hash_table.py) ------
//
// keys int32[cap, K] + occ int32[cap]: 0 empty, 1 occupied; inside K1 a
// claimed slot is -1 (busy) while its winner writes the lanes. Probing is
// linear with stride 1 from hash & (cap - 1); the table has no
// tombstones, so an empty slot ends every probe chain. K1 (find-or-
// insert), K8 (lookup) and K6's lookup all probe through the helpers
// below.
constexpr int32_t kEmpty = 0;
constexpr int32_t kReady = 1;
constexpr int32_t kBusy = -1;

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int4 ld_acquire4(const int32_t* p) {
  int4 v;
  asm volatile("ld.acquire.gpu.global.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Table lanes through L2 (kL2: the slot may have been written in this
// launch, so L1 is skipped) or through the read-only path (the table is
// not written while the kernel runs).
template <bool kL2, typename T>
__device__ __forceinline__ T ld_lanes(const T* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// Slots probed a step: a group of kGroup consecutive slots, aligned to
// kGroup, whose occ words are one 16-byte load and whose lanes are K
// 16-byte loads. The sharded tables make this pay: a shard owns the keys
// whose vnode (the row hash's low 8 bits) it holds, and the home slot is
// the same hash's low bits, so a shard's keys have their homes on 1/8 of
// its slots and its probe chains run ~50 slots to a stored key and ~110
// to an empty slot at half load (~1.5 and ~4 on one device).
constexpr int kGroup = 4;

// A row's K key lanes, held in registers (K known at compile time); the
// probes step a group of slots at a time (the table and occ 16-byte
// aligned, cap a multiple of kGroup). One slot's lanes are read and
// written with the widest vector their alignment allows: a slot is K * 4
// bytes, so int4 for K % 4 == 0, int2 for even K (6 lanes: 3 x 8 bytes).
template <int K>
struct Lanes {
  static constexpr bool kGrouped = true;
  static constexpr int kLanes = K;
  int32_t v[K];

  __device__ __forceinline__ explicit Lanes(int) : v{} {}
  __device__ __forceinline__ int k() const { return K; }

  __device__ __forceinline__ void load(const int32_t* row) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = row[i];
  }

  // hash_lanes over the held lanes
  __device__ __forceinline__ uint32_t hash() const {
    uint32_t h = 0x9E3779B9u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t lane = static_cast<uint32_t>(v[i]);
      h = mix32(h ^ (lane + 0x9E3779B9u + (h << 6) + (h >> 2)));
    }
    return h;
  }

  template <bool kL2>
  __device__ __forceinline__ bool equals(const int32_t* cur) const {
    bool eq = true;
    if constexpr (K % 4 == 0) {
      const int4* p = reinterpret_cast<const int4*>(cur);
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        const int4 t = ld_lanes<kL2>(p + j);
        eq &= (t.x == v[4 * j]) & (t.y == v[4 * j + 1]) &
              (t.z == v[4 * j + 2]) & (t.w == v[4 * j + 3]);
      }
    } else if constexpr (K % 2 == 0) {
      const int2* p = reinterpret_cast<const int2*>(cur);
#pragma unroll
      for (int j = 0; j < K / 2; ++j) {
        const int2 t = ld_lanes<kL2>(p + j);
        eq &= (t.x == v[2 * j]) & (t.y == v[2 * j + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) eq &= ld_lanes<kL2>(cur + i) == v[i];
    }
    return eq;
  }

  // The lanes of the kGroup slots from a group's first (16-byte
  // aligned): kGroup * K ints, K int4 loads.
  template <bool kL2>
  __device__ __forceinline__ void load_group(const int32_t* first,
                                             int32_t (&t)[kGroup * K]) const {
    const int4* p = reinterpret_cast<const int4*>(first);
#pragma unroll
    for (int j = 0; j < kGroup * K / 4; ++j) {
      const int4 x = ld_lanes<kL2>(p + j);
      t[4 * j] = x.x;
      t[4 * j + 1] = x.y;
      t[4 * j + 2] = x.z;
      t[4 * j + 3] = x.w;
    }
  }

  // slot j of a loaded group holds the key (j known at compile time)
  __device__ __forceinline__ bool match(const int32_t (&t)[kGroup * K],
                                        int j) const {
    bool eq = true;
#pragma unroll
    for (int i = 0; i < K; ++i) eq &= t[j * K + i] == v[i];
    return eq;
  }

  __device__ __forceinline__ void store(int32_t* dst) const {
    if constexpr (K % 4 == 0) {
#pragma unroll
      for (int j = 0; j < K / 4; ++j) {
        reinterpret_cast<int4*>(dst)[j] =
            make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    } else if constexpr (K % 2 == 0) {
#pragma unroll
      for (int j = 0; j < K / 2; ++j) {
        reinterpret_cast<int2*>(dst)[j] = make_int2(v[2 * j], v[2 * j + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) dst[i] = v[i];
    }
  }
};

// k key lanes at run time (wide keys, or a table whose slots are not
// 16-byte aligned): the lanes stay in the batch row and are read from
// there at each comparison, and the table lanes one by one.
struct LanesN {
  static constexpr bool kGrouped = false;
  static constexpr int kLanes = 0;
  const int32_t* row = nullptr;
  int n;

  __device__ __forceinline__ explicit LanesN(int k) : n(k) {}
  __device__ __forceinline__ int k() const { return n; }
  __device__ __forceinline__ void load(const int32_t* r) { row = r; }
  __device__ __forceinline__ uint32_t hash() const {
    return hash_lanes(row, n);
  }

  template <bool kL2>
  __device__ __forceinline__ bool equals(const int32_t* cur) const {
    bool eq = true;
    for (int i = 0; i < n; ++i) eq &= ld_lanes<kL2>(cur + i) == row[i];
    return eq;
  }

  __device__ __forceinline__ void store(int32_t* dst) const {
    for (int i = 0; i < n; ++i) dst[i] = row[i];
  }
};

// Launch `LAUNCH(key type)` with the key held in registers for 1-8 lanes
// and group probes when the table allows them (rw::groups_aligned), else
// with the lanes read at run time and one slot a step.
#define RW_LANES_SWITCH(k, aligned, LAUNCH)          \
  switch ((aligned) ? (k) : 0) {                     \
    case 1: LAUNCH(rw::Lanes<1>); break;             \
    case 2: LAUNCH(rw::Lanes<2>); break;             \
    case 3: LAUNCH(rw::Lanes<3>); break;             \
    case 4: LAUNCH(rw::Lanes<4>); break;             \
    case 5: LAUNCH(rw::Lanes<5>); break;             \
    case 6: LAUNCH(rw::Lanes<6>); break;             \
    case 7: LAUNCH(rw::Lanes<7>); break;             \
    case 8: LAUNCH(rw::Lanes<8>); break;             \
    default: LAUNCH(rw::LanesN); break;              \
  }

// Groups of kGroup slots of a table at `tkeys` / `occ` (shard strides cap
// * k and cap words) are 16-byte aligned at every shard.
inline bool groups_aligned(const void* tkeys, const void* occ,
                           long long cap) {
  return reinterpret_cast<uintptr_t>(tkeys) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(occ) % 16 == 0 && cap % kGroup == 0;
}

// Read-only probe (K8, K6's lookup): the table is not written while the
// kernel runs, so each step loads occ and the lanes together (one round
// trip a step) through the read-only path: a group of kGroup slots a step
// with the key in registers, else one slot. The slots are examined in
// probe order from the home slot (the home group's earlier slots are
// skipped). Returns the key's slot, -1 at the first empty slot (absent),
// -2 after cap slots (a full table: the load-factor contract was broken).
template <class Key>
__device__ __forceinline__ int find_slot(const Key& key,
                                         const int32_t* __restrict__ tkeys,
                                         const int32_t* __restrict__ occ,
                                         uint32_t cap) {
  const uint32_t mask = cap - 1u;
  const uint32_t home = key.hash() & mask;
  if constexpr (Key::kGrouped) {
    constexpr int K = Key::kLanes;
    uint32_t base = home & ~static_cast<uint32_t>(kGroup - 1);
    int from = static_cast<int>(home - base);
    for (uint32_t left = cap;;) {
      const int4 o4 = __ldg(reinterpret_cast<const int4*>(occ + base));
      int32_t t[kGroup * K];
      key.template load_group<false>(tkeys + static_cast<size_t>(base) * K,
                                     t);
      const int32_t o[kGroup] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < from) continue;
        if (left-- == 0) return -2;
        if (o[j] == kEmpty) return -1;
        if (key.match(t, j)) return static_cast<int>(base + j);
      }
      from = 0;
      base = (base + kGroup) & mask;
    }
  } else {
    uint32_t slot = home;
    for (uint32_t step = 0; step < cap; ++step) {
      const int32_t o = __ldg(occ + slot);
      const bool eq = key.template equals<false>(
          tkeys + static_cast<size_t>(slot) * key.k());
      if (o == kEmpty) return -1;
      if (eq) return static_cast<int>(slot);
      slot = (slot + 1u) & mask;
    }
    return -2;
  }
}

// A slot seen empty or busy (`seen`): claim it for the key if it is
// empty (CAS empty -> busy, write the lanes, release ready), else wait
// until it is ready. Returns true when this row claimed it; on false the
// slot is ready and the caller's acquire load has made the winner's lanes
// visible (they must be read again).
template <class Key>
__device__ __forceinline__ bool claim_or_wait(const Key& key, int32_t* lanes,
                                              int32_t* occ, int32_t seen) {
  int32_t s = seen;
  if (s == kEmpty) {
    if (atomicCAS(occ, kEmpty, kBusy) == kEmpty) {
      key.store(lanes);
      st_release(occ, kReady);
      return true;
    }
    s = ld_acquire(occ);
  }
  while (s == kBusy) {
    __nanosleep(32);
    s = ld_acquire(occ);
  }
  return false;
}

// Find-or-insert (K1). An empty slot is claimed with atomicCAS (empty ->
// busy); the winner writes its lanes and publishes occ = ready with a
// release store. Every other load of occ is an acquire: a row that sees
// ready, at its first look or after waiting out busy, has synchronized
// with the winner's release, so its lane loads (after the acquire in
// program order) read the winner's lanes; a slot published before this
// launch is seen ready by any load. A step takes a group of kGroup slots
// with the key in registers (one slot otherwise): the group's lanes are
// prefetched into L2 beside the acquire load of its occ words and read
// after it, so a step costs one trip to memory and one to L2. A slot
// that was not ready at the group's load and is ready after a lost CAS
// or a wait has its lanes read again (the CAS itself is relaxed, so the
// state it returns is re-read with an acquire). Equal keys in one batch
// meet on one slot: a loser compares against the winner's published key.
// `hash` is the key's row hash. Returns the slot, with *inserted set when
// this row claimed it, or -1 after cap slots.
template <class Key>
__device__ __forceinline__ int find_or_insert(const Key& key, uint32_t hash,
                                              int32_t* tkeys, int32_t* occ,
                                              uint32_t cap, bool* inserted) {
  const uint32_t mask = cap - 1u;
  const uint32_t home = hash & mask;
  if constexpr (Key::kGrouped) {
    constexpr int K = Key::kLanes;
    uint32_t base = home & ~static_cast<uint32_t>(kGroup - 1);
    int from = static_cast<int>(home - base);
    for (uint32_t left = cap; left > 0;) {
      int32_t* first = tkeys + static_cast<size_t>(base) * K;
      prefetch_l2(first);
      prefetch_l2(first + kGroup * K - 1);
      const int4 o4 = ld_acquire4(occ + base);
      int32_t t[kGroup * K];
      key.template load_group<true>(first, t);
      const int32_t o[kGroup] = {o4.x, o4.y, o4.z, o4.w};
      // the group's slots in probe order: the key's (done), or the first
      // one not ready (stop), or none of them
      int stop = -1;
      int32_t seen = kEmpty;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < from || stop >= 0 || left == 0) continue;
        --left;
        if (o[j] != kReady) {
          stop = j;
          seen = o[j];
        } else if (key.match(t, j)) {
          return static_cast<int>(base + j);
        }
      }
      if (stop >= 0) {
        // one claim site for the whole group, so the lanes of a warp that
        // claim in one step publish with one release instruction
        int32_t* lanes = first + stop * K;
        if (claim_or_wait(key, lanes, occ + base + stop, seen)) {
          *inserted = true;
          return static_cast<int>(base + stop);
        }
        if (key.template equals<true>(lanes)) {
          return static_cast<int>(base + stop);
        }
        from = stop + 1;
      } else {
        from = kGroup;
      }
      if (from == kGroup) {
        from = 0;
        base = (base + kGroup) & mask;
      }
    }
    return -1;
  } else {
    uint32_t slot = home;
    for (uint32_t step = 0; step < cap; ++step) {
      int32_t* cur = tkeys + static_cast<size_t>(slot) * key.k();
      prefetch_l2(cur);
      prefetch_l2(cur + key.k() - 1);
      const int32_t o = ld_acquire(occ + slot);
      if (o != kReady && claim_or_wait(key, cur, occ + slot, o)) {
        *inserted = true;
        return static_cast<int>(slot);
      }
      if (key.template equals<true>(cur)) return static_cast<int>(slot);
      slot = (slot + 1u) & mask;
    }
    return -1;
  }
}

// The end of a warp in a launch that returns stats [count, flag] from
// the launch itself, with no zeroing launch before it: `stats` is zero on
// entry (the launch before it on the stream zeroed it, see zero_next),
// each warp counts its rows' bits by ballot and its lane 0 adds them with
// one atomic each (none when both are 0), so no warp waits for another
// and no fence is needed: the launch's end orders the sums before any
// reader. Every lane of the warp calls it.
__device__ __forceinline__ void warp_stats(bool counted, bool flagged,
                                           int32_t* stats) {
  const unsigned c = __ballot_sync(0xffffffffu, counted);
  const unsigned f = __ballot_sync(0xffffffffu, flagged);
  if ((threadIdx.x & 31) == 0) {
    if (c != 0u) atomicAdd(stats, __popc(c));
    if (f != 0u) atomicOr(stats + 1, 1);
  }
}

// The first block zeroes `next` (n words), the stats block of the launch
// after this one on the stream (risingwave_tpu_torch/ops/cuda.py
// stats_chain).
__device__ __forceinline__ void zero_next(int32_t* next, int n) {
  if (blockIdx.x != 0 || blockIdx.y != 0) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) next[i] = 0;
}

// The lanes of a warp that hold the same key as another lane's meet on
// one probe: `act` lanes match their hashes (__match_any_sync), each
// lane compares its key with its group's lowest lane (the leader), and a
// lane whose key equals the leader's leaves the probe to it. Returns the
// leader's lane; *follow is set on a lane that takes the leader's slot.
// Every lane of the warp calls it (the collectives take the full mask).
template <int K>
__device__ __forceinline__ int warp_leader(const Lanes<K>& key, bool act,
                                           uint32_t h, bool* follow) {
  const unsigned long long tag =
      (static_cast<unsigned long long>(act) << 32) | h;
  const unsigned peers = __match_any_sync(0xffffffffu, tag);
  const int leader = __ffs(peers) - 1;
  bool same = true;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    same &= __shfl_sync(0xffffffffu, key.v[i], leader) == key.v[i];
  }
  *follow = act && same && leader != static_cast<int>(threadIdx.x & 31);
  return leader;
}

}  // namespace rw

RW_API const char* rw_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
