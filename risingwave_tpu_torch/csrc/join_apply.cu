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
// among the rows of one slot: the first row (lowest batch index) becomes
// the new head, each row's next is the next same-slot row, and the last
// row points at the old head. Probe pairs come out in chain order, so the
// emitted chunks depend on it. A per-row atomicExch on head would give
// some order, not this one, so the kernel orders each slot's rows itself,
// with no library sort:
//
//   bucket_kernel  each insert row i pushes itself onto its slot's
//                  bucket list: lst[i] = atomicExch(&bucket[slot], i).
//                  The list order is arbitrary.
//   link_kernel    each insert row walks its slot's bucket and finds its
//                  successor in batch order (the least j > i) and whether
//                  any row precedes it (some j < i). It writes
//                  next[ref_i] = ref_succ, or the OLD head when it is the
//                  last row (head is not written until the next launch),
//                  ins_seq[ref_i] = seq_i, and its payload lanes. Delete
//                  rows write del_seq[ref] = seq in the same launch.
//   head_kernel    the first row of each slot writes head[slot] = ref and
//                  restores bucket[slot] = -1, so the per-slot bucket array
//                  (owned by the join side, sized to the key table) is all
//                  -1 again for the next launch.
//
// Every part is optional: link only (JoinSideKernel.insert, rebuild),
// tombstone only (delete), or everything (epoch_apply).
//
// Shards: grid.y = shard. Shard s reads its n rows at its own shard
// stride of every row input (the routed receive block of `route`, or one
// batch with S = 1), and writes its own head/bucket (cap per shard) and
// next/ins_seq/del_seq/pay (row_cap per shard, indexed by the GLOBAL row
// ref: a ref lives on its key's owner shard only). Rows whose insert and
// delete bits are both off touch nothing: route's empty received rows
// carry zero flags (their ref 0 is a real ref, so the flags decide).
//
// What bounds it on the card: bytes for the common case — each row reads
// its aux entries and slot and writes three int32 row-array entries plus
// its P payload lanes; the chain arrays are touched only at the batch's
// refs and slots. A slot shared by k rows of one batch costs each of them
// a k-step bucket walk (O(k^2) for the slot): q8's join rows hit distinct
// slots (k = 1), a hot key inside one epoch pays quadratically. On the
// sharded path every shard also reads the flags of its mostly empty
// receive block (S * bucket rows).
#include "common.cuh"

namespace {

struct Apply {
  const int32_t* slots;
  long long slots_ss;
  const int32_t* ins_ok;
  long long ins_ok_st, ins_ok_ss;
  int ins_bits;
  const int32_t* ins_ref;
  long long ins_ref_st, ins_ref_ss;
  const int32_t* seq;
  long long seq_st, seq_ss;
  const int32_t* del_ok;
  long long del_ok_st, del_ok_ss;
  int del_bits;
  const int32_t* del_ref;
  long long del_ref_st, del_ref_ss;
  const int32_t* pay_src;
  long long pay_src_st, pay_src_ss;
  int p;
  int n;
  int32_t* head;        // [S, cap]
  long long cap;
  int32_t* next;        // [S, row_cap]
  int32_t* ins_seq;
  int32_t* del_seq;
  long long row_cap;
  int32_t* pay;         // [S, row_cap, p]
  int32_t* bucket;      // [S, cap]
  int32_t* lst;         // [S, n]
  int32_t* first;       // [S, n]
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

__global__ void bucket_kernel(Apply a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long s = blockIdx.y;
  if (i >= a.n || !on(a.ins_ok, a.ins_ok_st, a.ins_ok_ss, a.ins_bits, s, i))
    return;
  const int32_t sl = a.slots[s * a.slots_ss + i];
  if (sl < 0) return;
  a.lst[s * a.n + i] = atomicExch(&a.bucket[s * a.cap + sl], i);
}

__global__ void link_kernel(Apply a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long s = blockIdx.y;
  if (i >= a.n) return;
  const bool ins = on(a.ins_ok, a.ins_ok_st, a.ins_ok_ss, a.ins_bits, s, i);
  const bool del = on(a.del_ok, a.del_ok_st, a.del_ok_ss, a.del_bits, s, i);
  if (!ins && !del) return;
  const int32_t sq = at(a.seq, a.seq_st, a.seq_ss, s, i);
  const long long rows = s * a.row_cap;
  if (del) {
    const long long r = at(a.del_ref, a.del_ref_st, a.del_ref_ss, s, i);
    if (r >= 0 && r < a.row_cap) a.del_seq[rows + r] = sq;
  }
  if (!ins) return;
  const long long r = at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, s, i);
  const bool in_range = r >= 0 && r < a.row_cap;
  if (a.pay_src != nullptr && in_range) {
    const int32_t* src = a.pay_src + s * a.pay_src_ss +
                         static_cast<long long>(i) * a.pay_src_st;
    int32_t* dst = a.pay + (rows + r) * a.p;
    for (int c = 0; c < a.p; ++c) dst[c] = src[c];
  }
  if (a.slots == nullptr) return;
  const int32_t sl = a.slots[s * a.slots_ss + i];
  if (sl < 0) return;
  const int32_t* lst = a.lst + s * a.n;
  int succ = a.n;
  bool has_prev = false;
  for (int j = a.bucket[s * a.cap + sl]; j >= 0; j = lst[j]) {
    if (j < i) {
      has_prev = true;
    } else if (j > i && j < succ) {
      succ = j;
    }
  }
  a.first[s * a.n + i] = has_prev ? 0 : 1;
  if (in_range) {
    a.next[rows + r] =
        succ < a.n ? at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, s, succ)
                   : a.head[s * a.cap + sl];
    a.ins_seq[rows + r] = sq;
  }
}

__global__ void head_kernel(Apply a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long s = blockIdx.y;
  if (i >= a.n || !on(a.ins_ok, a.ins_ok_st, a.ins_ok_ss, a.ins_bits, s, i))
    return;
  const int32_t sl = a.slots[s * a.slots_ss + i];
  if (sl < 0 || a.first[s * a.n + i] == 0) return;
  a.head[s * a.cap + sl] = at(a.ins_ref, a.ins_ref_st, a.ins_ref_ss, s, i);
  a.bucket[s * a.cap + sl] = -1;
}

}  // namespace

// Null pointers switch parts off: slots (no link), del_ok (no tombstone),
// pay_src (no payload). Every row input has a row stride (_st) and a
// shard stride (_ss); seq may have both 0 (one scalar). head and bucket
// are int32[S, cap], next/ins_seq/del_seq int32[S, row_cap], pay
// int32[S, row_cap, p]. bucket: all -1 on entry and on exit. rows:
// int32[2 * S * n] scratch (bucket lists, first-row flags).
RW_API int rw_join_apply(
    const void* slots, long long slots_ss, const void* ins_ok,
    long long ins_ok_st, long long ins_ok_ss, int ins_bits,
    const void* ins_ref, long long ins_ref_st, long long ins_ref_ss,
    const void* seq, long long seq_st, long long seq_ss, const void* del_ok,
    long long del_ok_st, long long del_ok_ss, int del_bits,
    const void* del_ref, long long del_ref_st, long long del_ref_ss,
    const void* pay_src, long long pay_src_st, long long pay_src_ss, int p,
    int n, int shards, void* head, long long cap, void* next, void* ins_seq,
    void* del_seq, long long row_cap, void* pay, void* bucket, void* rows,
    void* stream) {
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
  a.del_ok = static_cast<const int32_t*>(del_ok);
  a.del_ok_st = del_ok_st;
  a.del_ok_ss = del_ok_ss;
  a.del_bits = del_bits;
  a.del_ref = static_cast<const int32_t*>(del_ref);
  a.del_ref_st = del_ref_st;
  a.del_ref_ss = del_ref_ss;
  a.pay_src = static_cast<const int32_t*>(pay_src);
  a.pay_src_st = pay_src_st;
  a.pay_src_ss = pay_src_ss;
  a.p = p;
  a.n = n;
  a.head = static_cast<int32_t*>(head);
  a.cap = cap;
  a.next = static_cast<int32_t*>(next);
  a.ins_seq = static_cast<int32_t*>(ins_seq);
  a.del_seq = static_cast<int32_t*>(del_seq);
  a.row_cap = row_cap;
  a.pay = static_cast<int32_t*>(pay);
  a.bucket = static_cast<int32_t*>(bucket);
  a.lst = static_cast<int32_t*>(rows);
  a.first = a.lst + static_cast<long long>(shards) * n;
  constexpr int kThreads = 256;
  const dim3 grid(rw::blocks_for(n, kThreads), shards);
  if (a.slots != nullptr) bucket_kernel<<<grid, kThreads, 0, st>>>(a);
  link_kernel<<<grid, kThreads, 0, st>>>(a);
  if (a.slots != nullptr) head_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
