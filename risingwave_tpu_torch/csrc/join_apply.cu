// Kernel K5: join_apply — link a batch of rows into their key chains,
// tombstone deletes, and scatter the inserted rows' payload lanes.
//
// Replaces risingwave_tpu/ops/hash_join.py:68 link_rows (B11), :106
// tombstone_rows (B12) and the rest of :203 epoch_apply (B14) after K1
// (probe_insert) has given each insert row its key slot.
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
// What bounds it on the card: bytes for the common case — each row reads
// its aux entries and slot and writes three int32 row-array entries plus
// its P payload lanes; the chain arrays are touched only at the batch's
// refs and slots. A slot shared by k rows of one batch costs each of them
// a k-step bucket walk (O(k^2) for the slot): q8's join rows hit distinct
// slots (k = 1), a hot key inside one epoch pays quadratically.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool on(const int32_t* p, long long stride,
                                   int bits, int i) {
  return p != nullptr &&
         (p[static_cast<long long>(i) * stride] & bits) != 0;
}

__global__ void bucket_kernel(const int32_t* __restrict__ slots,
                              const int32_t* __restrict__ ins_ok,
                              long long ins_ok_stride, int ins_bits, int n,
                              int32_t* bucket, int32_t* __restrict__ lst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !on(ins_ok, ins_ok_stride, ins_bits, i)) return;
  const int32_t s = slots[i];
  if (s < 0) return;
  lst[i] = atomicExch(&bucket[s], i);
}

__global__ void link_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ ins_ok,
    long long ins_ok_stride, int ins_bits,
    const int32_t* __restrict__ ins_ref, long long ins_ref_stride,
    const int32_t* __restrict__ seq, long long seq_stride,
    const int32_t* __restrict__ del_ok, long long del_ok_stride,
    int del_bits, const int32_t* __restrict__ del_ref,
    long long del_ref_stride, const int32_t* __restrict__ pay_src,
    long long pay_src_stride, int p, int n,
    const int32_t* __restrict__ head, int32_t* __restrict__ next,
    int32_t* __restrict__ ins_seq, int32_t* __restrict__ del_seq,
    long long row_cap, int32_t* __restrict__ pay,
    const int32_t* __restrict__ bucket, const int32_t* __restrict__ lst,
    int32_t* __restrict__ first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t sq = seq[static_cast<long long>(i) * seq_stride];
  if (on(del_ok, del_ok_stride, del_bits, i)) {
    const long long r = del_ref[static_cast<long long>(i) * del_ref_stride];
    if (r >= 0 && r < row_cap) del_seq[r] = sq;
  }
  if (!on(ins_ok, ins_ok_stride, ins_bits, i)) return;
  const long long r = ins_ref[static_cast<long long>(i) * ins_ref_stride];
  const bool in_range = r >= 0 && r < row_cap;
  if (pay_src != nullptr && in_range) {
    const int32_t* src = pay_src + static_cast<long long>(i) * pay_src_stride;
    for (int c = 0; c < p; ++c) pay[r * p + c] = src[c];
  }
  if (slots == nullptr) return;
  const int32_t s = slots[i];
  if (s < 0) return;
  int succ = n;
  bool has_prev = false;
  for (int j = bucket[s]; j >= 0; j = lst[j]) {
    if (j < i) {
      has_prev = true;
    } else if (j > i && j < succ) {
      succ = j;
    }
  }
  first[i] = has_prev ? 0 : 1;
  if (in_range) {
    next[r] = succ < n
                  ? ins_ref[static_cast<long long>(succ) * ins_ref_stride]
                  : head[s];
    ins_seq[r] = sq;
  }
}

__global__ void head_kernel(const int32_t* __restrict__ slots,
                            const int32_t* __restrict__ ins_ok,
                            long long ins_ok_stride, int ins_bits,
                            const int32_t* __restrict__ ins_ref,
                            long long ins_ref_stride, int n,
                            int32_t* __restrict__ head, int32_t* bucket,
                            const int32_t* __restrict__ first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !on(ins_ok, ins_ok_stride, ins_bits, i)) return;
  const int32_t s = slots[i];
  if (s < 0 || first[i] == 0) return;
  head[s] = ins_ref[static_cast<long long>(i) * ins_ref_stride];
  bucket[s] = -1;
}

}  // namespace

// Null pointers switch parts off: slots (no link), del_ok (no tombstone),
// pay_src (no payload). bucket: int32[cap], all -1 on entry and on exit.
// rows: int32[2n] scratch (bucket lists, first-row flags).
RW_API int rw_join_apply(
    const void* slots, const void* ins_ok, long long ins_ok_stride,
    int ins_bits, const void* ins_ref, long long ins_ref_stride,
    const void* seq, long long seq_stride, const void* del_ok,
    long long del_ok_stride, int del_bits, const void* del_ref,
    long long del_ref_stride, const void* pay_src, long long pay_src_stride,
    int p, int n, void* head, long long cap, void* next, void* ins_seq,
    void* del_seq, long long row_cap, void* pay, void* bucket, void* rows,
    void* stream) {
  (void)cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const int blocks = rw::blocks_for(n, kThreads);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const int32_t* io = static_cast<const int32_t*>(ins_ok);
  const int32_t* ir = static_cast<const int32_t*>(ins_ref);
  int32_t* lst = static_cast<int32_t*>(rows);
  int32_t* first = lst + n;
  int32_t* bk = static_cast<int32_t*>(bucket);
  if (sl != nullptr) {
    bucket_kernel<<<blocks, kThreads, 0, st>>>(sl, io, ins_ok_stride,
                                               ins_bits, n, bk, lst);
  }
  link_kernel<<<blocks, kThreads, 0, st>>>(
      sl, io, ins_ok_stride, ins_bits, ir, ins_ref_stride,
      static_cast<const int32_t*>(seq), seq_stride,
      static_cast<const int32_t*>(del_ok), del_ok_stride, del_bits,
      static_cast<const int32_t*>(del_ref), del_ref_stride,
      static_cast<const int32_t*>(pay_src), pay_src_stride, p, n,
      static_cast<const int32_t*>(head), static_cast<int32_t*>(next),
      static_cast<int32_t*>(ins_seq), static_cast<int32_t*>(del_seq),
      row_cap, static_cast<int32_t*>(pay), bk, lst, first);
  if (sl != nullptr) {
    head_kernel<<<blocks, kThreads, 0, st>>>(
        sl, io, ins_ok_stride, ins_bits, ir, ins_ref_stride, n,
        static_cast<int32_t*>(head), bk, first);
  }
  return static_cast<int>(cudaGetLastError());
}
