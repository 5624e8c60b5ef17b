// Kernel K7: join_maint — maintenance writes of a join side's row arrays.
//
// masked_scatter replaces risingwave_tpu/ops/hash_join.py:361
// _masked_scatter and rebase replaces :457 _rebase_jit (both B17). The
// third B17 program, :446 _remap_head, runs on K4's remap
// (csrc/rebuild.cu) over the one head row with fill -1.
//
// masked_scatter: one thread per row; a visible row with 0 <= ref < cap
// writes its `width` int32 values to arr[ref] (payload lanes on a rebuild,
// degree values on recovery). Refs are distinct, as in the reference.
// rebase: one elementwise pass; every finite ins/del sequence becomes 0,
// I32_MAX (never inserted / live) stays.
//
// What bounds them on the card: bytes — masked_scatter reads each row's
// ref, flag and values once and writes width ints per visible row; rebase
// reads and writes both sequence arrays once.
#include "common.cuh"

namespace {

constexpr int32_t kI32Max = 0x7FFFFFFF;

__global__ void masked_scatter_kernel(int32_t* __restrict__ arr,
                                      long long cap, int width,
                                      const int32_t* __restrict__ refs,
                                      const int32_t* __restrict__ vis,
                                      const int32_t* __restrict__ vals,
                                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || vis[i] == 0) return;
  const long long r = refs[i];
  if (r < 0 || r >= cap) return;
  for (int c = 0; c < width; ++c) {
    arr[r * width + c] = vals[static_cast<long long>(i) * width + c];
  }
}

__global__ void rebase_kernel(int32_t* __restrict__ ins_seq,
                              int32_t* __restrict__ del_seq, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  if (ins_seq[i] != kI32Max) ins_seq[i] = 0;
  if (del_seq[i] != kI32Max) del_seq[i] = 0;
}

}  // namespace

RW_API int rw_masked_scatter(void* arr, long long cap, int width,
                             const void* refs, const void* vis,
                             const void* vals, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    constexpr int kThreads = 256;
    masked_scatter_kernel<<<rw::blocks_for(n, kThreads), kThreads, 0, st>>>(
        static_cast<int32_t*>(arr), cap, width,
        static_cast<const int32_t*>(refs), static_cast<const int32_t*>(vis),
        static_cast<const int32_t*>(vals), n);
  }
  return static_cast<int>(cudaGetLastError());
}

RW_API int rw_rebase(void* ins_seq, void* del_seq, long long n,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    constexpr int kThreads = 256;
    rebase_kernel<<<rw::blocks_for(n, kThreads), kThreads, 0, st>>>(
        static_cast<int32_t*>(ins_seq), static_cast<int32_t*>(del_seq), n);
  }
  return static_cast<int>(cudaGetLastError());
}
