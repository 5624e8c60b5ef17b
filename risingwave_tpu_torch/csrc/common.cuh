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

}  // namespace rw

RW_API const char* rw_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
