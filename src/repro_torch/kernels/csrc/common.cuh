// Shared helpers of the port's CUDA kernels: fp32 <-> storage-type
// conversions for the two input types the TPU kernels accept (fp32, bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype does
}

// One thread per output element; 256 threads a block.
constexpr int kThreads = 256;

// Blocks for `total` threads, or 0 when the grid would not fit in x.
inline unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

}  // namespace repro_torch
