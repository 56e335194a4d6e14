// Shared helpers of the port's CUDA kernels: fp32 <-> storage-type
// conversions for the two input types the TPU kernels accept (fp32, bf16),
// and the opt-in to more than 48 KB of dynamic shared memory.
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

// A kernel gets more than 48 KB of dynamic shared memory only after
// opting in, and the opt-in is an attribute of the kernel on one device.
// Opt in at the kernel's first launch on each device, so that a later
// launch (one inside a CUDA graph capture among them) only enqueues.
// `done` is the calling launcher's flags, one a device; a device numbered
// past them opts in at every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t opt_in_shared_memory(Kernel kern, int bytes,
                                 bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace repro_torch
