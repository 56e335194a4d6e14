// Diagonal-decay linear-attention scan, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_scan_kernel` / `linear_scan_pallas` in
// src/repro/kernels/linear_scan.py.  Same function, per (batch, head),
// state S in R^{N x M}:
//
//     S_t = diag(decay_t) S_{t-1} + k_t^T v_t ,   y_t = r_t S_t
//
// decay, k, r (B,T,H,N) and v (B,T,H,M) contiguous, all fp32 or all bf16;
// s0 and the final state (B,H,N,M) fp32; y (B,T,H,M) in v's type.  The
// state is fp32 throughout.
//
// What bounds it on the card.  Each step does 5*N*M flops per head
// against (3N + 2M) inputs and outputs, a few flops per byte: at the
// main path's shape (rwkv6-7b: B 4, T 1536, H 64, N = M = 64) it sits
// near the fp32 ridge point, and 1536 dependent steps mean the serial
// chain through T, not the card's rate, sets the time.
//
// What the design does about it.  The TPU kernel's sequential chunk grid
// axis, with the state in VMEM scratch, becomes a loop over T inside one
// block; nothing is carried between blocks.  One block of 64 threads per
// (b, h, 64-column tile of M); thread m keeps state column S[:, m] (N
// values) in registers for the whole sequence, so the state never
// touches memory between s0 and the final state.  Every 32 steps the
// block stages decay, k and r for those steps in shared memory as fp32
// with one coalesced load (the 64 threads then read them as broadcasts);
// v and y are one coalesced element a thread per step.  The simple kernel
// that is right; a chunked (parallel-in-T) form is the next step
// (ROADMAP Queue 2).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kScanThreads = 64;  // state columns a block
constexpr int kScanChunk = 32;    // steps staged at once

struct ScanShape {
  int b, t, h, m;
};

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads)
linear_scan_kernel(const T* __restrict__ decay, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ r,
                   const float* __restrict__ s0, T* __restrict__ y,
                   float* __restrict__ s_final, ScanShape s) {
  __shared__ float ds[kScanChunk][N];
  __shared__ float kst[kScanChunk][N];
  __shared__ float rs[kScanChunk][N];
  const int col = blockIdx.x * kScanThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool live = col < s.m;

  const long long state0 = (static_cast<long long>(b) * s.h + h) * N * s.m;
  float st[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    st[n] = live ? s0[state0 + static_cast<long long>(n) * s.m + col] : 0.f;

  for (int t0 = 0; t0 < s.t; t0 += kScanChunk) {
    const int steps = min(kScanChunk, s.t - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < steps * N; i += kScanThreads) {
      const int tt = i / N, n = i % N;
      const long long at =
          ((static_cast<long long>(b) * s.t + t0 + tt) * s.h + h) * N + n;
      ds[tt][n] = to_f32(decay[at]);
      kst[tt][n] = to_f32(k[at]);
      rs[tt][n] = to_f32(r[at]);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const long long at =
          ((static_cast<long long>(b) * s.t + t0 + tt) * s.h + h) * s.m + col;
      const float vt = to_f32(v[at]);
      float out = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        st[n] = fmaf(ds[tt][n], st[n], kst[tt][n] * vt);
        out = fmaf(rs[tt][n], st[n], out);
      }
      y[at] = from_f32<T>(out);
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < N; ++n)
    s_final[state0 + static_cast<long long>(n) * s.m + col] = st[n];
}

template <typename T, int N>
int launch_scan(const void* decay, const void* k, const void* v,
                const void* r, const void* s0, void* y, void* s_final,
                const ScanShape& s, void* stream) {
  const dim3 grid((s.m + kScanThreads - 1) / kScanThreads, s.h, s.b);
  linear_scan_kernel<T, N><<<grid, kScanThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(decay), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(r),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_final), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_scan(const void* decay, const void* k, const void* v,
                  const void* r, const void* s0, void* y, void* s_final,
                  int n, const ScanShape& s, void* stream) {
  switch (n) {
    case 4: return launch_scan<T, 4>(decay, k, v, r, s0, y, s_final, s, stream);
    case 8: return launch_scan<T, 8>(decay, k, v, r, s0, y, s_final, s, stream);
    case 16: return launch_scan<T, 16>(decay, k, v, r, s0, y, s_final, s, stream);
    case 32: return launch_scan<T, 32>(decay, k, v, r, s0, y, s_final, s, stream);
    case 64: return launch_scan<T, 64>(decay, k, v, r, s0, y, s_final, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes.
#define REPRO_SCAN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* decay, const void* k, const void* v,      \
                      const void* r, const void* s0, void* y,               \
                      void* s_final, int b, int t, int h, int n, int m,     \
                      void* stream) {                                       \
    const repro_torch::ScanShape s{b, t, h, m};                             \
    return repro_torch::dispatch_scan<T>(decay, k, v, r, s0, y, s_final, n, \
                                         s, stream);                        \
  }

REPRO_SCAN_ENTRY(linear_scan_f32, float)
REPRO_SCAN_ENTRY(linear_scan_bf16, __nv_bfloat16)
