// NHWC 2-D max pool (valid padding, static window), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pool_kernel` / `maxpool2d_pallas` in
// src/repro/kernels/maxpool2d.py: x (N,H,W,C), window (kh, kw), stride
// (sh, sw) defaulting to the window, valid padding, fp32 or bf16.
//
// What bounds it on the card.  One compare per input tap against one
// read of each input and one write of each output: bytes, at the H100's
// 3.35 TB/s.
//
// What the design does about it.  The TPU kernel keeps a (H, W, C-tile)
// block in VMEM with channels on the lanes; here each thread computes
// one output element (n, oh, ow, c) with c fastest, so a warp's loads of
// one tap and its stores are contiguous runs of channels.  The running
// max starts from the window's first tap (never from -inf) and is held
// in the storage type, so the result is exact in fp32 and bf16.  The
// kernel allocates nothing, launches on the caller's stream and the C
// entry returns cudaGetLastError().
#include "common.cuh"

namespace repro_torch {
namespace {

struct PoolShape {
  int n, h, w, c, kh, kw, sh, sw, oh, ow;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool2d_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y,
                      PoolShape s) {
  const int64_t total = static_cast<int64_t>(s.n) * s.oh * s.ow * s.c;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % s.c);
  int64_t r = idx / s.c;
  const int ow = static_cast<int>(r % s.ow);
  r /= s.ow;
  const int oh = static_cast<int>(r % s.oh);
  const int n = static_cast<int>(r / s.oh);
  const T* xp = x +
                ((static_cast<int64_t>(n) * s.h + oh * s.sh) * s.w +
                 ow * s.sw) * s.c + c;
  T m = xp[0];
  float mf = to_f32(m);
  for (int i = 0; i < s.kh; ++i) {
    for (int j = 0; j < s.kw; ++j) {
      const T v = xp[(static_cast<int64_t>(i) * s.w + j) * s.c];
      const float vf = to_f32(v);
      if (vf > mf || vf != vf) {  // a NaN tap wins, as in torch.maximum
        mf = vf;
        m = v;
      }
    }
  }
  y[idx] = m;
}

template <typename T>
int launch_maxpool2d(const void* x, void* y, const PoolShape& s,
                     void* stream) {
  const int64_t total = static_cast<int64_t>(s.n) * s.oh * s.ow * s.c;
  const unsigned grid = grid_for(total);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  maxpool2d_nhwc_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes; oh/ow are the (valid) output extent.
extern "C" int maxpool2d_nhwc_f32(const void* x, void* y, int n, int h,
                                  int w, int c, int kh, int kw, int sh,
                                  int sw, int oh, int ow, void* stream) {
  const repro_torch::PoolShape s{n, h, w, c, kh, kw, sh, sw, oh, ow};
  return repro_torch::launch_maxpool2d<float>(x, y, s, stream);
}

extern "C" int maxpool2d_nhwc_bf16(const void* x, void* y, int n, int h,
                                   int w, int c, int kh, int kw, int sh,
                                   int sw, int oh, int ow, void* stream) {
  const repro_torch::PoolShape s{n, h, w, c, kh, kw, sh, sw, oh, ow};
  return repro_torch::launch_maxpool2d<__nv_bfloat16>(x, y, s, stream);
}
