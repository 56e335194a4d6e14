// Fused NHWC conv2d + bias + activation, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv_kernel` / `conv2d_pallas` in
// src/repro/kernels/conv2d.py.  Same function: x (N,H,W,CI) NHWC times
// w (KH,KW,CI,CO) HWIO, stride (sh, sw), "same" padding split the
// TensorFlow way (the extra row/column on the bottom/right) or "valid",
// plus the fp32 bias, then none, relu or leaky_relu(alpha); fp32
// accumulation and the output in x's type (fp32 or bf16).
//
// What bounds it on the card.  At the robot detector's shapes (CI and
// CO between 3 and 20, 3x3 taps) the work is 2*CI*KH*KW flops per output
// against one output write, so a layer sits near the H100's ridge point
// for fp32 FMA outside the tensor cores (67 TFLOP/s against 3.35 TB/s):
// the first layer, with CI = 3, is bound by its bytes, the deeper ones by
// their fp32 operations.  The tensor cores do not help at K = 27..180 in
// fp32 at 1e-5 parity (TF32 keeps ~3 digits).
//
// What the design does about it.  The TPU kernel keeps a whole padded
// image in VMEM and issues one MXU dot per tap with c_out on the 128
// lanes; none of that carries over.  Here each thread computes one
// output element (n, oh, ow, co) with co fastest, so the output store
// and the HWIO weight reads of a warp are coalesced and the activation
// reads are warp broadcasts served from L1.  "same" padding is a bounds
// check inside the tap loop, so nothing is padded in device memory.
// The kernel allocates nothing and launches on the caller's stream; the
// C entry returns cudaGetLastError() for the Python wrapper to check.
// This is the simple kernel that is right; tiling x through shared
// memory is the next step.
#include "common.cuh"

namespace repro_torch {
namespace {

struct ConvShape {
  int n, h, w, ci, co, kh, kw, sh, sw, pt, pl, oh, ow, act;
  float alpha;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ bias, T* __restrict__ y,
                   ConvShape s) {
  const int64_t total = static_cast<int64_t>(s.n) * s.oh * s.ow * s.co;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = static_cast<int>(idx % s.co);
  int64_t r = idx / s.co;
  const int ow = static_cast<int>(r % s.ow);
  r /= s.ow;
  const int oh = static_cast<int>(r % s.oh);
  const int n = static_cast<int>(r / s.oh);
  const int ih0 = oh * s.sh - s.pt;
  const int iw0 = ow * s.sw - s.pl;

  float acc = 0.f;
  for (int i = 0; i < s.kh; ++i) {
    const int ih = ih0 + i;
    if (ih < 0 || ih >= s.h) continue;  // zero padding: the tap adds 0
    for (int j = 0; j < s.kw; ++j) {
      const int iw = iw0 + j;
      if (iw < 0 || iw >= s.w) continue;
      const T* xp = x + ((static_cast<int64_t>(n) * s.h + ih) * s.w + iw) *
                            s.ci;
      const T* wp =
          wt + static_cast<int64_t>(i * s.kw + j) * s.ci * s.co + co;
      for (int c = 0; c < s.ci; ++c) {
        acc = fmaf(to_f32(xp[c]), to_f32(wp[static_cast<int64_t>(c) * s.co]),
                   acc);
      }
    }
  }
  acc += bias[co];
  if (s.act == 1) {
    acc = acc > 0.f ? acc : 0.f;
  } else if (s.act == 2) {
    acc = acc > 0.f ? acc : s.alpha * acc;  // select, as the TPU kernel
  }
  y[idx] = from_f32<T>(acc);
}

template <typename T>
int launch_conv2d(const void* x, const void* w, const void* b, void* y,
                  const ConvShape& s, void* stream) {
  const int64_t total = static_cast<int64_t>(s.n) * s.oh * s.ow * s.co;
  const unsigned grid = grid_for(total);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv2d_nhwc_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes.  act: 0 none, 1 relu, 2 leaky_relu.
// pt/pl are the top/left zero padding; oh/ow the output extent.
extern "C" int conv2d_nhwc_f32(const void* x, const void* w, const void* b,
                               void* y, int n, int h, int wd, int ci, int co,
                               int kh, int kw, int sh, int sw, int pt, int pl,
                               int oh, int ow, int act, float alpha,
                               void* stream) {
  const repro_torch::ConvShape s{n,  h,  wd, ci, co, kh, kw, sh,
                                 sw, pt, pl, oh, ow, act, alpha};
  return repro_torch::launch_conv2d<float>(x, w, b, y, s, stream);
}

extern "C" int conv2d_nhwc_bf16(const void* x, const void* w, const void* b,
                                void* y, int n, int h, int wd, int ci, int co,
                                int kh, int kw, int sh, int sw, int pt, int pl,
                                int oh, int ow, int act, float alpha,
                                void* stream) {
  const repro_torch::ConvShape s{n,  h,  wd, ci, co, kh, kw, sh,
                                 sw, pt, pl, oh, ow, act, alpha};
  return repro_torch::launch_conv2d<__nv_bfloat16>(x, w, b, y, s, stream);
}
