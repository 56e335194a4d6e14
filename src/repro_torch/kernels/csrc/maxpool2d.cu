// NHWC 2-D max pool (valid padding, static window), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pool_kernel` / `maxpool2d_pallas` in
// src/repro/kernels/maxpool2d.py: x (N,H,W,C), window (kh, kw), stride
// (sh, sw) defaulting to the window, valid padding, fp32 or bf16.
//
// What bounds it on the card.  One compare per input tap against one
// read of each input and one write of each output: bytes, at the H100's
// 3.35 TB/s.  The robot detector's two pools at batch 256, (256,60,80,8)
// and (256,30,40,8) fp32 with 2x2/2 windows, move 49.2 and 12.3 MB: a
// 0.0147 and a 0.0037 ms bound.
//
// What held the first kernel (one thread an output element) back.  It
// recovered (n, oh, ow, c) with six 64-bit divisions and remainders,
// loaded 4 bytes at a time (at C 8 one warp's load of a tap covered
// four pixels 64 bytes apart), and ran a tap loop with runtime bounds
// that visited the first tap twice: on the order of 150 instructions an
// output, 3 M outputs, at 2.0x the bound.
//
// What this design does about it.  A streaming pass with no shared
// memory:
//  * A thread owns one vector of channels of one output pixel: 16
//    bytes (4 fp32 or 8 bf16), or 8, 4 or 2 where C times the element
//    size is no multiple of 16.  The block is (bx, by, bz)
//    threads: bx vectors of a pixel, by pixels of a row, bz rows, so the
//    hardware's thread indices are the (vector, pixel, row) coordinates,
//    and neighbouring lanes take neighbouring vectors of the output,
//    which every store of a warp covers as one contiguous run.  The grid
//    is (pixel tiles of a row, row tiles, vector tiles); the one
//    division left splits a row into (n, oh), once a thread.
//  * Indexing is 32-bit; one instantiation with 64-bit indices (runtime
//    taps) takes tensors of 2^31 elements or more.
//  * The taps of the nets' 2x2/2 and the JAX suite's 3x3/2 windows are
//    compiled in: a thread issues all its KH*KW loads, independent
//    `ld.global.nc.L1::no_allocate` vector loads that do not fill L1,
//    before any max, then stores with streaming stores (`st.global.cs`).
//    One instantiation takes any other window and stride at run time.
//  * The max is taken in the storage type with a NaN-propagating max
//    (`max.NaN.f32`, `__hmax2_nan` for two bf16), starting from a tap
//    and never from -inf: the output is exact, and a NaN tap gives NaN,
//    as torch.maximum does.
// The instantiation, vector width and grid come from
// pool_plan() in kernels/maxpool2d.py, which the CPU tests check and
// replay.  The kernel allocates nothing and launches on the caller's
// stream; the C entry returns cudaGetLastError().
#include "common.cuh"

namespace repro_torch {
namespace {

// Field for field the ctypes structure PoolArgs of kernels/maxpool2d.py.
struct PoolArgs {
  int n, h, w, c, kh, kw, sh, sw, oh, ow;
  // the plan
  int variant, vec, nv, bx, by, bz, gx, gy, gz, index64;
};

constexpr int kPoolThreads = 256;

// A vector of VB bytes as the word type a load or store moves.
template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 load_stream(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int load_stream(const unsigned int* p) {
  unsigned int v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short load_stream(
    const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// NaN-propagating max of two 32-bit words holding one fp32 or two bf16.
__device__ __forceinline__ unsigned int max_word(float, unsigned int a,
                                                 unsigned int b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;"
      : "=f"(d)
      : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(d);
}
__device__ __forceinline__ unsigned int max_word(__nv_bfloat16, unsigned int a,
                                                 unsigned int b) {
  const __nv_bfloat162 d =
      __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned int*>(&d);
}

template <typename T>
__device__ __forceinline__ uint4 max_vec(const uint4& a, const uint4& b) {
  return make_uint4(max_word(T(), a.x, b.x), max_word(T(), a.y, b.y),
                    max_word(T(), a.z, b.z), max_word(T(), a.w, b.w));
}
template <typename T>
__device__ __forceinline__ uint2 max_vec(const uint2& a, const uint2& b) {
  return make_uint2(max_word(T(), a.x, b.x), max_word(T(), a.y, b.y));
}
template <typename T>
__device__ __forceinline__ unsigned int max_vec(unsigned int a,
                                                unsigned int b) {
  return max_word(T(), a, b);
}
template <typename T>
__device__ __forceinline__ unsigned short max_vec(unsigned short a,
                                                  unsigned short b) {
  // only bf16 has 2-byte vectors
  return __bfloat16_as_ushort(
      __hmax_nan(__ushort_as_bfloat16(a), __ushort_as_bfloat16(b)));
}

// KH == 0: window and strides are runtime values.  Thread (x, y, z) of
// block (bx', by', bz'): vector v = bz'*bx + x of the pixel
// ow = bx'*by + y of output rows (by' + t*gridDim.y)*bz + z, t = 0, 1,
// ...  Pointers count vectors.
template <typename T, int VB, int KH, int KW, int SH, int SW,
          typename Index>
__global__ void __launch_bounds__(kPoolThreads)
maxpool2d_kernel(const typename Vec<VB>::type* __restrict__ x,
                 typename Vec<VB>::type* __restrict__ y, const PoolArgs a) {
  using V = typename Vec<VB>::type;
  const int kh = KH ? KH : a.kh, kw = KH ? KW : a.kw;
  const int sh = KH ? SH : a.sh, sw = KH ? SW : a.sw;
  const int v = blockIdx.z * a.bx + threadIdx.x;
  const int ow = blockIdx.x * a.by + threadIdx.y;
  if (v >= a.nv || ow >= a.ow) return;
  const Index nv = a.nv;
  const Index rows = static_cast<Index>(a.n) * a.oh;
  for (Index row = static_cast<Index>(blockIdx.y) * a.bz + threadIdx.z;
       row < rows; row += static_cast<Index>(gridDim.y) * a.bz) {
    const Index img = row / a.oh;
    const Index ih = img * a.h + (row - img * a.oh) * sh;
    // input pixel (ih, ow*sw) and output pixel (row, ow), vector v
    const V* xp = x + (ih * a.w + static_cast<Index>(ow) * sw) * nv + v;
    V* yp = y + (row * a.ow + ow) * nv + v;
    if constexpr (KH != 0) {
      V t[KH * KW];
#pragma unroll
      for (int i = 0; i < KH; ++i)
#pragma unroll
        for (int j = 0; j < KW; ++j)
          t[i * KW + j] = load_stream(xp + (i * a.w + j) * nv);
      V m = t[0];
#pragma unroll
      for (int u = 1; u < KH * KW; ++u) m = max_vec<T>(m, t[u]);
      __stcs(yp, m);
    } else {
      V m = load_stream(xp);
      for (int i = 0; i < kh; ++i)
        for (int j = i == 0; j < kw; ++j)
          m = max_vec<T>(m, load_stream(
                                xp + (static_cast<Index>(i) * a.w + j) * nv));
      __stcs(yp, m);
    }
  }
}

template <typename T, int VB, int KH, int KW, int SH, int SW,
          typename Index>
int launch(const void* x, void* y, const PoolArgs& a, cudaStream_t stream) {
  using V = typename Vec<VB>::type;
  const dim3 grid(a.gx, a.gy, a.gz), block(a.bx, a.by, a.bz);
  maxpool2d_kernel<T, VB, KH, KW, SH, SW, Index>
      <<<grid, block, 0, stream>>>(static_cast<const V*>(x),
                                   static_cast<V*>(y), a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations of one vector width: variants 1 (2x2/2) and 2
// (3x3/2), and variant 0 (runtime taps) with 32- or 64-bit indices;
// kernels/maxpool2d.py's POOL_VARIANTS.
template <typename T, int VB>
int launch_vec(const void* x, void* y, const PoolArgs& a,
               cudaStream_t stream) {
  if (a.index64) {
    if (a.variant != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, VB, 0, 0, 0, 0, int64_t>(x, y, a, stream);
  }
  switch (a.variant) {
    case 0: return launch<T, VB, 0, 0, 0, 0, int>(x, y, a, stream);
    case 1: return launch<T, VB, 2, 2, 2, 2, int>(x, y, a, stream);
    case 2: return launch<T, VB, 3, 3, 2, 2, int>(x, y, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_maxpool2d(const void* x, void* y, const PoolArgs& a,
                     void* stream) {
  const int keys[2][4] = {{2, 2, 2, 2}, {3, 3, 2, 2}};
  if (a.variant == 1 || a.variant == 2) {
    const int* k = keys[a.variant - 1];
    if (a.kh != k[0] || a.kw != k[1] || a.sh != k[2] || a.sw != k[3])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.bx < 1 || a.by < 1 || a.bz < 1 ||
      a.bx * a.by * a.bz > kPoolThreads || a.bz > 64 || a.gy > 65535 ||
      a.gz > 65535 || a.bx * a.gz < a.nv ||
      static_cast<int64_t>(a.nv) * a.vec !=
          static_cast<int64_t>(a.c) * static_cast<int64_t>(sizeof(T)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
          a.vec)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.vec) {
    case 16: return launch_vec<T, 16>(x, y, a, s);
    case 8: return launch_vec<T, 8>(x, y, a, s);
    case 4: return launch_vec<T, 4>(x, y, a, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch_vec<T, 2>(x, y, a, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes; `args` is kernels/maxpool2d.py's PoolArgs.
extern "C" int maxpool2d_nhwc_f32(const void* x, void* y, const void* args,
                                  void* stream) {
  return repro_torch::launch_maxpool2d<float>(
      x, y, *static_cast<const repro_torch::PoolArgs*>(args), stream);
}

extern "C" int maxpool2d_nhwc_bf16(const void* x, void* y, const void* args,
                                   void* stream) {
  return repro_torch::launch_maxpool2d<__nv_bfloat16>(
      x, y, *static_cast<const repro_torch::PoolArgs*>(args), stream);
}
