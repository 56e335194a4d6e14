// Fused NHWC conv2d + bias + activation, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_conv_kernel` / `conv2d_pallas` in
// src/repro/kernels/conv2d.py.  Same function: x (N,H,W,CI) NHWC times
// w (KH,KW,CI,CO) HWIO, stride (sh, sw), "same" padding split the
// TensorFlow way (the extra row/column on the bottom/right) or "valid",
// plus the fp32 bias, then none, relu or leaky_relu(alpha) as a select;
// fp32 accumulation and the output in x's type (fp32 or bf16).
//
// What bounds it on the card.  At the robot detector's shapes (batch
// 256, 3x3 taps, fp32; bytes = x + w + b + y read or written once, ops =
// 2 per multiply-add) the bytes take 3.35 TB/s and the operations 67
// TFLOP/s on the CUDA cores:
//
//   layer      x              CI->CO  MB    GFLOP  bytes us  ops us
//   conv2d_1   256x60x80x3    3->8    54.1  0.54   16.1      8.1   bytes
//   conv2d_5   256x30x40x8    8->12   24.6  0.53    7.3      7.9   ops
//   conv2d_8   256x30x40x12   12->8   24.6  0.53    7.3      7.9   ops
//   conv2d_12  256x15x20x8    8->16    7.4  0.18    2.2      2.7   ops
//   conv2d_15  256x15x20x16   16->20  11.1  0.44    3.3      6.6   ops
//
// The two bounds lie within 10-20% of each other on four layers, so the
// tensor cores could save at most that gap, and TF32 keeps about three
// digits where the kernel is held to 1e-5: the kernel stays in fp32 on
// the CUDA cores.  Its job is to keep the fp32 lanes and the memory, not
// the load/store unit, busy: one thread per output with two global loads
// a multiply-add (the kernel this replaces) issued about 0.5 fused
// multiply-adds a load.
//
// What the design does about it.
//  * A block owns `th` output rows at the full output width and `cot`
//    output channels of one image (grid: images x row tiles, channel
//    tiles).  It stages the input strip under its rows, halo included,
//    once in shared memory as fp32: pixel-major like NHWC, each pixel
//    padded to `cip` floats, an odd number of 16-byte chunks, so that a
//    warp's float4 reads of 32 neighbouring pixels hit every bank once.
//    fp32 arrives by cp.async, 16 bytes a copy where CI is a multiple
//    of 4 and 4 where not (CI 1 or 3); bf16 by plain loads, converted,
//    8 bytes at a time where it can.  Padding rows,
//    columns and channels are zeros in shared memory, so the tap loop
//    has no bounds checks.  Each input value is read from device memory
//    once a block instead of KH*KW*CO times.
//  * The block's filters, KH*KW*CI*cot, are staged in fp32 too (16-byte
//    cp.async where fp32 and CO a multiple of 4), laid out so that one
//    thread's C channels for 4 input channels are 4*C consecutive
//    floats: float4 loads that a warp shares (broadcasts).
//  * Output pixel (r, col) of the tile is position q = r*wq + col of its
//    flattened rows and reads strip pixels from q*sw on: the positions
//    of a thread are plain offsets, and the columns from ow to wq (the
//    halo of each row) are computed and dropped.
//  * A thread accumulates P pixels x C channels in registers (C 4, 8 or
//    12; P*C = 32 or 48): for each tap and each 4 input channels it
//    loads P float4 activations and C float4 weights and issues 4*P*C
//    fused multiply-adds, 10.7-12 a shared-memory load.  The taps (KH,
//    KW, strides) are compile-time for the shapes of the four nets.
//  * Every other shape takes a general kernel with runtime taps, which
//    also takes the shapes whose full-width strip and filters exceed
//    227 KB (wide rows, deep layers, very large windows): a block
//    covers `th` rows by `tw` output columns, its strip
//    `(tw - 1)*sw + kw` pixels wide, and where even a narrow tile's
//    strip and filters do not fit it walks the filter in chunks of
//    input channels (then of filter rows or columns), staging each
//    chunk and summing it into the same registers, with a barrier
//    before the next.  Every shape the TPU kernel takes gets a plan.
//    The compiled-tap kernel keeps its own parameter block (ConvArgs):
//    the robot's kernels ran measurably slower with the tile and chunk
//    fields added to it, though they read none of them.
//  * Sums run taps outside, input channels inside, in fp32 fmas, then
//    the bias, as the kernel this replaces did (chunk by chunk in the
//    general kernel).  The epilogue applies the activation, converts
//    once (round to nearest even for bf16) and stores each pixel's C
//    channels with 16-byte (8 for bf16 at C 4) stores; a warp's pixels
//    are neighbours, so a warp writes contiguous NHWC bytes where the
//    tile holds every channel.
// The tile (th, tw, lanes, passes, c, cot, chunks) comes from conv_plan()
// in kernels/conv2d.py, which the CPU tests check.  On the card the five
// robot layers take about 3.4x their bound (PERF.md): a sweep of every
// tile moved each layer little, the fmas issue well under the fp32
// rate, and neither a software-pipelined step nor a persistent grid
// with double-buffered strips was faster.  The kernel allocates
// nothing and launches on the caller's stream; the C entry returns
// cudaGetLastError() for the Python wrapper to check.
#include "common.cuh"

namespace repro_torch {
namespace {

// Field for field the first 30 fields of the ctypes structure ConvArgs
// of kernels/conv2d.py.
struct ConvArgs {
  int n, h, w, ci, co, kh, kw, sh, sw, pt, pl, oh, ow, act;
  float alpha;
  // the plan
  int variant, c, cot, lanes, th, row_tiles, passes, wp, wq, ci4, cip,
      strip_rows, strip_pix, co_tiles, smem_bytes;
};

// A plan that is not whole (column tiles or chunks): the plan's tile and
// chunk fields after ConvArgs, as in kernels/conv2d.py's ConvArgs.  The
// whole-row kernel keeps ConvArgs alone: its parameter block, and with
// it the robot's compiled kernels, stay as they were.
struct ConvTileArgs : ConvArgs {
  int tw, col_tiles, cc, c_chunks, khc, h_chunks, kwc, w_chunks;
};

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float component(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Four converted values of a pixel's channels ci .. ci+3 (8- or 16-byte
// aligned): one vector load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float activate(float v, int act, float alpha) {
  if (act == 1) return v > 0.f ? v : 0.f;
  if (act == 2) return v > 0.f ? v : alpha * v;  // select, as the TPU kernel
  return v;
}

// Compiled taps (KH, KW) and strides (SH, SW), full-width row tiles.
template <typename T, int KH, int KW, int SH, int SW, int C>
__global__ void __launch_bounds__(kMaxThreads)
conv2d_tiled_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                    const float* __restrict__ bias, T* __restrict__ y,
                    const ConvArgs a) {
  constexpr int P = C == 4 ? 8 : 4;  // output pixels a thread accumulates
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // strip_pix x cip
  float* ws = xs + a.strip_pix * a.cip;         // filters, see below

  const int img = blockIdx.x / a.row_tiles;
  const int r0 = (blockIdx.x - img * a.row_tiles) * a.th;
  const int rows = min(a.th, a.oh - r0);
  const int co0 = blockIdx.y * a.cot;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int groups = a.cot / C;
  const int c4n = a.ci4 / 4;

  // Filters: ws[((tap*c4n + ci/4)*groups + g)*4C + (ci%4)*C + v] holds
  // w[tap][ci][co0 + g*C + v], zero past CI and CO.  A block's channels
  // of one (tap, ci) are contiguous in HWIO: copied 4 at a time, by
  // 16-byte cp.async where fp32 and aligned.
  constexpr int taps = KH * KW;
  const int n4 = a.cot / 4;
  const bool w_async = sizeof(T) == 4 && a.co % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  for (int e4 = tid; e4 < taps * a.ci4 * n4; e4 += nt) {
    const int v4 = e4 % n4;
    const int r = e4 / n4;
    const int ci = r % a.ci4, tap = r / a.ci4;
    const int co = co0 + 4 * v4;
    float* dst = ws + ((tap * c4n + ci / 4) * groups + 4 * v4 / C) * 4 * C +
                 (ci % 4) * C + 4 * v4 % C;
    const T* src = wt + (static_cast<int64_t>(tap) * a.ci + ci) * a.co + co;
    if (ci >= a.ci || co >= a.co) {
      store4(dst, 0.f, 0.f, 0.f, 0.f);
    } else if (w_async) {
      cp_async16(dst, src);
    } else {
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = co + t < a.co ? to_f32(src[t]) : 0.f;
      store4(dst, v[0], v[1], v[2], v[3]);
    }
  }

  // The input strip: strip row s is input row r0*sh - pt + s, strip
  // column t input column t - pl; zeros outside the image and in the
  // channels from CI to ci4.  fp32 arrives by cp.async (16 bytes where CI
  // is a multiple of 4 and x aligned, else 4), bf16 by plain loads.
  const int ih0 = r0 * SH - a.pt;
  const bool vec = a.ci % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
  const T* ximg = x + static_cast<int64_t>(img) * a.h * a.w * a.ci;
  for (int pix = tid; pix < a.strip_rows * a.wp; pix += nt) {
    const int s = pix / a.wp;
    const int ih = ih0 + s, iw = pix - s * a.wp - a.pl;
    float* dst = xs + pix * a.cip;
    if (ih < 0 || ih >= a.h || iw < 0 || iw >= a.w) {
      for (int c = 0; c < a.ci4; c += 4) store4(dst + c, 0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const T* src = ximg + (static_cast<int64_t>(ih) * a.w + iw) * a.ci;
    if (sizeof(T) == 4 && vec) {
      for (int c = 0; c < a.ci; c += 4) cp_async16(dst + c, src + c);
    } else if (sizeof(T) == 4) {
      for (int c = 0; c < a.ci; ++c) cp_async4(dst + c, src + c);
    } else if (vec) {
      for (int c = 0; c < a.ci; c += 4) {
        const float4 v = load4(src + c);
        store4(dst + c, v.x, v.y, v.z, v.w);
      }
    } else {
      for (int c = 0; c < a.ci; ++c) dst[c] = to_f32(src[c]);
    }
    for (int c = a.ci; c < a.ci4; ++c) dst[c] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // Thread (g, lane): channels co0 + g*C .. +C, positions
  // pass*P*lanes + lane + k*lanes of the tile's flattened rows.
  const int g = tid / a.lanes;  // lanes is a multiple of 32: warp-uniform
  const int lane = tid - g * a.lanes;
  const int cbase = co0 + g * C;
  float bv[C];
#pragma unroll
  for (int v = 0; v < C; ++v) bv[v] = cbase + v < a.co ? bias[cbase + v] : 0.f;
  const float* wg = ws + g * 4 * C;
  const int wstep = groups * 4 * C;  // floats from one 4-channel step on
  const int qlast = a.th * a.wq - 1;

  for (int pass = 0; pass < a.passes; ++pass) {
    const int q0 = pass * P * a.lanes + lane;
    int off[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      off[k] = min(q0 + k * a.lanes, qlast) * SW * a.cip;
    float acc[P][C];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int v = 0; v < C; ++v) acc[k][v] = 0.f;

#pragma unroll
    for (int i = 0; i < KH; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const float* xt = xs + (i * a.wp + j) * a.cip;
        const float* wtap = wg + (i * KW + j) * c4n * wstep;
#pragma unroll 1
        for (int c4 = 0; c4 < c4n; ++c4) {
          float4 xv[P];
#pragma unroll
          for (int k = 0; k < P; ++k) xv[k] = load4(xt + off[k] + 4 * c4);
          const float* wc = wtap + c4 * wstep;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float wv[C];
#pragma unroll
            for (int v = 0; v < C; v += 4) {
              const float4 t = load4(wc + u * C + v);
              wv[v] = t.x;
              wv[v + 1] = t.y;
              wv[v + 2] = t.z;
              wv[v + 3] = t.w;
            }
#pragma unroll
            for (int k = 0; k < P; ++k) {
              const float xu = component(xv[k], u);
#pragma unroll
              for (int v = 0; v < C; ++v)
                acc[k][v] = fmaf(xu, wv[v], acc[k][v]);
            }
          }
        }
      }
    }

    // Epilogue: bias, activation, one conversion, C channels a store.
    const bool whole = cbase + C <= a.co && a.co % 4 == 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = q0 + k * a.lanes;
      const int r = q / a.wq, col = q - r * a.wq;
      if (r >= rows || col >= a.ow) continue;
      T* out = y + ((static_cast<int64_t>(img) * a.oh + r0 + r) * a.ow + col) *
                       a.co + cbase;
      float o[C];
#pragma unroll
      for (int v = 0; v < C; ++v)
        o[v] = activate(acc[k][v] + bv[v], a.act, a.alpha);
      if (whole) {
#pragma unroll
        for (int v = 0; v < C; v += 4)
          store4(out + v, o[v], o[v + 1], o[v + 2], o[v + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < C; ++v)
          if (cbase + v < a.co) out[v] = from_f32<T>(o[v]);
      }
    }
  }
}

// Runtime taps (variant 0), whole or not: a block covers `th` rows by
// `tw` columns of one image and `cot` output channels.  Each pass walks
// the filter's chunks, filter-row and filter-column chunks outside and
// input-channel chunks inside: it stages a chunk's filters and strip in
// shared memory (once for every pass where there is one chunk), sums it
// into the same registers as the compiled-tap kernel does, and
// synchronizes before the next chunk overwrites it.  A whole plan (one
// column tile, one chunk) stages the full-width strip once.
template <typename T, int C>
__global__ void __launch_bounds__(kMaxThreads)
conv2d_general_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const float* __restrict__ bias, T* __restrict__ y,
                      const ConvTileArgs a) {
  constexpr int P = C == 4 ? 8 : 4;  // output pixels a thread accumulates
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // strip_pix x cip
  float* ws = xs + a.strip_pix * a.cip;         // a chunk's filters

  // blockIdx.x -> (image, row tile, column tile)
  const int tile = blockIdx.x / a.col_tiles;
  const int c0 = (blockIdx.x - tile * a.col_tiles) * a.tw;
  const int img = tile / a.row_tiles;
  const int r0 = (tile - img * a.row_tiles) * a.th;
  const int rows = min(a.th, a.oh - r0), cols = min(a.tw, a.ow - c0);
  const int co0 = blockIdx.y * a.cot;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int groups = a.cot / C;
  const int c4n = a.cc / 4;
  const int n4 = a.cot / 4;
  const int chunks = a.c_chunks * a.h_chunks * a.w_chunks;
  const T* ximg = x + static_cast<int64_t>(img) * a.h * a.w * a.ci;
  const bool w_async = sizeof(T) == 4 && a.co % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  const bool vec = a.ci % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;

  // Thread (g, lane): channels co0 + g*C .. +C, positions
  // pass*P*lanes + lane + k*lanes of the tile's flattened rows.
  const int g = tid / a.lanes;  // lanes is a multiple of 32
  const int lane = tid - g * a.lanes;
  const int cbase = co0 + g * C;
  float bv[C];
#pragma unroll
  for (int v = 0; v < C; ++v) bv[v] = cbase + v < a.co ? bias[cbase + v] : 0.f;
  const float* wg = ws + g * 4 * C;
  const int wstep = groups * 4 * C;  // floats from one 4-channel step on
  const int qlast = a.th * a.wq - 1;

  for (int pass = 0; pass < a.passes; ++pass) {
    const int q0 = pass * P * a.lanes + lane;
    int off[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      off[k] = min(q0 + k * a.lanes, qlast) * a.sw * a.cip;
    float acc[P][C];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int v = 0; v < C; ++v) acc[k][v] = 0.f;

    for (int ck = 0; ck < chunks; ++ck) {
      // the chunk: filter rows i0 .. i0+kh, columns j0 .. j0+kw, input
      // channels ch0 .. ch0+cc
      const int tk = ck / a.c_chunks, hk = tk / a.w_chunks;
      const int i0 = hk * a.khc, j0 = (tk - hk * a.w_chunks) * a.kwc;
      const int ch0 = (ck - tk * a.c_chunks) * a.cc;
      const int kh = min(a.khc, a.kh - i0), kw = min(a.kwc, a.kw - j0);
      if (chunks > 1 || pass == 0) {
        if (pass > 0 || ck > 0) __syncthreads();  // the last chunk is read
        // Filters: ws[((tap*c4n + c/4)*groups + g)*4C + (c%4)*C + v]
        // holds w[i0 + tap/kw][j0 + tap%kw][ch0 + c][co0 + g*C + v],
        // zero past CI and CO, as the compiled-tap kernel lays them out.
        for (int e4 = tid; e4 < kh * kw * a.cc * n4; e4 += nt) {
          const int v4 = e4 % n4;
          const int r = e4 / n4;
          const int c = r % a.cc, tap = r / a.cc;
          const int i = tap / kw, j = tap - i * kw;
          const int ci = ch0 + c, co = co0 + 4 * v4;
          float* dst = ws + ((tap * c4n + c / 4) * groups + 4 * v4 / C) * 4 *
                                C + (c % 4) * C + 4 * v4 % C;
          const T* src = wt + (static_cast<int64_t>((i0 + i) * a.kw + j0 + j) *
                                   a.ci + ci) * a.co + co;
          if (ci >= a.ci || co >= a.co) {
            store4(dst, 0.f, 0.f, 0.f, 0.f);
          } else if (w_async) {
            cp_async16(dst, src);
          } else {
            float v[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              v[t] = co + t < a.co ? to_f32(src[t]) : 0.f;
            store4(dst, v[0], v[1], v[2], v[3]);
          }
        }
        // The strip: pixel (s, t) is input pixel (r0*sh - pt + i0 + s,
        // c0*sw - pl + j0 + t), channels ch0 .. ch0+cc; zeros outside
        // the image and from CI on.
        const int ih0 = r0 * a.sh - a.pt + i0, iw0 = c0 * a.sw - a.pl + j0;
        const int nci = min(a.cc, a.ci - ch0);  // channels the image has
        for (int pix = tid; pix < a.strip_rows * a.wp; pix += nt) {
          const int s = pix / a.wp;
          const int ih = ih0 + s, iw = iw0 + pix - s * a.wp;
          float* dst = xs + pix * a.cip;
          if (ih < 0 || ih >= a.h || iw < 0 || iw >= a.w) {
            for (int c = 0; c < a.cc; c += 4)
              store4(dst + c, 0.f, 0.f, 0.f, 0.f);
            continue;
          }
          const T* src =
              ximg + (static_cast<int64_t>(ih) * a.w + iw) * a.ci + ch0;
          if (sizeof(T) == 4 && vec) {
            for (int c = 0; c < nci; c += 4) cp_async16(dst + c, src + c);
          } else if (sizeof(T) == 4) {
            for (int c = 0; c < nci; ++c) cp_async4(dst + c, src + c);
          } else if (vec) {
            for (int c = 0; c < nci; c += 4) {
              const float4 v = load4(src + c);
              store4(dst + c, v.x, v.y, v.z, v.w);
            }
          } else {
            for (int c = 0; c < nci; ++c) dst[c] = to_f32(src[c]);
          }
          for (int c = nci; c < a.cc; ++c) dst[c] = 0.f;
        }
        cp_async_wait_all();
        __syncthreads();
      }

      for (int i = 0; i < kh; ++i) {
        for (int j = 0; j < kw; ++j) {
          const float* xt = xs + (i * a.wp + j) * a.cip;
          const float* wtap = wg + (i * kw + j) * c4n * wstep;
#pragma unroll 1
          for (int c4 = 0; c4 < c4n; ++c4) {
            float4 xv[P];
#pragma unroll
            for (int k = 0; k < P; ++k) xv[k] = load4(xt + off[k] + 4 * c4);
            const float* wc = wtap + c4 * wstep;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float wv[C];
#pragma unroll
              for (int v = 0; v < C; v += 4) {
                const float4 t = load4(wc + u * C + v);
                wv[v] = t.x;
                wv[v + 1] = t.y;
                wv[v + 2] = t.z;
                wv[v + 3] = t.w;
              }
#pragma unroll
              for (int k = 0; k < P; ++k) {
                const float xu = component(xv[k], u);
#pragma unroll
                for (int v = 0; v < C; ++v)
                  acc[k][v] = fmaf(xu, wv[v], acc[k][v]);
              }
            }
          }
        }
      }
    }

    // Epilogue: bias, activation, one conversion, C channels a store.
    const bool whole = cbase + C <= a.co && a.co % 4 == 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int q = q0 + k * a.lanes;
      const int r = q / a.wq, col = q - r * a.wq;
      if (r >= rows || col >= cols) continue;
      T* out = y + ((static_cast<int64_t>(img) * a.oh + r0 + r) * a.ow + c0 +
                    col) * a.co + cbase;
      float o[C];
#pragma unroll
      for (int v = 0; v < C; ++v)
        o[v] = activate(acc[k][v] + bv[v], a.act, a.alpha);
      if (whole) {
#pragma unroll
        for (int v = 0; v < C; v += 4)
          store4(out + v, o[v], o[v + 1], o[v + 2], o[v + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < C; ++v)
          if (cbase + v < a.co) out[v] = from_f32<T>(o[v]);
      }
    }
  }
}

template <typename T, int KH, int KW, int SH, int SW, int C>
int launch_tiled(const T* x, const T* w, const float* b, T* y,
                 const ConvArgs& a, cudaStream_t stream) {
  auto kernel = conv2d_tiled_kernel<T, KH, KW, SH, SW, C>;
  if (a.smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(a.n * a.row_tiles, a.co_tiles);
  kernel<<<grid, a.cot / C * a.lanes, a.smem_bytes, stream>>>(x, w, b, y, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_general(const T* x, const T* w, const float* b, T* y,
                   const ConvTileArgs& a, cudaStream_t stream) {
  auto kernel = conv2d_general_kernel<T, C>;
  if (a.smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(a.n * a.row_tiles * a.col_tiles, a.co_tiles);
  kernel<<<grid, a.cot / C * a.lanes, a.smem_bytes, stream>>>(x, w, b, y, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KH, int KW, int SH, int SW>
int launch_taps(const T* x, const T* w, const float* b, T* y,
                const ConvArgs& a, cudaStream_t stream) {
  if (a.kh != KH || a.kw != KW || a.sh != SH || a.sw != SW)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.c) {
    case 4: return launch_tiled<T, KH, KW, SH, SW, 4>(x, w, b, y, a, stream);
    case 8: return launch_tiled<T, KH, KW, SH, SW, 8>(x, w, b, y, a, stream);
    case 12: return launch_tiled<T, KH, KW, SH, SW, 12>(x, w, b, y, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The variants of TAP_VARIANTS in kernels/conv2d.py, in its order:
// variant 0 (runtime taps) takes the general kernel, the others the
// compiled-tap kernel, whose plans are whole.
template <typename T>
int launch_conv2d(const void* x, const void* w, const void* b, void* y,
                  const ConvTileArgs& a, void* stream) {
  const int threads = a.c > 0 && a.cot % a.c == 0 ? a.cot / a.c * a.lanes : 0;
  if (threads < 32 || threads > kMaxThreads || a.lanes % 32 != 0 ||
      a.smem_bytes > 232448 || a.cip % 4 != 0 || a.ci4 % 4 != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.variant == 0) {
    if (a.cc % 4 != 0 || a.cc < 4 || a.cip < a.cc || a.tw < 1 ||
        a.khc < 1 || a.kwc < 1 || a.co_tiles > 65535 ||
        static_cast<int64_t>(a.n) * a.row_tiles * a.col_tiles > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    switch (a.c) {
      case 4: return launch_general<T, 4>(xp, wp, bp, yp, a, s);
      case 8: return launch_general<T, 8>(xp, wp, bp, yp, a, s);
      case 12: return launch_general<T, 12>(xp, wp, bp, yp, a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a.col_tiles != 1 || a.c_chunks * a.h_chunks * a.w_chunks != 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (a.variant) {
    case 1: return launch_taps<T, 3, 3, 1, 1>(xp, wp, bp, yp, a, s);
    case 2: return launch_taps<T, 5, 5, 2, 2>(xp, wp, bp, yp, a, s);
    case 3: return launch_taps<T, 4, 2, 1, 1>(xp, wp, bp, yp, a, s);
    case 4: return launch_taps<T, 2, 2, 1, 1>(xp, wp, bp, yp, a, s);
    case 5: return launch_taps<T, 1, 1, 1, 1>(xp, wp, bp, yp, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes; `args` is kernels/conv2d.py's ConvArgs
// (this file's ConvTileArgs).
extern "C" int conv2d_nhwc_f32(const void* x, const void* w, const void* b,
                               void* y, const void* args, void* stream) {
  return repro_torch::launch_conv2d<float>(
      x, w, b, y, *static_cast<const repro_torch::ConvTileArgs*>(args),
      stream);
}

extern "C" int conv2d_nhwc_bf16(const void* x, const void* w, const void* b,
                                void* y, const void* args, void* stream) {
  return repro_torch::launch_conv2d<__nv_bfloat16>(
      x, w, b, y, *static_cast<const repro_torch::ConvTileArgs*>(args),
      stream);
}
