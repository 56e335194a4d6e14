// One-token attention against a bf16 KV cache (the decode step's), written
// by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package decodes with the plain
// `decode_attention_jax` (src/repro/models/layers.py), which XLA fuses on
// the TPU.  The port's plain version (`decode_attention_ref` in
// kernels/ref.py) runs it as PyTorch ops, and in the graphed decode step
// those cast the whole bf16 cache to fp32 and clone each einsum operand
// into a batchable layout: some six times the cache's bytes a layer.  This
// kernel was added for that step: it reads each cache byte once.
//
// The function is the plain version's.  q (B,1,H,Dh) against k/v caches
// (B,S,Hkv,Dh), G = H / Hkv q heads to a kv head (q head hk * G + g).  A
// score is the fp32 sum of bf16 x bf16 products (each exact in fp32),
// then times the scale.  Slot s of a ring cache holds position
// pos - ((pos - s) mod S), of a linear one position s; a slot is attended
// when its position lies in [0, pos] and, with a window, pos minus it is
// below the window.  Softmax in fp32 over the attended slots; p
// normalized, then rounded to bf16; p.v summed in fp32; the output
// rounded to bf16.  No attended slot gives 0.
//
// What bounds it on the card: bytes.  It does two flops a cache byte.  At
// the benchmark's step (B 64, S 320, Hkv 16, Dh 128) one layer reads
// 168 MB of cache: 0.050 ms at 3.35 TB/s.
//
// What the design does about it.
// - p is rounded after the softmax's max and sum over every attended
//   slot are known, so the cache is read in two passes, K then V, each
//   once.  Kernel 1 scores a chunk of slots and writes the fp32 scores
//   and the chunk's max and sum of exp to a scratch (1.3 MB a layer at
//   the benchmark's step, against 168 MB of cache).  Kernel 2 forms the
//   global max and sum of its (b, kv head) from the chunks' (max, sum),
//   then p, and sums p.v over its chunk.  With one chunk it writes the
//   output; with more, kernel 3 sums the chunks' fp32 parts in order.
// - The grid is (chunks, B * Hkv); the wrapper picks the chunk (at most
//   kMaxChunk slots) so that the grid fills the card: at the
//   benchmark's step one chunk, 1,024 blocks.
// - A cache row is Dh bf16 in 16-byte loads, one a thread: a row is read
//   by tpr threads (a power of two, Dh / 8 rounded up), so a block of 128
//   threads has 128 / tpr rows in flight, kUnroll times over before it
//   uses them.  Rows are strided by the caches' strides, so a narrow of
//   the kv heads needs no copy.
// - pos is read from device memory: the step is captured in a CUDA graph
//   and replayed with the position advancing on the card.  A block whose
//   chunk holds no attended slot exits before reading the cache (the
//   slots past pos of a linear cache: zeros that p = 0 multiplies), and
//   rows that are not attended are not read.
// - No atomics, every sum in a fixed order: two runs, and a graph's
//   replay against the eager step, give the same bits.
#include <math_constants.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // bf16 values in 16 bytes
constexpr int kMaxChunk = 512;   // slots a block; the wrapper's MAX_CHUNK
constexpr int kMaxGroup = 8;     // q heads a kv head; the wrapper's MAX_GROUP
constexpr int kMaxHeadDim = 256;
constexpr int kUnroll = 4;       // rows of a thread's loads in flight

struct DecodeArgs {
  int b, s, hkv, g, dh;
  long long q_sb, q_sh;        // strides of q's b and h (elements)
  long long k_sb, k_ss, k_sh;  // of the caches' b, s and h
  long long v_sb, v_ss, v_sh;
  int ring, windowed, window;
  long long pos;  // the position when no device pointer is given
  float scale;
  int chunk, n_chunks;
  int tpr;  // threads a cache row
};

// The scratch: scores (B*Hkv, S, G); each chunk's (max, sum of exp) as
// (B*Hkv, chunks, 2, G); with more than one chunk, each chunk's fp32
// output (B*Hkv, chunks, G, Dh).  The wrapper sizes it alike.
__device__ __forceinline__ float* scores_of(float* scratch,
                                            const DecodeArgs& a, int bh) {
  return scratch + static_cast<long long>(bh) * a.s * a.g;
}
__device__ __forceinline__ float* stats_of(float* scratch,
                                           const DecodeArgs& a, int bh) {
  const long long rows = static_cast<long long>(a.b) * a.hkv;
  return scratch + rows * a.s * a.g +
         static_cast<long long>(bh) * a.n_chunks * 2 * a.g;
}
__device__ __forceinline__ float* parts_of(float* scratch,
                                           const DecodeArgs& a, int bh) {
  const long long rows = static_cast<long long>(a.b) * a.hkv;
  return scratch + rows * a.s * a.g + rows * a.n_chunks * 2 * a.g +
         static_cast<long long>(bh) * a.n_chunks * a.g * a.dh;
}

// whether slot s is attended by the token at pos (the plain version's
// mask)
__device__ __forceinline__ bool attended(long long s, long long pos,
                                         const DecodeArgs& a) {
  long long back;  // pos minus the slot's position
  if (a.ring) {
    back = (pos - s) % a.s;
    if (back < 0) back += a.s;
    if (pos - back < 0) return false;
  } else {
    if (s > pos) return false;
    back = pos - s;
  }
  return !a.windowed || back < a.window;
}

__device__ __forceinline__ long long position(const long long* pos_ptr,
                                              const DecodeArgs& a) {
  return pos_ptr != nullptr ? *pos_ptr : a.pos;
}

// whether any slot of [c0, c0 + n) is attended; every thread gets it
__device__ __forceinline__ bool chunk_attended(int c0, int n, long long pos,
                                               const DecodeArgs& a) {
  bool any = false;
  for (int r = threadIdx.x; r < n && !any; r += kThreads)
    any = attended(c0 + r, pos, a);
  return __syncthreads_or(any);
}

__device__ __forceinline__ void unpack(const uint4& w, float (&f)[kVec]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[j]));
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// x[g] reduced over the block's threads by op, in a fixed order (a
// butterfly in each warp, then the warps in turn); every thread gets it
template <int G, class Op>
__device__ __forceinline__ void block_reduce(float (&x)[G], float* red,
                                             Op op) {
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int off = 16; off > 0; off >>= 1)
      x[g] = op(x[g], __shfl_xor_sync(0xffffffffu, x[g], off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[warp * G + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    x[g] = red[g];
    for (int w = 1; w < kWarps; ++w) x[g] = op(x[g], red[w * G + g]);
  }
}

// Kernel 1: the scores of one chunk of one (b, kv head), and the chunk's
// max and sum of exp per q head.
template <int G>
__global__ void __launch_bounds__(kThreads)
    decode_scores_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const long long* __restrict__ pos_ptr,
                         float* __restrict__ scratch, const DecodeArgs a) {
  __shared__ float q_s[G * kMaxHeadDim];
  __shared__ float sc[kMaxChunk * G];
  __shared__ float red[kWarps * G];
  const int bh = blockIdx.y, bi = bh / a.hkv, hi = bh - bi * a.hkv;
  const int c0 = blockIdx.x * a.chunk, n = min(a.chunk, a.s - c0);
  const long long pos = position(pos_ptr, a);
  float* stats = stats_of(scratch, a, bh) + 2 * G * blockIdx.x;
  if (!chunk_attended(c0, n, pos, a)) {  // an empty chunk: sum 0
    if (threadIdx.x < 2 * G) stats[threadIdx.x] = 0.f;
    return;
  }
  const bf16* qb = q + bi * a.q_sb + static_cast<long long>(hi) * G * a.q_sh;
  for (int i = threadIdx.x; i < G * a.dh; i += kThreads) {
    const int g = i / a.dh, d = i - g * a.dh;
    q_s[g * kMaxHeadDim + d] = __bfloat162float(qb[g * a.q_sh + d]);
  }
  __syncthreads();
  const int grp = threadIdx.x / a.tpr, li = threadIdx.x - grp * a.tpr;
  const int rows = kThreads / a.tpr;
  const bool lane_on = li * kVec < a.dh;
  float qr[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qr[g][e] = lane_on ? q_s[g * kMaxHeadDim + li * kVec + e] : 0.f;
  const bf16* kb = k + bi * a.k_sb + hi * a.k_sh + li * kVec;
  for (int base = 0; base < n; base += kUnroll * rows) {
    uint4 w[kUnroll];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * rows + grp;
      on[u] = r < n && attended(c0 + r, pos, a);
      w[u] = make_uint4(0u, 0u, 0u, 0u);
      if (on[u] && lane_on)
        w[u] = __ldg(reinterpret_cast<const uint4*>(
            kb + static_cast<long long>(c0 + r) * a.k_ss));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec], part[G];
      unpack(w[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part[g] = fmaf(qr[g][e], kf[e], part[g]);
        for (int off = a.tpr / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      }
      const int r = base + u * rows + grp;
      if (li == 0 && r < n) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          sc[r * G + g] = on[u] ? part[g] * a.scale : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -CUDART_INF_F;
  for (int r = threadIdx.x; r < n; r += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], sc[r * G + g]);
  block_reduce<G>(m, red, [](float x, float y) { return fmaxf(x, y); });
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = 0.f;
  for (int r = threadIdx.x; r < n; r += kThreads)
#pragma unroll
    for (int g = 0; g < G; ++g) l[g] += expf(sc[r * G + g] - m[g]);
  __syncthreads();  // red is read by every thread before it is rewritten
  block_reduce<G>(l, red, [](float x, float y) { return x + y; });
  if (threadIdx.x < G) {
    stats[threadIdx.x] = m[threadIdx.x];
    stats[G + threadIdx.x] = l[threadIdx.x];
  }
  float* out = scores_of(scratch, a, bh) + static_cast<long long>(c0) * G;
  for (int i = threadIdx.x; i < n * G; i += kThreads) out[i] = sc[i];
}

// Kernel 2: p of one chunk from the global max and sum, rounded to bf16,
// and the chunk's p.v; the output itself when there is one chunk.
template <int G>
__global__ void __launch_bounds__(kThreads)
    decode_pv_kernel(const bf16* __restrict__ v,
                     const long long* __restrict__ pos_ptr,
                     float* __restrict__ scratch, bf16* __restrict__ o,
                     const DecodeArgs a) {
  // p of the chunk's rows, then each row group's p.v
  __shared__ __align__(16) float buf[kThreads * kVec * G];
  __shared__ float ml[2 * G];
  const int bh = blockIdx.y, bi = bh / a.hkv, hi = bh - bi * a.hkv;
  const int c0 = blockIdx.x * a.chunk, n = min(a.chunk, a.s - c0);
  const long long pos = position(pos_ptr, a);
  const float* stats = stats_of(scratch, a, bh);
  bf16* ob = o + (static_cast<long long>(bi) * a.hkv + hi) * G * a.dh;
  if (stats[2 * G * blockIdx.x + G] == 0.f) {  // no attended slot
    if (a.n_chunks == 1)
      for (int i = threadIdx.x; i < G * a.dh; i += kThreads)
        ob[i] = __float2bfloat16_rn(0.f);
    return;
  }
  if (threadIdx.x < G) {  // the global max and sum, chunks in order
    const int g = threadIdx.x;
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < a.n_chunks; ++j)
      if (stats[2 * G * j + G] != 0.f) m = fmaxf(m, stats[2 * G * j + g]);
    for (int j = 0; j < a.n_chunks; ++j)
      if (stats[2 * G * j + G] != 0.f)
        l += stats[2 * G * j + G + g] * expf(stats[2 * G * j + g] - m);
    ml[g] = m;
    ml[G + g] = l;
  }
  __syncthreads();
  const float* sc = scores_of(scratch, a, bh) + static_cast<long long>(c0) * G;
  for (int i = threadIdx.x; i < n * G; i += kThreads) {
    const int g = i % G;
    buf[i] = __bfloat162float(
        __float2bfloat16_rn(expf(sc[i] - ml[g]) / ml[G + g]));
  }
  __syncthreads();
  const int grp = threadIdx.x / a.tpr, li = threadIdx.x - grp * a.tpr;
  const int rows = kThreads / a.tpr;
  const bool lane_on = li * kVec < a.dh;
  float acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  const bf16* vb = v + bi * a.v_sb + hi * a.v_sh + li * kVec;
  for (int base = 0; base < n; base += kUnroll * rows) {
    uint4 w[kUnroll];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * rows + grp;
      on[u] = r < n && lane_on && attended(c0 + r, pos, a);
      if (on[u])
        w[u] = __ldg(reinterpret_cast<const uint4*>(
            vb + static_cast<long long>(c0 + r) * a.v_ss));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!on[u]) continue;
      const int r = base + u * rows + grp;
      float vf[kVec];
      unpack(w[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = buf[r * G + g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  __syncthreads();  // every p is read; buf now takes the groups' sums
  if (lane_on) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        buf[(grp * G + g) * a.dh + li * kVec + e] = acc[g][e];
  }
  __syncthreads();
  float* part = parts_of(scratch, a, bh) +
                static_cast<long long>(blockIdx.x) * G * a.dh;
  for (int i = threadIdx.x; i < G * a.dh; i += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < rows; ++j) sum += buf[j * G * a.dh + i];
    if (a.n_chunks == 1)
      ob[i] = __float2bfloat16_rn(sum);
    else
      part[i] = sum;
  }
}

// Kernel 3 (more than one chunk): the chunks' outputs summed in order.
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(float* __restrict__ scratch, bf16* __restrict__ o,
                          const DecodeArgs a) {
  const int bh = blockIdx.x;
  const float* stats = stats_of(scratch, a, bh);
  const float* part = parts_of(scratch, a, bh);
  bf16* ob = o + static_cast<long long>(bh) * a.g * a.dh;
  for (int i = threadIdx.x; i < a.g * a.dh; i += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < a.n_chunks; ++j)
      if (stats[2 * a.g * j + a.g] != 0.f)
        sum += part[static_cast<long long>(j) * a.g * a.dh + i];
    ob[i] = __float2bfloat16_rn(sum);
  }
}

template <int G>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  const void* pos, void* scratch, const DecodeArgs& a,
                  cudaStream_t stream) {
  const dim3 grid(a.n_chunks, a.b * a.hkv);
  const auto* pos_ptr = static_cast<const long long*>(pos);
  auto* f = static_cast<float*>(scratch);
  decode_scores_kernel<G><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), pos_ptr, f,
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_pv_kernel<G><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(v), pos_ptr, f, static_cast<bf16*>(o), a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return static_cast<int>(err);
  decode_combine_kernel<<<a.b * a.hkv, kThreads, 0, stream>>>(
      f, static_cast<bf16*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace repro_torch

// Plain C entry for ctypes.  `pos` is a device pointer to the int64
// position, or null for `pos_value`.  Returns a cudaError_t.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* pos,
    void* scratch, int b, int s, int hkv, int g, int dh, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int ring, int windowed,
    int window, long long pos_value, float scale, int chunk, void* stream) {
  using namespace repro_torch;
  const bool strides16 = k_sb % kVec == 0 && k_ss % kVec == 0 &&
                         k_sh % kVec == 0 && v_sb % kVec == 0 &&
                         v_ss % kVec == 0 && v_sh % kVec == 0;
  if (b < 1 || s < 1 || hkv < 1 || g < 1 || g > kMaxGroup || dh % kVec ||
      dh < kVec || dh > kMaxHeadDim || chunk < 1 || chunk > kMaxChunk ||
      static_cast<long long>(b) * hkv > 65535 || !strides16 ||
      !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  int tpr = 1;
  while (tpr * kVec < dh) tpr *= 2;
  const DecodeArgs a{b,    s,    hkv,  g,    dh,       q_sb,      q_sh,
                     k_sb, k_ss, k_sh, v_sb, v_ss,     v_sh,      ring,
                     windowed, window, pos_value, scale, chunk,
                     (s + chunk - 1) / chunk, tpr};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: return launch_decode<1>(q, k, v, o, pos, scratch, a, st);
    case 2: return launch_decode<2>(q, k, v, o, pos, scratch, a, st);
    case 3: return launch_decode<3>(q, k, v, o, pos, scratch, a, st);
    case 4: return launch_decode<4>(q, k, v, o, pos, scratch, a, st);
    case 5: return launch_decode<5>(q, k, v, o, pos, scratch, a, st);
    case 6: return launch_decode<6>(q, k, v, o, pos, scratch, a, st);
    case 7: return launch_decode<7>(q, k, v, o, pos, scratch, a, st);
    default: return launch_decode<8>(q, k, v, o, pos, scratch, a, st);
  }
}
