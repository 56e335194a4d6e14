// Prefill flash attention with causal and sliding-window masks and GQA,
// fp32 inputs, written by hand for Hopper (sm_90a).  The bf16 path is
// flash_attention_sm90.cu, on the tensor cores.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py for fp32 inputs.  Same function:
// q (B,Hq,T,D), k and v (B,Hkv,S,D), the kv head of q head h is
// h / (Hq / Hkv); scores q.k * scale in fp32, masked where (causal and
// kj > qi) or (window and qi - kj >= window) to -1e30 with their p forced
// to 0; online softmax with running m, l and acc in fp32; a fully masked
// row outputs 0.  Tensors are addressed through their (b, h, t) element
// strides, so the model's (B,T,H,D) activations are read and written in
// place, without a transposed copy; d is contiguous.
//
// What bounds it on the card.  Attention does hundreds of flops per byte
// it must read, far above the H100's ridge point, so it is bound by
// operations.  This kernel keeps fp32 arithmetic outside the tensor cores
// (67 TFLOP/s): TF32 tensor cores keep about 10 bits, short of the JAX
// suite's fp32 tolerance of 2e-5.
//
// What the design does about it.  This is the simple kernel that is
// right.  The TPU kernel's sequential kv grid axis, with m/l/acc in VMEM
// scratch, becomes a loop over kv tiles inside one block; nothing is
// carried between blocks.  One block of 8 warps per (b, q head, 32-row
// q tile).  The q tile and each 32-key k and v tile are staged in shared
// memory (k and q rows padded by one word, so that the 32 lanes
// reading 32 keys at one d hit 32 banks).  Each warp owns 4 q rows end
// to end: lane j scores key j of the tile for its 4 rows, the row max
// and row sum are warp shuffles, and p is broadcast by shuffle for the
// p.v product, where lane l accumulates d = l, l + 32, ... of its 4 rows
// in registers.  So the only block-wide barriers are around the tile
// loads.  kv tiles wholly outside the causal/window band of the q tile
// are skipped: they would add p = 0 and leave m unchanged, so the result
// is the same function.  Ragged T and S are masked at the edge.
#include "flash_attention.cuh"

namespace repro_torch {
namespace {

constexpr int kFlashWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kFlashWarps * kRowsPerWarp;  // 32 q rows a block
constexpr int kBlockK = 32;                           // one key a lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

template <int D>
constexpr int smem_bytes() {
  // q tile and k tile with rows padded to D + 1 words, v tile unpadded
  return (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       FlashShape s) {
  constexpr int DP = D + 1;
  constexpr int DC = (D + 31) / 32;  // d values a lane owns
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockQ][DP]
  float* ks = qs + kBlockQ * DP;       // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;       // [kBlockK][D]

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (s.hq / s.hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* qb = q + b * s.qsb + h * s.qsh;
  const float* kb = k + b * s.ksb + hk * s.ksh;
  const float* vb = v + b * s.vsb + hk * s.vsh;
  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[r * DP + d] = qi < s.t ? qb[qi * s.qst + d] : 0.f;
  }

  // the kv range any row of this tile can see
  const int q_last = min(q0 + kBlockQ, s.t) - 1;
  const int k_begin = s.use_window ? max(0, q0 - s.window + 1) : 0;
  const int k_end = s.causal ? min(s.s, q_last + 1) : s.s;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      const bool in = kj < s.s;
      ks[j * DP + d] = in ? kb[kj * s.kst + d] : 0.f;
      vs[j * D + d] = in ? vb[kj * s.vst + d] : 0.f;
    }
    __syncthreads();

    // scores: lane = key j of the tile, for the warp's 4 rows
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* kr = ks + lane * DP;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        sc[r] = fmaf(qs[(row0 + r) * DP + d], kv, sc[r]);
    }

    const int kj = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      bool ok = kj < k_end;
      if (s.causal) ok = ok && kj <= qi;
      if (s.use_window) ok = ok && (qi - kj) < s.window;
      const float x = ok ? sc[r] * s.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      p[r] = ok ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }

    // p.v: lane owns d = lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = (D % 32 == 0 || d < D) ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(~0u, p[r], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

  float* ob = o + b * s.osb + h * s.osh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= s.t) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // masked row -> 0
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (D % 32 == 0 || d < D) ob[qi * s.ost + d] = acc[r][c] * inv;
    }
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const FlashShape& s, void* stream) {
  constexpr int bytes = smem_bytes<D>();
  auto kern = flash_attention_kernel<D>;
  // above 48 KB only after opting in; once, at the first (uncaptured)
  // launch, so a launch inside a CUDA graph capture only enqueues
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((s.t + kBlockQ - 1) / kBlockQ, s.hq, s.b);
  kern<<<grid, kFlashWarps * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_flash(const void* q, const void* k, const void* v, void* o,
                   int d, const FlashShape& s, void* stream) {
  switch (d) {
    case 16: return launch_flash<16>(q, k, v, o, s, stream);
    case 32: return launch_flash<32>(q, k, v, o, s, stream);
    case 64: return launch_flash<64>(q, k, v, o, s, stream);
    case 80: return launch_flash<80>(q, k, v, o, s, stream);
    case 120: return launch_flash<120>(q, k, v, o, s, stream);
    case 128: return launch_flash<128>(q, k, v, o, s, stream);
    case 256: return launch_flash<256>(q, k, v, o, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

REPRO_FLASH_ENTRY(flash_attention_f32, repro_torch::dispatch_flash)
