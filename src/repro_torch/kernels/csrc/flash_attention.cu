// Prefill flash attention with causal and sliding-window masks and GQA,
// fp32 inputs, on Hopper's tensor cores as split TF32 (sm_90a).  The bf16
// path is flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py for fp32 inputs.  Same function:
// q (B,Hq,T,D), k and v (B,Hkv,S,D), the kv head of q head h is
// h / (Hq / Hkv); scores q.k * scale in fp32, masked where (causal and
// kj > qi) or (window and qi - kj >= window) to -1e30 with their p forced
// to 0, query row i at position qi = q_start + i (a rank's rows of a
// longer sequence; 0 for a whole one); online softmax with running m, l
// and acc in fp32; a fully masked row outputs 0.  Tensors are addressed through their (b, h, t) element
// strides, so the model's (B,T,H,D) activations are read and written in
// place, without a transposed copy; d is contiguous, and every base
// pointer and (b, h, t) stride is a multiple of 16 bytes (the wrapper
// checks), for the 16-byte copies.
//
// What bounds it on the card.  Attention does hundreds of flops per byte
// it must read, far above the H100's ridge point, so it is bound by
// operations.  fp32 FMA outside the tensor cores runs at 67 TFLOP/s.  One
// TF32 product (11 significant bits) misses the fp32 tolerance of 2e-5
// (about 9e-4 at T = S = 1536), so both products run as split TF32: each
// fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest, ties away (cvt.rna.tf32.f32's rounding, done with
// an integer add and mask, which equals it on finite values), and a.b
// becomes lo_a.hi_b + hi_a.lo_b + hi_a.hi_b on the tensor cores with fp32
// accumulators (lo.lo dropped): 2**-22 of each operand is left, and a
// numpy emulation of this arithmetic (tests/test_torch_flash_fp32_split.py)
// stays within a tenth of the tolerance.  Three TF32 products at 495
// TFLOP/s make 165 TFLOP/s of fp32-class products, 2.5x the FMA rate.
//
// What the design does about it.
// - mma.sync.m16n8k8 in TF32.  One block of 4 warps per (b, q head,
//   64-row q tile); each warp owns 16 rows end to end (mma's m), so the
//   row max and sum are shuffles within a quad of lanes.
// - The split happens in registers, on fragments loaded from shared
//   memory: the tiles stay raw fp32, one copy each.  q.k^T keeps hi.hi
//   and the two corrections in two accumulators per 8 keys, so each warp
//   has twice as many independent mma chains in flight.
// - No data moves between the two products.  A k8 step may take its 8
//   inputs in any order, as long as both operands agree.  q.k^T's step
//   takes d = 2t and 2t + 1 as its columns t and t + 4, so each lane loads
//   a float2 of q and of k; p.v's step takes keys 2t and 2t + 1 as its
//   columns t and t + 4, which is where the accumulator fragment of q.k^T
//   already holds them, so p is its own a operand (v's rows 2t and 2t + 1
//   are loaded to match).  Rows are padded in shared memory so that every
//   fragment load is free of bank conflicts: q and k rows to 8 mod 16
//   words (float2 loads), v rows to 4 mod 8 words (rows 2t of 8 lanes).
// - k and v tiles arrive by cp.async, 16 bytes a thread, through a ring
//   of two stages: the next tile is in flight while this one computes.
//   Rows past T or S arrive as zeros.
// - The key tile depends on D (Tiles<D>::kBK), so that the q tile, two
//   stages of k and v and the padding fit two blocks an SM (one at D
//   256).  Shared memory a block: D 16: 28,672 bytes; 32: 49,152; 64:
//   90,112; 80: 110,592 (64 keys a tile); 120: 93,184; 128: 103,424;
//   256: 201,728 (32 keys).
// - kv tiles wholly outside the causal/window band of the q tile are not
//   loaded: they would add p = 0 and leave m unchanged, so the result is
//   the same function.  A warp skips a tile none of its rows sees, and
//   masks element by element only the tiles that cross the diagonal, the
//   window's edge or S.  Ragged T and S are masked at the edge.
// - exp2 with log2(e) folded in by one fma on the scaled score: within
//   fp32 rounding of exp.
// - The q tiles with the most keys under a causal mask start first.
// What it does not do yet: wgmma in TF32.  mma.sync reaches 325 of the
// H100's 495 TF32 TFLOP/s (tools/mma_rate_torch.py), which caps this form
// at 108 TFLOP/s of the function; wgmma needs both operands k-major in
// shared memory, so v would be transposed there (one split pass could
// write v_hi^T and v_lo^T); ROADMAP Queue 2.
#include <type_traits>

#include "flash_attention.cuh"

namespace repro_torch {
namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A block's warps and tiles per head dim, and its shared memory in
// floats: the q tile [kBlockQ][kQK] and two stages of a k tile
// [kBK][kQK] followed by a v tile [kBK][kV].  flash_attention_f32_tiles
// reports the q and key tiles.
template <int D>
struct Tiles {
  static_assert(D % 8 == 0, "d in k8 steps and 16-byte chunks");
  static constexpr int kWarps = 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBlockQ = kWarps * 16;  // 16 rows a warp (mma's m)
  static constexpr int kBK = D <= 80 ? 64 : 32;
  static constexpr int kQK = D % 16 == 0 ? D + 8 : D;  // 8 mod 16 words
  static constexpr int kV = D + 4;                      // 4 mod 8 words
  static constexpr int kStage = kBK * (kQK + kV);
  static constexpr int kBytes = (kBlockQ * kQK + 2 * kStage) * 4;
  // two blocks an SM where both fit its 228 KB (1 KB reserved a block)
  static constexpr int kMinBlocks = 2 * (kBytes + 1024) <= 233472 ? 2 : 1;
};

// cvt.rna.tf32.f32 on finite values: round the 13 bits TF32 drops to the
// nearest, ties away from zero, and clear them
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to 2**-22 of x: hi = tf32(x), lo = tf32(x - hi), both
// rounded to nearest.  lo keeps its low 13 bits: the tensor cores read
// the top 19 bits of a TF32 operand and drop the rest, so the add alone
// makes it tf32(x - hi) there (as CUTLASS's 3xTF32 rounds its small
// part).  hi is masked, since x - hi must be exact.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c (16 x 8) += a (16 x 8) . b (8 x 8), TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) of an (n', D) matrix with row stride `ld` into
// shared memory with row stride `stride`; rows at or past `n` as zeros
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, long long ld,
                                          int row0, int rows, int n) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n;
    const float* from = src + (in ? row0 + r : 0) * ld + c * 4;
    cp_async16(dst + r * stride + c * 4, from, in);
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::kThreads, Tiles<D>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       FlashShape s) {
  using T = Tiles<D>;
  constexpr int BK = T::kBK, QK = T::kQK, VS = T::kV, kBlockQ = T::kBlockQ;
  constexpr int NK = BK / 8;  // n tiles of the scores, k8 steps of p.v
  constexpr int ND = D / 8;   // k8 steps of q.k^T, n tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* stages = qs + kBlockQ * QK;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (s.hq / s.hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // the fragment's row and column
  const int r0 = warp * 16;

  const float* qb = q + b * s.qsb + h * s.qsh;
  const float* kb = k + b * s.ksb + hk * s.ksh;
  const float* vb = v + b * s.vsb + hk * s.vsh;

  // the kv range any row of this tile can see (row i at position
  // q_start + i)
  const int q_last = min(q0 + kBlockQ, s.t) - 1;
  const int k_begin =
      s.use_window ? max(0, s.q_start + q0 - s.window + 1) : 0;
  const int k_end = s.causal ? min(s.s, s.q_start + q_last + 1) : s.s;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_tile = [&](int it) {
    float* ks = stages + (it & 1) * T::kStage;
    const int k0 = k_begin + it * BK;
    load_rows<D, T::kThreads>(ks, QK, kb, s.kst, k0, BK, s.s);
    load_rows<D, T::kThreads>(ks + BK * QK, VS, vb, s.vst, k0, BK, s.s);
  };
  load_rows<D, T::kThreads>(qs, QK, qb, s.qst, q0, kBlockQ, s.t);
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // the positions of the warp's first row and of its last (< pw0 if it
  // has none)
  const int pw0 = s.q_start + q0 + r0;
  const int pw_last = s.q_start + min(q0 + r0 + 15, s.t - 1);
  const float* qw = qs + r0 * QK;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it (and q)
    __syncthreads();
    const float* ks = stages + (it & 1) * T::kStage;
    const float* vs = ks + BK * QK;
    const int k0 = k_begin + it * BK;
    const int k_last = min(k0 + BK, s.s) - 1;
    // does some row of the warp see some key of the tile, and all of them?
    const bool any = pw_last >= pw0 && (!s.causal || k0 <= pw_last) &&
                     (!s.use_window || pw0 - k_last < s.window);
    if (any) {
      const bool full = k0 + BK <= s.s &&
                        (!s.causal || k0 + BK - 1 <= pw0) &&
                        (!s.use_window || pw0 + 15 - k0 < s.window);
      // scores: hi.hi and the corrections in two accumulators
      float sc[NK][4], sx[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[n][j] = sx[n][j] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D; kk += 8) {
        const float2 x0 =
            *reinterpret_cast<const float2*>(qw + g * QK + kk + 2 * tq);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qw + (g + 8) * QK + kk + 2 * tq);
        uint32_t ah[4], al[4];
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(
              ks + (n * 8 + g) * QK + kk + 2 * tq);
          uint32_t bh[2], bl[2];
          split(y.x, bh[0], bl[0]);
          split(y.y, bh[1], bl[1]);
          mma(sx[n], al, bh[0], bh[1]);
          mma(sx[n], ah, bl[0], bl[1]);
          mma(sc[n], ah, bh[0], bh[1]);
        }
      }

      // online softmax; element j of n tile n is row g + 8 (j / 2) (at
      // position pw0 + g + 8 (j / 2)), key k0 + 8 n + 2 tq + (j % 2)
      uint32_t ok = ~0u;  // bit 4 n + j: visible
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = (sc[n][j] + sx[n][j]) * s.scale;
          if (!full) {
            const int qi = pw0 + g + 8 * (j / 2);
            const int kj = k0 + 8 * n + 2 * tq + (j % 2);
            const bool vis = kj < s.s && (!s.causal || kj <= qi) &&
                             (!s.use_window || qi - kj < s.window);
            if (!vis) {
              x = kNegInf;
              ok &= ~(1u << (4 * n + j));
            }
          }
          sc[n][j] = x;
          mx[j / 2] = fmaxf(mx[j / 2], x);
        }
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
        // p of the last tile was taken against m * log2(e) rounded once
        ms[r] = __fmul_rn(mx[r], kLog2e);
        alpha[r] = exp2f(__fmul_rn(m[r], kLog2e) - ms[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = (ok >> (4 * n + j)) & 1u
                              ? exp2f(fmaf(sc[n][j], kLog2e, -ms[j / 2]))
                              : 0.f;
          sc[n][j] = p;
          l[j / 2] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // o += p.v: the scores' fragment of n tile j is p's a operand
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t ah[4], al[4];
        split(sc[j][0], ah[0], al[0]);
        split(sc[j][2], ah[1], al[1]);
        split(sc[j][1], ah[2], al[2]);
        split(sc[j][3], ah[3], al[3]);
        const float* v0 = vs + (j * 8 + 2 * tq) * VS + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh[2], bl[2];
          split(v0[n * 8], bh[0], bl[0]);
          split(v0[VS + n * 8], bh[1], bl[1]);
          mma(acc[n], al, bh[0], bh[1]);
          mma(acc[n], ah, bl[0], bl[1]);
          mma(acc[n], ah, bh[0], bh[1]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  float* ob = o + b * s.osb + h * s.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(~0u, sum, 1);
    sum += __shfl_xor_sync(~0u, sum, 2);
    const float inv = 1.f / (sum == 0.f ? 1.f : sum);  // masked row -> 0
    const int qi = pw0 - s.q_start + g + 8 * r;
    if (qi >= s.t) continue;
    float* orow = ob + qi * s.ost + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 const FlashShape& s, void* stream) {
  using T = Tiles<D>;
  constexpr int bytes = T::kBytes;
  auto kern = flash_attention_kernel<D>;
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in_shared_memory(kern, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.t + T::kBlockQ - 1) / T::kBlockQ, s.hq, s.b);
  kern<<<grid, T::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, d>{}) for a head dim the kernel takes
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 120: return f(std::integral_constant<int, 120>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_flash(const void* q, const void* k, const void* v, void* o,
                   int d, const FlashShape& s, void* stream) {
  return with_head_dim(d, [&](auto dim) {
    return launch_flash<decltype(dim)::value>(q, k, v, o, s, stream);
  });
}

}  // namespace
}  // namespace repro_torch

REPRO_FLASH_ENTRY(flash_attention_f32, repro_torch::dispatch_flash)

// A block's q rows and a kv tile's keys at head dim d: the tiles that the
// numpy emulation of this kernel (tests/test_torch_flash_fp32_split.py)
// must take.  Returns cudaErrorInvalidValue for a head dim not compiled.
extern "C" int flash_attention_f32_tiles(int d, int* block_q, int* key_tile) {
  return repro_torch::with_head_dim(d, [&](auto dim) {
    using T = repro_torch::Tiles<decltype(dim)::value>;
    *block_q = T::kBlockQ;
    *key_tile = T::kBK;
    return 0;
  });
}
