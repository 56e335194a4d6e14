// Prefill flash attention for bf16 inputs on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA, with causal and sliding-window masks and GQA.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py for bf16 inputs (fp32 inputs
// take flash_attention.cu, split TF32 on mma.sync).  Same function: q
// (B,Hq,T,D), k and v (B,Hkv,S,D), the kv head of q head h is
// h / (Hq / Hkv); scores q.k * scale in fp32, masked where (causal and
// kj > qi) or (window and qi - kj >= window), their p 0, query row i at
// position qi = q_start + i (a rank's rows of a longer sequence; 0 for a
// whole one); online softmax
// with running m, l and acc in fp32; a fully masked row outputs 0; the
// output rounded once to bf16.  Tensors are addressed through their
// (b, h, t) element strides, so the model's (B,T,H,D) activations are
// read and written in place; d is contiguous, and every base pointer and
// (b, h, t) stride is a multiple of 16 bytes (the wrapper checks), as TMA
// requires.
//
// One deliberate difference from the TPU kernel.  It rounds p to bf16
// before p.v (`p.astype(v.dtype)`), as stock bf16 flash kernels do.  The
// port holds every bf16 output to within one rounding (2**-8 relative)
// of the fp32 function of its inputs; one bf16 rounding of p breaks that
// on 24% of the outputs at gemma3-4b's heads (B 1, H 2, T = S = 1536,
// D 256, causal, window none or 1024; fp16 on 1.2%), where an output
// near 0 is a sum of a few dominant terms.  Here p is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), both multiplied with the
// same v tile and summed into the same fp32 accumulators: p is kept to
// about 16 bits, and no output of that simulation breaks the bound.  It
// costs 1.5x the TPU kernel's tensor-core work; the bound still counts
// the function's 4*D flops per visible (q, k) pair.
//
// What bounds it on the card.  At the main path's shapes (gemma3-4b: B 4,
// Hq 8, Hkv 4, T = S = 1536, D 256) a head reads a few MB once and does
// hundreds of flops for each byte: it is bound by operations, at the
// bf16 tensor-core rate (989 TFLOP/s dense).
//
// What the design does about it.
// - Both products on the tensor cores with wgmma, fp32 accumulation:
//   s = q.k^T with q and k from shared memory (exact products, only the
//   order of the sum differs from the fp32 function), then o += p_hi.v
//   and o += p_lo.v with v as the n-major B operand.
// - One block of two warpgroups per (b, q head, 128-row q tile); each
//   warpgroup owns 64 rows end to end (wgmma's m), so the row max and sum
//   are shuffles within a quad of lanes.
// - TMA copies every tile: q once, k and v in tiles of 64 keys through a
//   ring of two stages, each with a `full` mbarrier (the bytes arrived)
//   and a `free` one (all 256 threads are done with it).  Thread 0 issues
//   the copies one step ahead, so the next k and v are in flight while
//   the block computes.  The tensor maps are 4-D (d, rows, heads, batch)
//   views with the tensors' own strides, encoded on the host at every
//   call; rows past T or S and the columns that pad d = 80 or 120 to 128
//   arrive as zeros from TMA's bounds check.  Tiles stay bf16 in
//   shared memory in the swizzled layout TMA writes and wgmma reads
//   without bank conflicts.
// - Within a warpgroup, s of the next kv tile and p.v of this one are
//   issued together; the warps turn s into p while p.v runs.  p stays in
//   registers (wgmma's register-operand form): the accumulator layout of
//   s is the register layout of p.v's a operand, so each pair of scores
//   becomes one register of p_hi and one of p_lo with no data movement.
//   The wgmma atoms are CuTe's (CUTLASS headers).
// - Only kv tiles inside the q tile's causal/window band are loaded, and
//   the per-element mask runs only on the tiles of a warp that cross the
//   diagonal, the window edge or S.
// - exp2 with scale * log2(e) folded into the scores: within fp32
//   rounding of exp.
// - The q tiles with the most keys under a causal mask start first: the
//   tile index runs backwards in the grid's slower axis, so the last wave
//   holds the short tiles.
// What it does not do yet: a producer warpgroup with register
// reallocation, and two warpgroups that take turns on the tensor cores
// (ROADMAP).
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>
#include <utility>

#include <cute/arch/mma_sm90_gmma.hpp>

#include "flash_attention.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;
namespace G = cute::SM90::GMMA;

// two warpgroups of 64 q rows each; thread 0 also issues every TMA load
constexpr int kThreads = 256;
constexpr int kBlockQ = 128;
constexpr int kBK = 64;     // keys of a kv tile
constexpr int kStages = 2;  // of the k and v ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoMax = -1e30f;  // the running max before any visible key

// Shared-memory tiles.  d is padded (DK) to a power of two up to 64 (16,
// 32 or 64: one swizzle atom of 32, 64 or 128 bytes) and above 64 to a
// multiple of 64 (whole 128-byte atoms: D 80 and 120 take 128); a tile
// of R rows is stored as TMA writes it with swizzling: [DK * 2 / kRow
// atoms][R rows][kRow bytes], kRow = 128 bytes (64 d) or the whole row
// when it is shorter, each row's 16-byte chunks permuted by the hardware
// (swizzle mode kRow), the layout wgmma reads without bank conflicts.
// The padding columns arrive as zeros from TMA's bounds check.
template <int D>
struct Tiles {
  static_assert(D % 8 == 0, "d in 16-byte chunks");
  static constexpr int kDepth = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64
                                : (D + 63) / 64 * 64;
  static constexpr int kRow = kDepth * 2 < 128 ? kDepth * 2 : 128;
  static constexpr int kAtoms = kDepth * 2 / kRow;
  static constexpr uint32_t kQBytes = kBlockQ * kDepth * 2;
  static constexpr uint32_t kKVBytes = kBK * kDepth * 2;
  // q, the stages of k and v, and room to align the base to 1024 bytes
  static constexpr int kBytes = kQBytes + 2 * kStages * kKVBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA -------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the one arrival of a phase, which then waits for `bytes` of TMA data
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins > (1u << 26)) __trap();  // a lost copy faults, not hangs
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box {c0 .. } of a 4-D tensor map -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------
// The operand descriptor of a swizzled tile (Tiles): start address,
// `lbo` the byte stride between atoms along n (n-major operands only),
// and 8 rows of kRow bytes between row groups.
template <int kRow>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t kMode = kRow == 128 ? 1 : kRow == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(8 * kRow >> 4) << 32) | (kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers an in-flight wgmma writes or reads: the compiler must not
// move their uses, or reuse them, across the wait (an empty asm that
// "redefines" them)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// CuTe's wgmma atoms, d (64 x N) += a (64 x 16) . b (16 x N) with bf16
// operands and fp32 accumulators: s = q.k^T with a and b k-major in
// shared memory, and o += p.v with a in registers and b n-major in
// shared memory, N = DK
using QkAtom = G::MMA_64x64x16_F32BF16BF16_SS<G::Major::K, G::Major::K>;
template <int N>
using PvAtom = std::conditional_t<
    N == 16, G::MMA_64x16x16_F32BF16BF16_RS<G::Major::K, G::Major::MN>,
    std::conditional_t<
        N == 32, G::MMA_64x32x16_F32BF16BF16_RS<G::Major::K, G::Major::MN>,
        std::conditional_t<
            N == 64,
            G::MMA_64x64x16_F32BF16BF16_RS<G::Major::K, G::Major::MN>,
            std::conditional_t<
                N == 128,
                G::MMA_64x128x16_F32BF16BF16_RS<G::Major::K, G::Major::MN>,
                G::MMA_64x256x16_F32BF16BF16_RS<G::Major::K,
                                                G::Major::MN>>>>>;

// the atom's fma on d[0 .. n): a and b from descriptors (= or += when
// `accumulate`), or a from four registers (+=)
template <class Atom, size_t... I>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                    bool accumulate,
                                    std::index_sequence<I...>) {
  Atom::fma(da, db, d[I]...,
            accumulate ? G::ScaleOut::One : G::ScaleOut::Zero);
}
template <class Atom, size_t... I>
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint64_t db, std::index_sequence<I...>) {
  Atom::fma(a[0], a[1], a[2], a[3], db, d[I]..., G::ScaleOut::One);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi), x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// s = q.k^T of one kv tile, issued (not waited for); q holds kBlockQ
// rows, of which this warpgroup's 64 start at `q_row0`
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_tile,
                                         int q_row0, uint32_t k_tile) {
  using Tl = Tiles<D>;
  constexpr int kRow = Tl::kRow;
  // opaque to the compiler: the descriptors are formed here, each time,
  // and not hoisted out of the kv loop into live registers
  asm volatile("" : "+r"(q_tile), "+r"(k_tile));
#pragma unroll
  for (int kd = 0; kd < Tl::kDepth / 16; ++kd) {
    const int atom = kd * 32 / kRow, at = kd * 32 % kRow;  // 16 d = 32 bytes
    const uint64_t da = gmma_desc<kRow>(
        q_tile + atom * (kBlockQ * kRow) + q_row0 * kRow + at, 16);
    const uint64_t db =
        gmma_desc<kRow>(k_tile + atom * (kBK * kRow) + at, 16);
    mma<QkAtom>(sc, da, db, kd > 0, std::make_index_sequence<kBK / 2>{});
  }
}

// o += p_hi.v + p_lo.v of one kv tile, issued (not waited for): p from
// registers (split_p), four of each part for each 16 keys; v the n-major
// B operand (k = keys, n = d)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[Tiles<D>::kDepth / 2],
                                         const uint32_t (&p_hi)[kBK / 4],
                                         const uint32_t (&p_lo)[kBK / 4],
                                         uint32_t v_tile) {
  using Tl = Tiles<D>;
  constexpr int kRow = Tl::kRow, DK = Tl::kDepth;
  asm volatile("" : "+r"(v_tile));  // as in issue_qk
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db =
        gmma_desc<kRow>(v_tile + kk * 16 * kRow, kBK * kRow);
    mma<PvAtom<DK>>(acc, p_hi + 4 * kk, db,
                    std::make_index_sequence<DK / 2>{});
    mma<PvAtom<DK>>(acc, p_lo + 4 * kk, db,
                    std::make_index_sequence<DK / 2>{});
  }
}

// scores of the kv tile at k0 -> p in place (masked where a pair is not
// visible, on tiles that cross an edge for this warp's rows, the first at
// position pos_w), the running max m and sums l updated; alpha rescales
// what was summed before
__device__ __forceinline__ void online_softmax(float (&sc)[kBK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const FlashShape& s, int k0,
                                               int pos_w, float c2) {
  const int g = threadIdx.x % 32 / 4, tq = threadIdx.x % 4;
  const bool edge = k0 + kBK > s.s || (s.causal && k0 + kBK - 1 > pos_w) ||
                    (s.use_window && pos_w + 15 - k0 >= s.window);
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    float x = sc[i] * c2;
    if (edge) {
      const int qi = pos_w + g + (i % 4 / 2) * 8;
      const int kj = k0 + i / 4 * 8 + 2 * tq + (i & 1);
      const bool ok = kj < s.s && !(s.causal && kj > qi) &&
                      !(s.use_window && qi - kj >= s.window);
      if (!ok) x = -INFINITY;
    }
    sc[i] = x;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows g and g + 8
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        sc[4 * n + e] = exp2f(sc[4 * n + e] - m_new);  // masked: 0
        sum += sc[4 * n + e];
      }
    l[r] = alpha[r] * l[r] + sum;
  }
}

// p of this thread's fragment -> p.v's A operand in registers, hi and lo
// bf16 parts.  The accumulator layout of s is the register layout of a:
// keys 16kk.. are s's n-tiles 2kk and 2kk + 1, so register 4kk + i
// holds the pair sc[8kk + 2i], sc[8kk + 2i + 1] (rows g, g + 8, g, g + 8)
__device__ __forceinline__ void split_p(const float (&sc)[kBK / 2],
                                        uint32_t (&p_hi)[kBK / 4],
                                        uint32_t (&p_lo)[kBK / 4]) {
#pragma unroll
  for (int i = 0; i < kBK / 4; ++i)
    split_bf16(sc[2 * i], sc[2 * i + 1], p_hi[i], p_lo[i]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          bf16* __restrict__ o, FlashShape s) {
  using Tl = Tiles<D>;
  constexpr int DK = Tl::kDepth, kRow = Tl::kRow;
  constexpr uint32_t kStage = Tl::kKVBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // q; k and v arrived in stage i (full), k and v of stage i consumed
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  // q [kBlockQ x DK], then k and v [kBK x DK] in each stage
  const uint32_t q_tile = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_tile = q_tile + Tl::kQBytes;
  const uint32_t v_tile = k_tile + kStages * kStage;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t free_k = full_v + 8 * kStages;
  const uint32_t free_v = free_k + 8 * kStages;

  const int n_qt = (s.t + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBlockQ;
  const int h = blockIdx.x % s.hq;
  const int b = blockIdx.x / s.hq;
  const int hk = h / (s.hq / s.hkv);

  // the kv range any row of this tile can see, in whole tiles from 0 (row
  // i at position q_start + i)
  const int q_last = min(q0 + kBlockQ, s.t) - 1;
  const int k_begin =
      (s.use_window ? max(0, s.q_start + q0 - s.window + 1) : 0) / kBK * kBK;
  const int k_end = s.causal ? min(s.s, s.q_start + q_last + 1) : s.s;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(full_k + 8 * i, 1);  // full_k, then full_v
      mbar_init(free_k + 8 * i, kThreads);  // free_k, then free_v
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // rows [row0, row0 + rows) of head `head` into a tile, atom by atom;
  // rows past the tensor's end arrive as zeros, and so do the columns that
  // pad d to DK
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar,
                  int rows, int row0, int head) {
    mbar_expect(bar, rows * DK * 2);
#pragma unroll
    for (int a = 0; a < Tl::kAtoms; ++a)
      tma_load(dst + a * rows * kRow, map, bar, a * (kRow / 2), row0, head,
               b);
  };
  // k_i or v_i into stage i % kStages once every thread has freed it; a
  // fresh barrier counts as freed (its phase before the first)
  auto produce = [&](const CUtensorMap* map, uint32_t tile, uint32_t full,
                     uint32_t free_, int i) {
    const int st = i % kStages;
    mbar_wait(free_ + 8 * st, ((i / kStages) & 1) ^ 1);
    load(map, tile + st * kStage, full + 8 * st, kBK, k_begin + i * kBK,
         hk);
  };
  if (threadIdx.x == 0 && n_kt > 0) {
    load(&map_q, q_tile, bar_q, kBlockQ, q0, h);
    produce(&map_k, k_tile, full_k, free_k, 0);
    if (n_kt > 1) produce(&map_k, k_tile, full_k, free_k, 1);
    produce(&map_v, v_tile, full_v, free_v, 0);
  }

  const int warp = threadIdx.x / 32, wg = warp / 4;
  const int g = threadIdx.x % 32 / 4;  // fragment rows g and g + 8
  const int tq = threadIdx.x % 4;      // fragment column pair
  float acc[DK / 2];  // o: n-tile j of 8 d at acc[4j .. 4j + 3]
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNoMax, kNoMax};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};        // this thread's part of the row sums
  const float c2 = s.scale * kLog2e;
  const int pos_w = s.q_start + q0 + warp * 16;  // the warp's first position
  const int q_row0 = wg * 64;        // the warpgroup's first row in q
  auto wait_full = [&](uint32_t full, int i) {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
  };
  float sc[kBK / 2], alpha[2];
  uint32_t p_hi[kBK / 4], p_lo[kBK / 4];  // the p that p.v reads
  // s of kv tile i (its k has landed) -> p in sc; alpha rescales the sums
  // before it
  auto scores_to_p = [&](int i) {
    fence_regs<kBK / 2>(sc);
    mbar_arrive(free_k + 8 * (i % kStages));
    online_softmax(sc, m, l, alpha, s, k_begin + i * kBK, pos_w, c2);
  };

  if (n_kt > 0) {  // p of the first tile
    mbar_wait(bar_q, 0);
    wait_full(full_k, 0);
    wgmma_fence();
    issue_qk<D>(sc, q_tile, q_row0, k_tile);
    wgmma_commit();
    wgmma_wait<0>();
    scores_to_p(0);
    split_p(sc, p_hi, p_lo);
  }
  // step j: p_j.v_j and s_{j+1} = q.k_{j+1} on the tensor cores; the
  // warps turn s_{j+1} into p_{j+1} while p.v runs
  for (int j = 0; j + 1 < n_kt; ++j) {
    if (threadIdx.x == 0) {  // v_{j+1} and k_{j+2}
      produce(&map_v, v_tile, full_v, free_v, j + 1);
      if (j + 2 < n_kt) produce(&map_k, k_tile, full_k, free_k, j + 2);
    }
    wait_full(full_k, j + 1);
    wait_full(full_v, j);
    wgmma_fence();
    issue_qk<D>(sc, q_tile, q_row0, k_tile + (j + 1) % kStages * kStage);
    wgmma_commit();
    issue_pv<D>(acc, p_hi, p_lo, v_tile + j % kStages * kStage);
    wgmma_commit();
    wgmma_wait<1>();  // s_{j+1}
    scores_to_p(j + 1);
    wgmma_wait<0>();  // p_j.v_j
    fence_regs<DK / 2>(acc);
    fence_regs<kBK / 4>(p_hi);
    fence_regs<kBK / 4>(p_lo);
    mbar_arrive(free_v + 8 * (j % kStages));
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e / 2];
    split_p(sc, p_hi, p_lo);
  }
  if (n_kt > 0) {  // the last tile's p.v
    const int j = n_kt - 1;
    wait_full(full_v, j);
    wgmma_fence();
    issue_pv<D>(acc, p_hi, p_lo, v_tile + j % kStages * kStage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DK / 2>(acc);
  }

  bf16* ob = o + b * s.osb + h * s.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(~0u, lr, 1);
    lr += __shfl_xor_sync(~0u, lr, 2);
    const int qi = pos_w - s.q_start + g + r * 8;
    if (qi >= s.t) continue;
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);  // masked row -> 0
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      if (D == DK || d < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * s.ost + d) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv,
                                  acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that the library needs no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The 4-D map (d, rows, heads, batch) of a bf16 tensor with element
// strides (row, head, batch), in boxes of (kRow / 2) d x box_rows rows.
// A dim of extent 1 may have any stride; it gets the packed one.
bool encode_map(CUtensorMap* map, const void* ptr, int d, int rows,
                int heads, int batch, long long rs, long long hs,
                long long bs, int row_bytes, int box_rows) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  if (rows == 1) rs = d;
  if (heads == 1) hs = rows * rs;
  if (batch == 1) bs = heads * hs;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(rs) * 2,
                           static_cast<cuuint64_t>(hs) * 2,
                           static_cast<cuuint64_t>(bs) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(row_bytes / 2),
                       static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const FlashShape& s, void* stream) {
  using Tl = Tiles<D>;
  auto kern = flash_attention_tc_kernel<D>;
  // above 48 KB only after opting in, once a device (common.cuh)
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in_shared_memory(kern, Tl::kBytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (s.t + kBlockQ - 1) / kBlockQ;
  const long long bh = static_cast<long long>(s.b) * s.hq;
  if (bh > 0x7fffffffLL || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, D, s.t, s.hq, s.b, s.qst, s.qsh, s.qsb, Tl::kRow,
                  kBlockQ))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s.s == 0) {  // no keys: every row is 0 and k and v are never read
    mk = mv = mq;
  } else if (!encode_map(&mk, k, D, s.s, s.hkv, s.b, s.kst, s.ksh, s.ksb,
                         Tl::kRow, kBK) ||
             !encode_map(&mv, v, D, s.s, s.hkv, s.b, s.vst, s.vsh, s.vsb,
                         Tl::kRow, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(bh), n_qt);
  kern<<<grid, kThreads, Tl::kBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int d,
                const FlashShape& s, void* stream) {
  switch (d) {
    case 16: return launch_tc<16>(q, k, v, o, s, stream);
    case 32: return launch_tc<32>(q, k, v, o, s, stream);
    case 64: return launch_tc<64>(q, k, v, o, s, stream);
    case 80: return launch_tc<80>(q, k, v, o, s, stream);
    case 120: return launch_tc<120>(q, k, v, o, s, stream);
    case 128: return launch_tc<128>(q, k, v, o, s, stream);
    case 256: return launch_tc<256>(q, k, v, o, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

REPRO_FLASH_ENTRY(flash_attention_bf16, repro_torch::dispatch_tc)
