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
// state is fp32 throughout.  Any N up to 128 and any M.
//
// What bounds it on the card.  Each step does 5*N*M flops per head
// against (3N + 2M) inputs and outputs.  At the main path's shape
// (rwkv6-7b: B 4, T 1536, H 64, N = M = 64, fp32) one launch moves about
// 512 MB, 0.153 ms at 3.35 TB/s, and executes 3 fp32 instructions per
// state element and step (a multiply and two fmas), about 0.16 ms on the
// fp32 lanes: bytes and arithmetic lie close together.  The recurrence is
// sequential in T, but only through each state element's own fma; y_t
// feeds nothing, so steps overlap once their inputs are on chip.
//
// What the design does about it.
// - The TPU kernel's sequential chunk grid axis, with the state in VMEM
//   scratch, becomes a loop over T inside one block; nothing is carried
//   between blocks.  One block of 128 threads per (b, h, 64-column tile of
//   M).
// - The rows of a state column are split across a group of G = 4 lanes,
//   and each lane keeps C = 2 columns: R = ceil(N / 4) rows (padded to 1,
//   2, 4, 8, 16 or 32) of two columns in registers for the whole
//   sequence.  So y_t is a chain of R fmas a column and lane, not one
//   chain of N, one set of decay, k and r loads serves two columns, and
//   the card holds twice the warps of one lane per column.  The four
//   lanes sum their partial columns by recursive halving (two shuffles),
//   in the order (p0 + p1) + (p2 + p3), and each column's y is stored by
//   one lane.  Each state element is updated by the same
//   fmaf(decay, s, k * v) as before, so the final state is bitwise that
//   of one lane per column; only the order of y's sum changes (within
//   fp32 rounding of a sum of N terms).
// - The four lanes of a group sit in the four quarters of a warp (lane =
//   8 * group + lane column), so each quarter reads one broadcast address;
//   the groups' rows are skewed by 16 bytes in shared memory, so the four
//   addresses of a 16-byte load fall in four different sets of banks.
// - No load is on the step's path.  decay, k and r of a chunk of 32 steps
//   and this block's v tile for those steps are copied into shared memory
//   by cp.async (16 bytes a thread) into a ring of two stages: the next
//   chunk's copy runs while this chunk's steps run.  Rows or columns that
//   are not whole 16-byte chunks, or unaligned pointers, take plain loads
//   into the same ring instead (any N, any M, bf16 with odd N).
// - y is staged per chunk in shared memory and written with coalesced
//   16-byte stores (plain stores where the 16-byte path does not apply).
// - What sets the time now (scratch variants on the card): the fp32 work
//   of the step itself.  Dropping the shared-memory loads or the
//   shuffles barely moves it, dropping the y products moves it most, the
//   copies' instructions and the chunk barriers a little.  One lane per
//   column, four columns a lane, or an unrolled step loop were no faster.
// - A parallel-in-T (chunked) form is not used: RWKV6's decays
//   exp(-exp(w)) make the ratios of decay products it needs underflow
//   fp32 within a few steps.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kGroup = 4;   // lanes sharing the rows of a state column
constexpr int kCols = 2;    // state columns a lane keeps
constexpr int kTile = 64;   // state columns a block
constexpr int kChunk = 32;  // steps staged at once
constexpr int kStages = 2;  // of the ring of chunks
constexpr int kWarpCols = 32 / kGroup;  // lane columns a warp
constexpr int kScanThreads = kTile / kCols * kGroup;
constexpr int kMaxStateDim = 128;  // N; the wrapper's MAX_STATE_DIM

struct ScanShape {
  int b, t, h, n, m;
};

// The shared-memory layout of a chunk, in elements of T.  One step of
// decay (or k, or r) is kGroup blocks of R rows, each block followed by
// a 16-byte skew when R rows are whole 16-byte chunks (the four groups'
// loads then hit four different sets of banks); v is a row of kTile
// columns a step.
template <typename T, int R>
struct Ring {
  static constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int kSkew = R % kVec == 0 ? kVec : 0;
  static constexpr int kBlock = R + kSkew;       // between two groups' rows
  static constexpr int kStep = kGroup * kBlock;  // one step of one input
  static constexpr int kV = 3 * kChunk * kStep;  // v's offset in a stage
  static constexpr int kStage = kV + kChunk * kTile;
  static constexpr int kBytes = kStages * kStage * sizeof(T);
  // whether a step's rows and a stage start on 16-byte boundaries, as the
  // 16-byte copies need
  static constexpr bool kAligned = kStep * sizeof(T) % 16 == 0;
  __device__ static int row(int n) { return n / R * kBlock + n % R; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(row, j) for every cell of a rows x per grid, cells dealt to the
// block's threads in turn (the index advances by the block's size
// without a division per cell)
template <int kThreads, class F>
__device__ __forceinline__ void for_cells(int rows, int per, F f) {
  if (per <= 0) return;
  const int dq = kThreads / per, dr = kThreads - dq * per;
  int row = threadIdx.x / per, j = threadIdx.x - row * per;
  while (row < rows) {
    f(row, j);
    row += dq;
    j += dr;
    if (j >= per) {
      j -= per;
      ++row;
    }
  }
}

// R consecutive elements of shared memory as fp32, in 16-, 8- or 4-byte
// loads as R allows (the callers' offsets keep them aligned)
template <typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, float (&out)[R]) {
  if constexpr (std::is_same_v<T, float> && R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = q.x;
      out[4 * i + 1] = q.y;
      out[4 * i + 2] = q.z;
      out[4 * i + 3] = q.w;
    }
  } else if constexpr (std::is_same_v<T, float> && R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(p)[i];
      out[2 * i] = q.x;
      out[2 * i + 1] = q.y;
    }
  } else if constexpr (std::is_same_v<T, __nv_bfloat16> && R % 8 == 0) {
#pragma unroll
    for (int i = 0; i < R / 8; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        out[8 * i + 2 * j] = f.x;
        out[8 * i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (std::is_same_v<T, __nv_bfloat16> && R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const float2 f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = to_f32(p[i]);
  }
}

// kVec fp32 values of shared memory -> 16 bytes of T in global memory
__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* src) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// y of the two columns of a state-column group: p[j] is this lane's part
// (its R rows) of column j.  The kGroup lanes of the group (the lane bits
// above the lane column) sum their parts by recursive halving: the first
// shuffle leaves lanes of even group with column 0 of their pair of
// groups, of odd group with column 1; each further shuffle adds the
// neighbouring pairs, quads, ....  So column `col` = g & 1 is summed as
// the pairwise tree ((p0 + p1) + (p2 + p3)) + ... over the groups (a
// float add commutes exactly), and every lane of the same parity holds
// the same column.
__device__ __forceinline__ float group_sum(const float (&p)[kCols], int g,
                                           int& col) {
  static_assert(kCols == 2, "two columns a lane");
  const bool odd = g & 1;
  col = odd;
  float q = (odd ? p[1] : p[0]) +
            __shfl_xor_sync(~0u, odd ? p[0] : p[1], kWarpCols);
#pragma unroll
  for (int o = 2 * kWarpCols; o < 32; o <<= 1)
    q += __shfl_xor_sync(~0u, q, o);
  return q;
}

template <typename T, int R>
__global__ void __launch_bounds__(kScanThreads)
linear_scan_kernel(const T* __restrict__ decay, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ r,
                   const float* __restrict__ s0, T* __restrict__ y,
                   float* __restrict__ s_final, ScanShape s, int vec) {
  using L = Ring<T, R>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(16) float ys[kChunk][kTile];

  const int lane = threadIdx.x % 32;
  const int g = lane / kWarpCols;  // this lane's group: rows g*R ..
  // this lane's first column in the tile, of kCols
  const int c0 =
      (threadIdx.x / 32 * kWarpCols + lane % kWarpCols) * kCols;
  const int m0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int cols = min(kTile, s.m - m0);
  const int n0 = g * R;

  const long long state0 =
      (static_cast<long long>(b) * s.h + h) * s.n * s.m + m0 + c0;
  float st[R][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      st[i][j] = c0 + j < cols && n0 + i < s.n
                     ? s0[state0 + static_cast<long long>(n0 + i) * s.m + j]
                     : 0.f;

  // rows past N stay zero in every stage: no copy writes them, so the
  // padded state rows stay 0 and add nothing to y
  if (s.n < kGroup * R) {
    for (int i = threadIdx.x; i < L::kBytes / 4; i += kScanThreads)
      reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
    __syncthreads();
  }

  // chunk ci (steps t0 .. t0 + steps) of decay, k, r and v into its stage
  auto stage_chunk = [&](int ci) {
    const int t0 = ci * kChunk, steps = min(kChunk, s.t - t0);
    T* const stage = ring + (ci % kStages) * L::kStage;
    const long long at0 = (static_cast<long long>(b) * s.t + t0) * s.h + h;
    const long long hn = static_cast<long long>(s.h) * s.n;
    const long long hm = static_cast<long long>(s.h) * s.m;
    const T* const src[3] = {decay, k, r};
    if (vec) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T* const dst = stage + a * kChunk * L::kStep;
        const T* const from = src[a] + at0 * s.n;
        for_cells<kScanThreads>(steps, s.n / kVec, [&](int tt, int j) {
          cp_async16(dst + tt * L::kStep + L::row(j * kVec),
                     from + tt * hn + j * kVec);
        });
      }
      const T* const from = v + at0 * s.m + m0;
      for_cells<kScanThreads>(steps, cols / kVec, [&](int tt, int j) {
        cp_async16(stage + L::kV + tt * kTile + j * kVec,
                   from + tt * hm + j * kVec);
      });
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T* const dst = stage + a * kChunk * L::kStep;
        const T* const from = src[a] + at0 * s.n;
        for_cells<kScanThreads>(steps, s.n, [&](int tt, int n) {
          dst[tt * L::kStep + L::row(n)] = from[tt * hn + n];
        });
      }
      const T* const from = v + at0 * s.m + m0;
      for_cells<kScanThreads>(steps, cols, [&](int tt, int j) {
        stage[L::kV + tt * kTile + j] = from[tt * hm + j];
      });
    }
    cp_async_commit();
  };

  const int n_chunks = (s.t + kChunk - 1) / kChunk;
  stage_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kChunk, steps = min(kChunk, s.t - t0);
    if (ci + 1 < n_chunks) {  // the next chunk flies while this one runs
      stage_chunk(ci + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of chunk ci have landed
    const T* const stage = ring + (ci % kStages) * L::kStage;
    const T* const ds = stage + g * L::kBlock;
    const T* const ks = ds + kChunk * L::kStep;
    const T* const rs = ks + kChunk * L::kStep;
    const T* const vs = stage + L::kV + c0;
    for (int tt = 0; tt < steps; ++tt) {
      float dv[R], kv[R], rv[R], vt[kCols], part[kCols];
      load_rows<T, R>(ds + tt * L::kStep, dv);
      load_rows<T, R>(ks + tt * L::kStep, kv);
      load_rows<T, R>(rs + tt * L::kStep, rv);
      load_rows<T, kCols>(vs + tt * kTile, vt);
#pragma unroll
      for (int j = 0; j < kCols; ++j) part[j] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(dv[i], st[i][j], kv[i] * vt[j]);
          part[j] = fmaf(rv[i], st[i][j], part[j]);
        }
      int col;
      const float out = group_sum(part, g, col);
      if (g < 2) ys[tt][c0 + col] = out;  // other groups: the same columns
    }
    __syncthreads();  // y of the chunk is staged; stage ci % 2 is free
    T* const yb =
        y + ((static_cast<long long>(b) * s.t + t0) * s.h + h) * s.m + m0;
    const long long hm = static_cast<long long>(s.h) * s.m;
    if (vec) {
      for_cells<kScanThreads>(steps, cols / kVec, [&](int tt, int j) {
        store16(yb + tt * hm + j * kVec, &ys[tt][j * kVec]);
      });
    } else {
      for_cells<kScanThreads>(steps, cols, [&](int tt, int j) {
        yb[tt * hm + j] = from_f32<T>(ys[tt][j]);
      });
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (c0 + j < cols && n0 + i < s.n)
        s_final[state0 + static_cast<long long>(n0 + i) * s.m + j] =
            st[i][j];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int R>
int launch_scan(const void* decay, const void* k, const void* v,
                const void* r, const void* s0, void* y, void* s_final,
                const ScanShape& s, void* stream) {
  using L = Ring<T, R>;
  auto kern = linear_scan_kernel<T, R>;
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in_shared_memory(kern, L::kBytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the 16-byte copies and stores: whole 16-byte chunks in every row and
  // column tile, and every pointer they touch aligned
  const int vec = L::kAligned && s.n * sizeof(T) % 16 == 0 &&
                  s.m * sizeof(T) % 16 == 0 && aligned16(decay) &&
                  aligned16(k) && aligned16(v) && aligned16(r) && aligned16(y);
  const dim3 grid((s.m + kTile - 1) / kTile, s.h, s.b);
  kern<<<grid, kScanThreads, L::kBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(decay), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(r),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_final), s, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_scan(const void* decay, const void* k, const void* v,
                  const void* r, const void* s0, void* y, void* s_final,
                  const ScanShape& s, void* stream) {
  // R = ceil(N / kGroup) rounded up to a power of two: state rows a lane
  // keeps
  const int rows = (s.n + kGroup - 1) / kGroup;
  if (s.n < 1 || s.n > kMaxStateDim || s.h > 65535 || s.b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 1) return launch_scan<T, 1>(decay, k, v, r, s0, y, s_final, s, stream);
  if (rows <= 2) return launch_scan<T, 2>(decay, k, v, r, s0, y, s_final, s, stream);
  if (rows <= 4) return launch_scan<T, 4>(decay, k, v, r, s0, y, s_final, s, stream);
  if (rows <= 8) return launch_scan<T, 8>(decay, k, v, r, s0, y, s_final, s, stream);
  if (rows <= 16) return launch_scan<T, 16>(decay, k, v, r, s0, y, s_final, s, stream);
  return launch_scan<T, 32>(decay, k, v, r, s0, y, s_final, s, stream);
}

}  // namespace
}  // namespace repro_torch

// Plain C entries for ctypes.
#define REPRO_SCAN_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* decay, const void* k, const void* v,      \
                      const void* r, const void* s0, void* y,               \
                      void* s_final, int b, int t, int h, int n, int m,     \
                      void* stream) {                                       \
    const repro_torch::ScanShape s{b, t, h, n, m};                          \
    return repro_torch::dispatch_scan<T>(decay, k, v, r, s0, y, s_final, s, \
                                         stream);                           \
  }

REPRO_SCAN_ENTRY(linear_scan_f32, float)
REPRO_SCAN_ENTRY(linear_scan_bf16, __nv_bfloat16)
