// What the two flash-attention kernels share: the shape and strides they
// are launched with, and the plain C entry ctypes binds.
#pragma once

#include "common.cuh"

namespace repro_torch {

struct FlashShape {
  int b, hq, hkv, t, s;
  long long qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost;
  int causal, use_window, window;
  int q_start;  // query row i is at position q_start + i for the masks
  float scale;
};

}  // namespace repro_torch

// Plain C entry for ctypes, calling DISPATCH(q, k, v, o, d, shape,
// stream).  Strides are in elements, d is contiguous; use_window = 0
// means no window; q_start offsets the query rows' positions.
#define REPRO_FLASH_ENTRY(NAME, DISPATCH)                                   \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      int b, int hq, int hkv, int t, int s, int d,          \
                      long long qsb, long long qsh, long long qst,          \
                      long long ksb, long long ksh, long long kst,          \
                      long long vsb, long long vsh, long long vst,          \
                      long long osb, long long osh, long long ost,          \
                      int causal, int use_window, int window,               \
                      int q_start, float scale, void* stream) {             \
    const repro_torch::FlashShape sh{b,   hq,  hkv, t,   s,   qsb, qsh,     \
                                     qst, ksb, ksh, kst, vsb, vsh, vst,     \
                                     osb, osh, ost, causal, use_window,     \
                                     window, q_start, scale};               \
    return DISPATCH(q, k, v, o, d, sh, stream);                             \
  }
