"""Measure the rate of ``mma.sync`` on the card: TF32 (m16n8k8) and bf16
(m16n8k16), fp32 accumulators.

Every warp of a grid of 8 blocks an SM issues a long loop of
independent ``mma.sync`` instructions (8 accumulators, operands held in
registers, nothing read from memory), so the time is the tensor cores'
rate for that instruction, not a kernel's.  The split-TF32 flash kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``) issues m16n8k8
TF32; this says what that instruction can reach against the published
495 TFLOP/s (dense TF32, reached through ``wgmma``).  The CUDA source is
built with ``nvcc`` into ``build/mma_rate/``.  Prints the card's name
and power limit, then one JSON line::

    python3 tools/mma_rate_torch.py
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool kTF32>
__global__ void __launch_bounds__(128) mma_loop(float* out, int iters,
                                                uint32_t seed) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i);
  b[0] = seed ^ threadIdx.x;
  b[1] = seed + threadIdx.x;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTF32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate_launch(int tf32, void* out, int blocks, int iters,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (tf32)
    mma_loop<true><<<blocks, 128, 0, s>>>(static_cast<float*>(out), iters,
                                         12345u);
  else
    mma_loop<false><<<blocks, 128, 0, s>>>(static_cast<float*>(out), iters,
                                          12345u);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(SOURCE)
    nvcc = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin/nvcc"
    subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).mma_rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    buf = torch.empty(blocks * 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    row = {"sms": sms, "blocks": blocks, "warps_per_block": 4,
           "iters": iters, "independent_accumulators": 8}
    for name, tf32, macs in (("tf32_m16n8k8", 1, 16 * 8 * 8),
                             ("bf16_m16n8k16", 0, 16 * 8 * 16)):
        times = []
        for rep in range(6):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            if fn(tf32, buf.data_ptr(), blocks, iters, stream):
                raise RuntimeError("launch failed")
            end.record()
            end.synchronize()
            if rep:  # the first is a warm-up
                times.append(start.elapsed_time(end))
        ms = sorted(times)[len(times) // 2]
        flops = 2 * macs * 8 * iters * blocks * 4
        row[name] = {"ms": ms, "tflop_s": flops / ms / 1e9}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
