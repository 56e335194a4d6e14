"""Wrapper of the hand-written Hopper linear-scan kernel
(``csrc/linear_scan.cu``).

Replaces the JAX package's Pallas TPU kernel ``_scan_kernel`` /
``linear_scan_pallas`` (``kernels/linear_scan.py``): per head,
``S_t = diag(decay_t) S_{t-1} + k_t^T v_t`` and ``y_t = r_t S_t`` with
the state in fp32, returning ``y`` in ``v``'s type and the final state
in fp32.  The TPU kernel's ``chunk`` (its T tile) has no counterpart:
one CUDA block walks the whole sequence, four lanes to a state column,
with each chunk of 32 steps copied into shared memory while the one
before runs.  Any N up to :data:`MAX_STATE_DIM` and any M.

``launches`` counts the kernel launches of this process; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from .build import (check_launch, check_no_grad, check_operand,
                    current_stream, kernel_library)

DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE_DIM = 128  # N: 4 lanes of a state column keep 32 rows each

launches = 0
_count_lock = threading.Lock()


def linear_scan_cuda(decay: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     r: torch.Tensor, s0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decay/k/r (B,T,H,N), v (B,T,H,M), all fp32 or all bf16; s0
    (B,H,N,M) fp32; all contiguous on one CUDA device, 1 <= N <=
    :data:`MAX_STATE_DIM`.  Returns ``(y (B,T,H,M) in v's type,
    final state (B,H,N,M) fp32)``; launches on the current stream."""
    global launches
    check_no_grad("linear_scan", decay, k, v, r, s0)
    check_operand(v, "v", 4, DTYPES)
    for name, t in (("decay", decay), ("k", k), ("r", r)):
        check_operand(t, name, 4, (v.dtype,), v.device)
    check_operand(s0, "s0", 4, (torch.float32,), v.device)
    b, t, h, n = k.shape
    m = v.shape[-1]
    if (decay.shape != k.shape or r.shape != k.shape
            or v.shape[:3] != (b, t, h) or tuple(s0.shape) != (b, h, n, m)):
        raise ValueError(
            f"shapes decay {tuple(decay.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, r {tuple(r.shape)}, s0 {tuple(s0.shape)} "
            f"do not match")
    if not 1 <= n <= MAX_STATE_DIM:
        raise ValueError(f"state dim N {n} not in 1..{MAX_STATE_DIM}")
    y = torch.empty_like(v)
    s_final = torch.empty_like(s0)
    if s0.numel() == 0:
        return y, s_final
    if t == 0:
        return y, s_final.copy_(s0)
    lib = kernel_library()
    fn = (lib.linear_scan_bf16 if v.dtype == torch.bfloat16
          else lib.linear_scan_f32)
    rc = fn(decay.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), b, t, h, n, m,
            current_stream(v.device))
    check_launch(rc, "linear_scan")
    with _count_lock:
        launches += 1
    return y, s_final
