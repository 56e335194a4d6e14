"""Wrapper of the hand-written Hopper maxpool2d kernel
(``csrc/maxpool2d.cu``).

Replaces the JAX package's Pallas TPU kernel ``_pool_kernel`` /
``maxpool2d_pallas`` (``kernels/maxpool2d.py``): NHWC max pool, valid
padding, static window, stride defaulting to the window, exact in fp32
and bf16.  Bound by its bytes on the card.  The TPU kernel's
``block_c`` lane tiling has no counterpart.

``launches`` counts the kernel launches of this process; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .build import check_launch, check_operand, current_stream, kernel_library

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_count_lock = threading.Lock()


def maxpool2d_cuda(x: torch.Tensor, *, size: Tuple[int, int] = (2, 2),
                   strides: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """x (N,H,W,C) fp32|bf16, contiguous on a CUDA device."""
    global launches
    check_operand(x, "x", 4, DTYPES)
    n, h, w, c = x.shape
    kh, kw = (int(s) for s in size)
    sh, sw = (int(s) for s in (strides or size))
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} larger than input {h}x{w}")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernel_library()
    fn = (lib.maxpool2d_nhwc_bf16 if x.dtype == torch.bfloat16
          else lib.maxpool2d_nhwc_f32)
    rc = fn(x.data_ptr(), y.data_ptr(), n, h, w, c, kh, kw, sh, sw, oh, ow,
            current_stream(x.device))
    check_launch(rc, "maxpool2d")
    with _count_lock:
        launches += 1
    return y
