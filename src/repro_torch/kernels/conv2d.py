"""Wrapper of the hand-written Hopper conv2d kernel (``csrc/conv2d.cu``).

Replaces the JAX package's Pallas TPU kernel ``_conv_kernel`` /
``conv2d_pallas`` (``kernels/conv2d.py``): NHWC x HWIO convolution plus
bias and none / relu / leaky_relu, fp32 accumulation, output in
``x.dtype``.  "same" padding is split the TensorFlow way and applied by
bounds checks inside the kernel, not by padding in device memory.  At
the robot detector's shapes the first layer is bound by its bytes and
the deeper ones by fp32 operations (see the note in the source).

The TPU kernel's ``block_cout`` lane tiling has no counterpart: the
CUDA kernel runs one thread per output element.

``launches`` counts the kernel launches of this process; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from ..core.graph import _conv_pads
from .build import check_launch, check_operand, current_stream, kernel_library

ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_count_lock = threading.Lock()


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                strides: Tuple[int, int] = (1, 1), padding: str = "valid",
                act: Optional[str] = None,
                alpha: float = 0.1) -> torch.Tensor:
    """x (N,H,W,CI) fp32|bf16, w (KH,KW,CI,CO) in x's type, b (CO,) fp32,
    all contiguous on one CUDA device.  Launches on the current stream."""
    global launches
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if padding not in ("same", "valid"):
        raise ValueError(f"padding {padding!r}")
    check_operand(x, "x", 4, DTYPES)
    check_operand(w, "w", 4, (x.dtype,), x.device)
    check_operand(b, "b", 1, (torch.float32,), x.device)
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    if wci != ci or b.shape[0] != co:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not match")
    sh, sw = (int(s) for s in strides)
    pt, pb, pl, pr = _conv_pads((h, wd, ci), kh, kw, (sh, sw), padding)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (wd + pl + pr - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} larger than input {h}x{wd}")
    y = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = kernel_library()
    fn = (lib.conv2d_nhwc_bf16 if x.dtype == torch.bfloat16
          else lib.conv2d_nhwc_f32)
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            n, h, wd, ci, co, kh, kw, sh, sw, pt, pl, oh, ow,
            ACTIVATIONS[act], float(alpha), current_stream(x.device))
    check_launch(rc, "conv2d")
    with _count_lock:
        launches += 1
    return y
