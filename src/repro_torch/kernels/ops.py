"""Public kernel entry points, with the JAX package's ``kernels/ops.py``
signatures (less the TPU lane-tiling knobs).

A tensor on the CPU goes to the plain version in :mod:`.ref`; any other
tensor goes to the CUDA kernel, which launches or raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conv2d import conv2d_cuda
from .maxpool2d import maxpool2d_cuda
from .ref import conv2d_ref, maxpool2d_ref


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           strides: Tuple[int, int] = (1, 1), padding: str = "valid",
           act: Optional[str] = None, alpha: float = 0.1) -> torch.Tensor:
    fn = conv2d_ref if x.device.type == "cpu" else conv2d_cuda
    return fn(x, w, b, strides=strides, padding=padding, act=act,
              alpha=alpha)


def maxpool2d(x: torch.Tensor, *, size: Tuple[int, int] = (2, 2),
              strides: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    fn = maxpool2d_ref if x.device.type == "cpu" else maxpool2d_cuda
    return fn(x, size=size, strides=strides)
