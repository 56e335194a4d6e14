"""Public kernel entry points, with the JAX package's ``kernels/ops.py``
signatures (less the TPU tiling knobs: ``block_cout``, ``block_c``,
``block_q``/``block_k``, ``chunk``).

A tensor on the CPU goes to the plain version in :mod:`.ref`; any other
tensor goes to the CUDA kernel, which launches or raises.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conv2d import conv2d_cuda
from .flash_attention import flash_attention_cuda
from .linear_scan import linear_scan_cuda
from .maxpool2d import maxpool2d_cuda
from .ref import attention_ref, conv2d_ref, linear_scan_ref, maxpool2d_ref


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_start: int = 0) -> torch.Tensor:
    """q (B,Hq,T,D), k/v (B,Hkv,S,D) -> (B,Hq,T,D) in q's type; query
    row i at position ``q_start + i`` for the masks."""
    fn = attention_ref if q.device.type == "cpu" else flash_attention_cuda
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              q_start=q_start)


def linear_scan(decay: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                r: torch.Tensor, s0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """decay/k/r (B,T,H,N), v (B,T,H,M), s0 (B,H,N,M) -> (y, final
    state)."""
    fn = linear_scan_ref if v.device.type == "cpu" else linear_scan_cuda
    return fn(decay, k, v, r, s0)
