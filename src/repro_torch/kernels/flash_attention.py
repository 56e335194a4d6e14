"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas TPU kernel ``_flash_kernel`` /
``flash_attention_pallas`` (``kernels/flash_attention.py``): prefill
attention with causal and sliding-window masks and GQA, online softmax
in fp32, a fully masked row giving 0, output in ``q``'s type.  Bound by
operations on the card (see the note in the source).  The TPU kernel's
``block_q`` / ``block_k`` have no counterpart: the CUDA kernel's tiles
are fixed and it masks the ragged edge, so any T and S work.

q, k and v may be strided views (the model passes its (B,T,H,D)
activations transposed, without a copy) as long as d is contiguous; the
output has q's strides.

``launches`` counts the kernel launches of this process; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .build import check_launch, current_stream, kernel_library

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 120, 128, 256)  # the archs' and the tests' dims

launches = 0
_count_lock = threading.Lock()


def _check(t: torch.Tensor, name: str, dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    if t.dtype not in DTYPES or (dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} dtype {t.dtype} not in {DTYPES} or not "
                         f"q's")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,T,D), k/v (B,Hkv,S,D), fp32 or bf16 alike, on one CUDA
    device; Hq % Hkv == 0, D in :data:`HEAD_DIMS`.  Launches on the
    current stream."""
    global launches
    _check(q, "q", None, None)
    _check(k, "k", q.dtype, q.device)
    _check(v, "v", q.dtype, q.device)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} q heads are no multiple of {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    o = torch.empty_like(q)  # q's strides: (B,T,H,D) memory stays so
    if o.numel() == 0:
        return o
    scale = d ** -0.5 if scale is None else float(scale)
    lib = kernel_library()
    fn = (lib.flash_attention_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_f32)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hkv, t, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), scale,
            current_stream(q.device))
    check_launch(rc, "flash_attention")
    with _count_lock:
        launches += 1
    return o
