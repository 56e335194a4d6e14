"""Wrapper of the hand-written Hopper flash-attention kernels, both on
the tensor cores: bf16 (``csrc/flash_attention_sm90.cu``) and fp32 as
split TF32 (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas TPU kernel ``_flash_kernel`` /
``flash_attention_pallas`` (``kernels/flash_attention.py``): prefill
attention with causal and sliding-window masks and GQA, online softmax
in fp32, a fully masked row giving 0, output in ``q``'s type.  Bound by
operations on the card.  The bf16 kernel runs both products on the
tensor cores (``wgmma``, tiles copied by TMA) and, unlike the TPU kernel,
keeps p to about 16 bits (``bf16(p)`` plus ``bf16(p - bf16(p))``, both
multiplied with v) instead of rounding it once to bf16, so every output
stays within one bf16 rounding of the fp32 function of its inputs (one
rounding of p breaks that on 24% of gemma3-4b-shaped outputs; see the
note in the source).  The fp32 kernel runs both products as split TF32
(``mma.sync``, tiles copied by ``cp.async``): each operand split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, three TF32 products with
fp32 accumulators, about 2**-22 of each operand left where one TF32
product (2**-11) would miss the fp32 tolerance of 2e-5
(``tests/test_torch_flash_fp32_split.py`` emulates it).  The TPU
kernel's ``block_q`` / ``block_k`` have no counterpart: the CUDA
kernels' tiles are fixed and they mask the ragged edge, so any T and S
work.

q, k and v may be strided views (the model passes its (B,T,H,D)
activations transposed, without a copy) as long as d is contiguous; the
output has q's strides.  Both kernels copy 16-byte chunks (TMA, or
``cp.async`` for fp32), so every base pointer and every (b, h, t) stride
must be a multiple of 16 bytes; anything else raises ``ValueError``.

``launches`` counts the kernel launches of this process, both types;
``launches_f32`` those of the fp32 kernel alone.  They are plain
integers, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .build import (check_launch, check_no_grad, current_stream,
                    kernel_library)

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 80, 120, 128, 256)  # the archs' and the tests' dims

launches = 0
launches_f32 = 0
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


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels' 16-byte copies: base pointer and every (b, h, t)
    stride (of a dim longer than 1) a multiple of 16 bytes."""
    if t.data_ptr() % 16 or any(
            n > 1 and st * t.element_size() % 16
            for n, st in zip(t.shape[:3], t.stride()[:3])):
        raise ValueError(
            f"{name}: the {t.dtype} kernel needs a 16-byte aligned base "
            f"pointer and (b, h, t) strides of whole 16-byte chunks, got "
            f"pointer {t.data_ptr():#x}, strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None,
                         q_start: int = 0) -> torch.Tensor:
    """q (B,Hq,T,D), k/v (B,Hkv,S,D), fp32 or bf16 alike, on one CUDA
    device; Hq % Hkv == 0, D in :data:`HEAD_DIMS`; query row i at
    position ``q_start + i`` for the masks (``q_start >= 0``).  Launches
    on the current stream."""
    global launches, launches_f32
    check_no_grad("flash_attention", q, k, v)
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
    if q_start < 0:
        raise ValueError(f"q_start {q_start} is negative")
    o = torch.empty_like(q)  # q's strides: (B,T,H,D) memory stays so
    if o.numel() == 0:
        return o
    # o has q's strides or is contiguous: aligned with q
    for a, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_aligned(a, name)
    bf16 = q.dtype == torch.bfloat16
    scale = d ** -0.5 if scale is None else float(scale)
    lib = kernel_library()
    fn = lib.flash_attention_bf16 if bf16 else lib.flash_attention_f32
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, hq, hkv, t, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3],
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), int(q_start), scale,
            current_stream(q.device))
    check_launch(rc, "flash_attention")
    with _count_lock:
        launches += 1
        launches_f32 += not bf16
    return o
