"""Wrapper of the hand-written Hopper decode-attention kernel
(``csrc/decode_attention.cu``): one new token's attention against the
bf16 KV caches, as the graphed decode step runs it.

Replaces no TPU kernel: the JAX package decodes with the plain
``decode_attention_jax``.  The kernel computes the port's plain version,
:func:`repro_torch.kernels.ref.decode_attention_ref`, without its fp32
copy of the cache and its two einsum copies: scores as fp32 sums of
exact bf16 products, then the scale; the ring and window mask; softmax
in fp32; p normalized and rounded to bf16; p.v summed in fp32; the
output in bf16.
Bound by bytes on the card: it reads each cache byte once, up to ``pos``.

q is (B,1,H,Dh) with its head dim contiguous; the caches (B,S,Hkv,Dh)
may be views with any strides whose head dim is contiguous and whose
other strides and base pointers fall on 16 bytes (a narrow of the kv
heads takes no copy).  ``pos`` is a Python int or a 0-d int64 tensor on
the caches' device, read by the kernel on the device, so a step that
calls it can be captured in a CUDA graph.  Scratch and output come from
``torch.empty`` (under capture, from the graph's pool); the kernels run
on the current stream; no atomics, so two calls give the same bits.

``launches`` counts this process's calls of the kernel; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple, Union

import torch

from .build import check_launch, check_no_grad, current_stream, kernel_library

MAX_GROUP = 8        # q heads a kv head (the kernel's kMaxGroup)
MAX_HEAD_DIM = 256
MAX_CHUNK = 512      # slots a block (the kernel's kMaxChunk)
MIN_CHUNK = 64
TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs

launches = 0
_count_lock = threading.Lock()


def decode_plan(b: int, hkv: int, s: int) -> Tuple[int, int]:
    """``(chunk, chunks)``: the slots a block scores and the blocks a
    (batch row, kv head).  One chunk where ``b * hkv`` blocks fill the
    card; otherwise S is cut so that about :data:`TARGET_BLOCKS` run,
    into chunks of :data:`MIN_CHUNK` to :data:`MAX_CHUNK` slots (a
    multiple of 32).  It depends on the shapes alone, so a captured step
    keeps it as the position advances."""
    want = -(-TARGET_BLOCKS // (b * hkv))
    chunk = max(MIN_CHUNK, -(-s // want))
    chunk = min(MAX_CHUNK, -(-chunk // 32) * 32, s)
    return chunk, -(-s // chunk)


def scratch_floats(b: int, hkv: int, s: int, g: int, dh: int) -> int:
    """fp32 scratch of one call: the scores (B*Hkv, S, G), each chunk's
    max and sum (B*Hkv, chunks, 2, G) and, with more than one chunk, each
    chunk's output (B*Hkv, chunks, G, Dh)."""
    _, chunks = decode_plan(b, hkv, s)
    parts = chunks * g * dh if chunks > 1 else 0
    return b * hkv * (s * g + chunks * 2 * g + parts)


def _check(t: torch.Tensor, name: str, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} dtype {t.dtype} is not torch.bfloat16")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          pos: Union[int, torch.Tensor], *,
                          window: Optional[int] = None,
                          ring: bool = False) -> torch.Tensor:
    """q (B,1,H,Dh), k_cache / v_cache (B,S,Hkv,Dh), all bf16 on one CUDA
    device, H a multiple of Hkv by at most :data:`MAX_GROUP`, Dh a
    multiple of 8 up to :data:`MAX_HEAD_DIM`; the arguments of
    :func:`~repro_torch.kernels.ref.decode_attention_ref` (the scale
    ``Dh ** -0.5``, whole scores).  Returns (B,1,H,Dh) bf16; launches on
    the current stream."""
    global launches
    check_no_grad("decode_attention", q, k_cache, v_cache)
    _check(q, "q", None)
    _check(k_cache, "k_cache", q.device)
    _check(v_cache, "v_cache", q.device)
    b, s, hkv, dh = k_cache.shape
    h = q.shape[2]
    if (q.shape[0] != b or q.shape[1] != 1 or q.shape[3] != dh
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)} do not match")
    if hkv == 0 or h % hkv or not 1 <= h // hkv <= MAX_GROUP:
        raise ValueError(f"{h} q heads over {hkv} kv heads: the kernel "
                         f"takes 1 to {MAX_GROUP} q heads a kv head")
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} is no multiple of 8 in "
                         f"8..{MAX_HEAD_DIM}")
    if b * hkv > 65535 or s == 0:
        raise ValueError(f"{b} x {hkv} rows of {s} slots: the kernel takes "
                         f"1 to 65535 rows of at least one slot")
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel's 16-byte loads need an aligned base "
                f"pointer and strides of whole 16-byte chunks, got pointer "
                f"{t.data_ptr():#x}, strides {t.stride()}")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or (
                pos.device != q.device):
            raise ValueError(f"pos must be a 0-d int64 tensor on {q.device}, "
                             f"got {pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos_ptr, pos_value = pos.data_ptr(), 0
    else:
        pos_ptr, pos_value = None, int(pos)
    if window is not None and int(window) < 0:
        raise ValueError(f"window {window} is negative")
    g = h // hkv
    chunk, _ = decode_plan(b, hkv, s)
    o = torch.empty((b, 1, h, dh), dtype=q.dtype, device=q.device)
    scratch = torch.empty(scratch_floats(b, hkv, s, g, dh),
                          dtype=torch.float32, device=q.device)
    rc = kernel_library().decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        pos_ptr, scratch.data_ptr(), b, s, hkv, g, dh,
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], int(bool(ring)), int(window is not None),
        0 if window is None else int(window), pos_value, dh ** -0.5, chunk,
        current_stream(q.device))
    check_launch(rc, "decode_attention")
    with _count_lock:
        launches += 1
    return o
