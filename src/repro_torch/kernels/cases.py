"""Shapes at which the CNN kernels are held against their plain versions
on the card, beyond the JAX suite's cases and the nets' own layers, and
the fp32 tolerance of the conv shapes whose sums are long; and the
decode-attention kernel's cases, which the CPU tests also hold its plain
version to the JAX package's at, with the kernel's tolerance.

One definition for the two places that run them: the card tests
(``tests/test_torch_cuda.py``, and the CPU replays of the kernels'
indexing in ``tests/test_torch_conv_plan.py`` and
``tests/test_torch_pool_plan.py``) and ``chip_smoke.py``'s kernels phase.
Conv cases are (n, h, w, ci, co, kh, kw, stride, padding, act); pool
cases ((n, h, w, c), size, strides); decode-attention cases (b, s, hkv,
g, dh, ring, window, pos).
"""
from __future__ import annotations

from typing import Tuple

import torch

# the compiled-tap conv kernel's edges: H and W no multiple of the row
# tile, batch 1, c_out one below and one above the channel tiles (12 a
# thread, 16, 24 and 32 a block), strips whose rows are no whole 16-byte
# chunks (CI 1 and 3 at odd W), rows wider than one pass, filters above
# 48 KB of shared memory, and shapes only the general (runtime-tap)
# kernel takes (7x7, 3x2, 3x3 at stride 2)
EDGE_CONV_CASES = [
    (2, 37, 53, 8, 12, 3, 3, 1, "same", "leaky_relu"),
    (1, 31, 45, 16, 20, 3, 3, 1, "same", "relu"),
    (2, 9, 11, 8, 11, 3, 3, 1, "same", None),
    (2, 9, 11, 8, 13, 3, 3, 1, "same", "relu"),
    (2, 9, 11, 8, 15, 3, 3, 1, "same", None),
    (2, 9, 11, 8, 17, 3, 3, 1, "same", None),
    (2, 9, 11, 8, 23, 3, 3, 1, "same", "leaky_relu"),
    (2, 9, 11, 8, 25, 3, 3, 1, "same", None),
    (2, 9, 11, 8, 31, 3, 3, 1, "same", "relu"),
    (2, 9, 11, 8, 33, 3, 3, 1, "same", "relu"),
    (2, 13, 17, 1, 8, 3, 3, 1, "same", "relu"),
    (2, 13, 17, 3, 8, 3, 3, 1, "same", "leaky_relu"),
    (1, 5, 700, 4, 8, 3, 3, 1, "same", "relu"),
    (1, 6, 7, 64, 64, 3, 3, 1, "same", None),
    (1, 20, 22, 4, 8, 7, 7, 1, "same", "relu"),
    (2, 10, 9, 5, 6, 3, 2, 1, "valid", None),
    (2, 15, 17, 6, 10, 3, 3, 2, "same", "leaky_relu"),
]
# shapes whose full-width output row and filters exceed a block's 227 KB
# of shared memory, all of which the TPU kernel computes: wide rows
# (column tiles), deep layers (input-channel chunks) and very large
# windows (filter-row and filter-column chunks); held at conv_tol
BIG_CONV_CASES = [
    (1, 4, 4000, 16, 8, 3, 3, 1, "same", "relu"),
    (1, 64, 1024, 16, 16, 3, 3, 1, "same", "leaky_relu"),
    (1, 3, 1024, 16, 16, 3, 3, 1, "valid", None),
    (1, 8, 8, 1024, 64, 3, 3, 1, "same", "relu"),
    (1, 14, 14, 512, 64, 7, 7, 2, "same", None),
    (2, 9, 9, 2048, 8, 3, 3, 1, "same", "leaky_relu"),
    (1, 56, 56, 4, 4, 56, 56, 1, "valid", None),
    (1, 1, 2960, 4, 4, 1, 2950, 1, "valid", "relu"),
]
# the pool kernel's vector widths and instantiations: C 2, 4 and 12 (no
# whole 16-byte vector in bf16), C 1 and 3 (single elements), odd H and
# W, 3x3/2, a window equal to the input, an overlapping window (3x3/1),
# a runtime window (2x3/1x2) and a channel count wide enough that a
# pixel spans several blocks' threads
EDGE_POOL_CASES = [
    ((2, 7, 9, 2), (2, 2), None),
    ((1, 9, 11, 4), (3, 3), (2, 2)),
    ((3, 6, 10, 12), (2, 2), None),
    ((1, 5, 7, 1), (2, 2), None),
    ((2, 8, 6, 3), (3, 3), (2, 2)),
    ((1, 13, 15, 8), (3, 3), (2, 2)),
    ((2, 5, 6, 8), (5, 6), None),
    ((1, 10, 9, 16), (3, 3), (1, 1)),
    ((2, 9, 10, 6), (2, 3), (1, 2)),
    ((1, 4, 6, 4104), (2, 2), None),
]


# the decode-attention kernel (csrc/decode_attention.cu): a cache of 1,
# 320 (the benchmark's), 4,096 and 32,768 slots with the new token first,
# in the middle and last; G 1, 2, 4 and 8; the archs' head dims (16 of
# the smoke configs, 64, 80, 120, 128, 256); ring caches with a window
# before and after they wrap, one window shorter than the ring; a window
# on a linear cache; ``chip_smoke.py``'s LM decode (batch 4, caches of
# 2,048 slots from position 1,536 on): deepseek-moe-16b, zamba2-2.7b's
# shared block and gemma3-4b's global layer and local ring of its window.
# Batch 24 of 12 kv heads fills the card with one chunk a (b, kv head),
# as the benchmark's step does; the others cut S into several, which the
# third kernel sums
DECODE_ATTN_CASES = [
    (24, 160, 12, 1, 64, False, None, 100),
    (24, 64, 12, 2, 128, True, 64, 90),
    (2, 1, 2, 2, 64, False, None, 0),
    (4, 320, 4, 1, 128, False, None, 0),
    (4, 320, 4, 1, 128, False, None, 160),
    (4, 320, 4, 1, 128, False, None, 319),
    (2, 4096, 2, 2, 80, False, None, 0),
    (2, 4096, 2, 2, 80, False, None, 2048),
    (2, 4096, 2, 2, 80, False, None, 4095),
    (1, 32768, 2, 4, 64, False, None, 0),
    (1, 32768, 2, 4, 64, False, None, 16384),
    (1, 32768, 2, 4, 64, False, None, 32767),
    (1, 320, 2, 8, 128, False, None, 200),
    (2, 320, 2, 4, 128, False, 100, 250),
    (2, 8, 2, 2, 16, True, 8, 5),
    (2, 8, 2, 2, 16, True, 8, 21),
    (1, 1024, 4, 2, 256, True, 1024, 600),
    (1, 1024, 4, 2, 256, True, 1024, 1500),
    (2, 512, 2, 4, 120, True, 300, 700),
    (4, 2048, 16, 1, 128, False, None, 1540),
    (4, 2048, 32, 1, 80, False, None, 1540),
    (4, 2048, 4, 2, 256, False, None, 1540),
    (4, 1024, 4, 2, 256, True, 1024, 1540),
]


def conv_tol(kh: int, kw: int, ci: int) -> Tuple[float, float]:
    """(rtol, atol) of an fp32 conv of BIG_CONV_CASES, whose outputs sum
    K = kh*kw*ci products of x ~ N(0, 1) and w ~ 0.2 N(0, 1).

    Up to K 512 both are the JAX suite's 1e-5.  Above that rtol stays
    1e-5 and atol grows as K: a sum taken one product at a time rounds K
    times, each by up to half an ulp (2**-24 relative) of a partial sum
    whose size grows as sqrt(K) times a product's (0.2), so the rounding
    errors, adding up as a random walk, come to about 2**-24 * 0.2 * K.
    The kernel and the plain version sum in different orders, so atol
    allows four times that: two sums, and a factor of two of headroom."""
    k = kh * kw * ci
    return 1e-5, 1e-5 if k <= 512 else 4 * 2.0 ** -24 * 0.2 * k


# The decode-attention kernel and its plain version each round an fp32
# output to bf16 once, from sums taken in other orders: one bf16 unit in
# the last place apart (2**-7 of the value; 1e-5 for fp32 sums near 0).
# Both also round each p to bf16 from fp32 values that differ in their
# last bits, so a p may land on the other neighbour, one unit (at most
# 2**-7 of p) apart: rare (3 outputs of 73,728 in one case on an H100),
# and then the output moves by 2**-7 p_s |v_s| for that slot.  Such
# outputs may lie DECODE_FLIPS of the largest such move further off.
DECODE_RTOL, DECODE_ATOL = 2.0 ** -7, 1e-5
DECODE_FLIP_SHARE = 1e-3
DECODE_FLIPS = 4


def _largest_flip(q, k, v, pos, window, ring) -> torch.Tensor:
    """``2**-7 * max_s p_s |v_s|`` for each output (B,1,H,Dh): what one
    p's rounding to its other bf16 neighbour can move it by at most,
    with p the plain version's fp32 weights."""
    from .ref import decode_probs_ref
    b, s, hkv, dh = k.shape
    p = decode_probs_ref(q, k, pos, window=window, ring=ring)  # b,hkv,g,s
    av = v.float().abs().permute(0, 2, 1, 3)  # b, hkv, s, dh
    most = torch.stack([(p[:, :, j, :, None] * av).amax(2)
                        for j in range(p.shape[2])], 2)  # b, hkv, g, dh
    return DECODE_RTOL * most.reshape(b, 1, q.shape[2], dh)


def check_decode(got: torch.Tensor, want: torch.Tensor, q, k, v, pos, *,
                 window=None, ring: bool = False) -> float:
    """Hold the kernel's output ``got`` to the plain version's ``want``
    on the inputs ``q, k, v, pos``: all but :data:`DECODE_FLIP_SHARE` of
    the outputs within one bf16 unit of themselves, and those within it
    and :data:`DECODE_FLIPS` times the largest move one p's rounding can
    make (:func:`_largest_flip`).  Raises ``AssertionError``; returns the
    largest absolute difference."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tight = DECODE_RTOL * w.abs() + DECODE_ATOL
    flip = DECODE_FLIPS * _largest_flip(q, k, v, pos, window, ring)
    outside = float((diff > tight).float().mean())
    if not bool((diff <= tight + flip).all()) or (
            outside > DECODE_FLIP_SHARE):
        raise AssertionError(
            f"decode attention: max |diff| {float(diff.max()):.3g}, "
            f"{outside:.3%} of the outputs past one bf16 unit")
    return float(diff.max())
