"""Shapes at which the CNN kernels are held against their plain versions
on the card, beyond the JAX suite's cases and the nets' own layers, and
the fp32 tolerance of the conv shapes whose sums are long.

One definition for the two places that run them: the card tests
(``tests/test_torch_cuda.py``, and the CPU replays of the kernels'
indexing in ``tests/test_torch_conv_plan.py`` and
``tests/test_torch_pool_plan.py``) and ``chip_smoke.py``'s kernels phase.
Conv cases are (n, h, w, ci, co, kh, kw, stride, padding, act); pool
cases ((n, h, w, c), size, strides).
"""
from __future__ import annotations

from typing import Tuple

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
