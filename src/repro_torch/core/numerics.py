"""The rounding rule of the int8 path (the port's copy of the JAX
package's ``core/numerics.py``; the C literal printer stays there, with
the code generator).

``round_half_up``
    ``floor(x + 0.5)`` — the single rounding rule used everywhere a
    real becomes an integer code: activation quantization, zero-point
    derivation, and the requantization epilogue.  0.5 is exact in every
    IEEE-754 width, so the helper preserves the argument's dtype
    (float32 in, float32 math; float64 in, float64 math).
"""
from __future__ import annotations

import numpy as np

_HALF = np.float32(0.5)


def round_half_up(x):
    """``floor(x + 0.5)`` elementwise, dtype-preserving."""
    return np.floor(x + _HALF)
