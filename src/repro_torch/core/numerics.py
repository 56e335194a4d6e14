"""Bit-exact numeric helpers shared by the code generator and the int8
path (the port's copy of the JAX package's ``core/numerics.py``).

``flit``
    Prints a float32 as the shortest C literal that parses back to the
    identical bit pattern (the paper's P3 — weights become source-code
    constants, so the printed decimal must round-trip exactly).

``round_half_up``
    ``floor(x + 0.5)`` — the single rounding rule used everywhere a
    real becomes an integer code: activation quantization, zero-point
    derivation, and the requantization epilogue the generated C emits
    as ``u = t + 0.5f; q = (int)u; q -= (float)q > u;``.  0.5 is exact
    in every IEEE-754 width, so the helper preserves the argument's
    dtype (float32 in, float32 math; float64 in, float64 math).
"""
from __future__ import annotations

import numpy as np

_HALF = np.float32(0.5)


def flit(v: float) -> str:
    """Format a float32 as a C literal.

    ``unique=True`` guarantees the shortest decimal that parses back to
    the exact same float32 bit pattern."""
    s = np.format_float_scientific(np.float32(v), unique=True, trim="0")
    return f"{s}f"


def round_half_up(x):
    """``floor(x + 0.5)`` elementwise, dtype-preserving."""
    return np.floor(x + _HALF)
