"""Window arithmetic: what ended inside the window, rates over it, and
percentiles by nearest rank."""
from __future__ import annotations

import math


def ended_in(items, lo: float, hi: float):
    """The items whose ``end`` lies in [lo, hi]."""
    return [it for it in items if lo <= it["end"] <= hi]


def share_in(it, lo: float, hi: float) -> float:
    """The share of the item's span [start, end] that lies in [lo, hi]."""
    span = it["end"] - it["start"]
    inside = min(it["end"], hi) - max(it["start"], lo)
    if span <= 0:
        return 1.0 if lo <= it["end"] <= hi else 0.0
    return min(1.0, max(0.0, inside / span))


def rate(items, lo: float, hi: float, key: str) -> float:
    """``key`` per second of the window [lo, hi], each item counted in
    the share of its span that lies in the window, so that a call that
    straddles an edge adds its part and no rate moves in steps of whole
    calls."""
    return sum(it[key] * share_in(it, lo, hi) for it in items) / (hi - lo)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest sample with at
    least q% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]

