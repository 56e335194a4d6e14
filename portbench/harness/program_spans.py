"""Helpers of the readers of the program's own spans and counters
(``repro_torch.spans``), which they find on ``run.spans``: the record
that ``spans.drain()`` returned for a run with the recorder on, or
``None``.  Host spans are dicts with ``name``, ``start``, ``end``
(``perf_counter`` seconds, the clock of the call record and of
``Trace``), ``id``, ``parent``, ``thread``, ``attrs`` and ``counts``;
device spans have ``device_ms`` and no ``end``.
"""
from __future__ import annotations


def children(spans) -> dict:
    """Parent id -> its child spans (host and device), host spans in
    order of start."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.get("start", 0.0))
    return kids


def child(kids: dict, span: dict, name: str):
    """The first child of ``span`` called ``name``, or ``None``."""
    return next((c for c in kids.get(span["id"], ()) if c["name"] == name),
                None)


def ended(spans, name: str, lo: float, hi: float) -> list:
    """The host spans called ``name`` that ended in [lo, hi]."""
    return [s for s in spans
            if s["name"] == name and lo <= s.get("end", lo - 1) <= hi]
