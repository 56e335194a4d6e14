"""The share of the MoE's computed slots that hold a routed token, in %:
100 × the summed ``moe.routed_slots`` (tokens × top-k) over the summed
``moe.buffer_slots`` (experts × capacity) of the ``backend.prefill``
spans that ended in the window; the program's own counters."""
from portbench.harness.program_spans import ended


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    routed = buffer = 0
    for p in ended(spans, "backend.prefill", run.lo, run.hi):
        routed += p["counts"].get("moe.routed_slots", 0)
        buffer += p["counts"].get("moe.buffer_slots", 0)
    return 100.0 * routed / buffer if buffer else None
