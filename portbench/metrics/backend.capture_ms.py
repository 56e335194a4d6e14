"""Mean host time of a decode step's capture into a CUDA graph
(``decode.capture``, ``capture_begin`` to ``capture_end``), over the
captures that ended in the window, in ms; the program's own spans."""
from portbench.harness.program_spans import ended


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    d = [(s["end"] - s["start"]) * 1e3
         for s in ended(spans, "decode.capture", run.lo, run.hi)]
    return sum(d) / len(d) if d else None
