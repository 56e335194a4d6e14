"""Device time of the MoE layers of one prefill, in ms: the summed
``moe.mlp`` device spans (CUDA events around routing through the
combine, shared experts included) of each ``backend.prefill`` that ended
in the window, averaged over those prefills; the program's own spans."""
from portbench.harness.program_spans import children, ended


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    kids = children(spans)
    per = [[c["device_ms"] for c in kids.get(p["id"], ())
            if c["name"] == "moe.mlp"]
           for p in ended(spans, "backend.prefill", run.lo, run.hi)]
    per = [sum(ms) for ms in per if ms]
    return sum(per) / len(per) if per else None
