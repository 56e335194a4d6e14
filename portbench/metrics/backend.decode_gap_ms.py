"""Mean host time between two decode steps of one generation, in ms:
from the end of step i's logits copy (``backend.logits_to_host``) to the
start of step i + 1's graph launch (``decode.launch``), which holds the
host's argmax, the token feed and the backend's lock.  Over the pairs of
steps of one ``lm.generate`` whose second step is a replay and which
both ended in the window; the program's own spans."""
from portbench.harness.program_spans import child, children


def read(run):
    spans = getattr(run, "spans", None)
    if not spans:
        return None
    kids = children(spans)
    gaps = []
    for gen in (s for s in spans if s["name"] == "lm.generate"):
        steps = [s for s in kids.get(gen["id"], ())
                 if s["name"] == "backend.decode"]
        for a, b in zip(steps, steps[1:]):
            if (b["attrs"]["step"] != "replay"
                    or not run.lo <= a["end"] <= b["end"] <= run.hi):
                continue
            copy = child(kids, a, "backend.logits_to_host")
            launch = child(kids, b, "decode.launch")
            if copy is not None and launch is not None:
                gaps.append(launch["start"] - copy["end"])
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
