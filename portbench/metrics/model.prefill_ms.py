"""Mean host time of a prefill call that ended in the window, in ms (the
call ends when its logits reach the host)."""


def read(run):
    d = [(c["end"] - c["start"]) * 1e3
         for c in run.stats.ended_in(run.calls, run.lo, run.hi)
         if c["kind"] == "prefill"]
    return sum(d) / len(d) if d else None
