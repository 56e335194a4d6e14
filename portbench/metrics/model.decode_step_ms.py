"""Mean host time of a replayed decode step (a handle's third decode
call onwards) that ended in the window, in ms."""


def read(run):
    d = [(c["end"] - c["start"]) * 1e3
         for c in run.stats.ended_in(run.calls, run.lo, run.hi)
         if c["kind"] == "decode.replay"]
    return sum(d) / len(d) if d else None
