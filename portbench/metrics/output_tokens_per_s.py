"""Tokens emitted (one a sequence by each prefill and each decode call)
per second of the window, each call counted in the share of its span
that lies in the window."""


def read(run):
    return run.stats.rate(run.calls, run.lo, run.hi, "batch")
