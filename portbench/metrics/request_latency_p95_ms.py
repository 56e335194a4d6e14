"""The 95th percentile (nearest rank) of submit -> result, in ms, over
every request sent in the window that came back, those still running at
the close included with their whole wait."""


def read(run):
    lat = [(r["end"] - r["submit"]) * 1e3 for r in run.requests if r["ok"]]
    return run.stats.percentile(lat, 95) if lat else None
