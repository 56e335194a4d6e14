"""What a new decode handle costs beyond two steady steps, in ms, mean
over the generations whose steps all ended in the window: its first two
decode calls (the eager step, then the capture with its first replay)
less twice the mean of its replayed steps."""


def read(run):
    per = []
    gen = None
    for c in sorted(run.calls, key=lambda c: c["start"]):
        if c["kind"] == "prefill":
            gen = {"warm": [], "replay": [], "inside": True}
            per.append(gen)
        elif gen is not None:
            d = c["end"] - c["start"]
            (gen["replay"] if c["kind"] == "decode.replay"
             else gen["warm"]).append(d)
        if gen is not None and not run.lo <= c["end"] <= run.hi:
            gen["inside"] = False
    vals = [(sum(g["warm"]) - 2 * sum(g["replay"]) / len(g["replay"])) * 1e3
            for g in per if g["inside"] and len(g["warm"]) == 2
            and g["replay"]]
    return sum(vals) / len(vals) if vals else None
