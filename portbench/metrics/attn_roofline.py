"""Prefill attention's share of its roofline, in %: for every prefill
call that lies wholly in the traced stretch, the least time of its
attention layers on the card (per layer the larger of the flash
operations over 989 TFLOP/s and its bytes over 3.35 TB/s, from the
shapes: ``harness/flops.py``) over the device time of the operations,
inside those calls, whose names match a pattern of a file in
``metrics/attn_roofline/`` (one regular expression a file, one file a
kernel)."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spans = [(c["start"], c["end"]) for c in run.calls
             if c["kind"] == "prefill" and run.trace.lo <= c["start"]
             and c["end"] <= run.trace.hi]
    folder = run.bench.reader_data("attn_roofline")
    patterns = [p.read_text().strip() for p in sorted(folder.glob("*.txt"))]
    took = run.trace.kernel_seconds(patterns, spans)
    if not spans or took <= 0:
        return None
    bound = sum(run.flops.flash_bound_s(
        run.cfg, c["batch"], c["stop_pos"], run.peaks) for c in run.calls
        if c["kind"] == "prefill" and (c["start"], c["end"]) in spans)
    return 100.0 * bound / took
