"""The whole model's share of the card's bf16 peak, in %: the model
FLOPs (``harness/flops.py``) of the calls, each counted in the share of
its span that lies in the window, per second of the window, over 989
TFLOP/s, whatever kernels did the work."""


def read(run):
    if run.peaks is None:
        return None
    calls = [dict(c, flops=run.flops.call_flops(
        run.cfg, c["batch"], c["start_pos"], c["stop_pos"]))
        for c in run.calls]
    return 100.0 * run.stats.rate(calls, run.lo, run.hi, "flops") / (
        run.peaks["bf16_flops"])
