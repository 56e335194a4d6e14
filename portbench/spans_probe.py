"""One traced run of a cell with the program's span recorder
(``repro_torch.spans``) on, and what the span readers read of it.

    python3 portbench/spans_probe.py --workload deepseek-moe-16b-port.chat \\
        --seed 12345 --seconds 51 --recorder 1

``run.py --trace 1`` leaves the recorder off.  This runs the same
traced run (``run_cell``) with the recorder on from set-up to the
check, drains it, and gives the span readers (``metrics/
backend.decode_gap_ms.py``, ``backend.capture_ms.py``,
``model.moe_prefill_ms.py``, ``model.moe_slot_fill.py``) the record
over the run's window.  ``--recorder 0`` makes the same run with the
recorder off, so that two runs on one seed give its cost in the traced
run's own metrics.  Prints one JSON object as its last line:
``correct``, ``recorder``, ``spans`` (records drained), ``metrics``
(the traced run's, and the span readers' values) and ``device``.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAN_METRICS = ("backend.decode_gap_ms", "backend.capture_ms",
                "model.moe_prefill_ms.chat", "model.moe_slot_fill.chat")


def probe(bench, cell: dict, seed: int, seconds: float, recorder: bool,
          **run_kw) -> dict:
    """``run_cell``'s record of a traced run with the recorder on (or
    off), its ``metrics`` joined by the span readers' values and
    ``spans`` the number of records drained."""
    from portbench.harness.cell import run_cell
    from repro_torch import spans
    spans.drain()
    if recorder:
        spans.enable()
    try:
        out = run_cell(bench, cell, seed, seconds, True, **run_kw)
    finally:
        spans.disable()
    records = spans.drain()
    run = SimpleNamespace(spans=records, lo=out["trace"].lo,
                          hi=out["trace"].hi)
    for m in SPAN_METRICS:
        value = bench.reader(m)(run)
        if value is not None:
            out["metrics"][m] = {"value": value}
    out["spans"] = len(records)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness.bench import Bench, use_checkout_caches
    use_checkout_caches(ROOT)
    bench = Bench(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("portbench: the probe measures the card", file=sys.stderr)
        return 2
    out = probe(bench, bench.cell(args.workload), args.seed, args.seconds,
                bool(args.recorder), t_process=T_PROCESS)
    print(json.dumps({"correct": out["correct"],
                      "recorder": bool(args.recorder), "spans": out["spans"],
                      "metrics": out["metrics"],
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
