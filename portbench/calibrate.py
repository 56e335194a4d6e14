"""Readings that the limits of a cell's check are set from: for each
seed, one short run of the cell, its compared numbers, and the
control's, the same check with the reference in float8 e4m3 (weights
per output column, inputs per row: every linear layer but the router)
in the program's place.

    python3 portbench/calibrate.py --workload deepseek-moe-16b-port.chat \\
        --seeds 11,12,13 --seconds 6 [--out readings.jsonl]

One process runs every seed, so the kernel library is loaded once.
Prints one JSON line a seed, then one with the largest program reading
and the smallest control reading of each number.  The benchmark's own
runs never run the control.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness.bench import Bench, use_checkout_caches
    from portbench.harness.cell import run_cell
    use_checkout_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    lines = []
    t_start = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(bench, cell, seed, args.seconds, False,
                       t_process=t_start, control=True)
        line = dict(workload=args.workload, seed=seed,
                    correct=out["correct"], attempted=out["attempted"],
                    failed=out["failed"], numbers=out["numbers"],
                    metrics={k: v["value"] for k, v in out["metrics"].items()},
                    device=torch.cuda.get_device_name(0))
        lines.append(line)
        print(json.dumps(line), flush=True)
        t_start = time.perf_counter()
    summary = dict(workload=args.workload, seeds=len(lines))
    for key in ("token_gap", "token_gap_mean", "logit_rel_err",
                "logit_rel_err_median"):
        summary[key + "_program_max"] = max(ln["numbers"][key]
                                            for ln in lines)
        summary[key + "_control_min"] = min(ln["numbers"]["control_" + key]
                                            for ln in lines)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
