"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port): one run
of one cell.

    python3 portbench/run.py --workload deepseek-moe-16b-port.chat \\
        --seed 12345 --seconds 51 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell
asks for.  Prints, as its last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks`` (each
compared number beside its limit, also the last lines of standard
error).  Exits non-zero, printing no result, without a card (or with
fewer than the cell asks for), where the program is missing, or where
JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.enable()  # a crash in native code still names its line
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness.bench import Bench, use_checkout_caches
    use_checkout_caches(ROOT)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this benchmark measures "
              "the card")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"{args.workload} needs {cell['chips']} cards, "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail("the program (src/repro_torch) is not in this checkout")

    from portbench.harness.cell import forbidden_modules, run_cell
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        _fail(f"loaded {bad}: the benchmark and the port run without JAX", 3)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    tr = out["trace"]
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_by_host(out["calls"], 10)}
    result["checks"] = out["checks"]
    kinds = {}
    for c in out["calls"]:
        kinds.setdefault(c["kind"], []).append(c["end"] - c["start"])
    calls = {k: f"{len(v)} x {1e3 * sum(v) / len(v):.2f} ms"
             for k, v in kinds.items()}
    print(f"portbench: {args.workload} seed {args.seed}: calls {calls}, "
          f"numbers {out['numbers']}, errors {out['errors']}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
