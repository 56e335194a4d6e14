"""Spawned gloo worlds for the port's launch tests (imports no JAX: the
children import only this module, torch and the port).

``run_world(n, job, args, tmp)`` starts ``n`` processes with the
``spawn`` start method, each rank joining one gloo process group on a
``FileStore`` under ``tmp`` (``backend="nccl"``: an NCCL group, rank r
on card r), calls ``job(rank, *args)`` in each (``job`` a module-level
function of an importable module) and returns the ranks' results in
rank order.  Every child has a deadline: one still running
at the join timeout is killed, and the test fails with what each rank
wrote.  A child's exception fails the test with its traceback.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

JOIN_TIMEOUT_S = 240


def _child(rank, n, tmp, job, args, backend):
    os.environ["OMP_NUM_THREADS"] = "1"
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        device_id = None
        if backend == "nccl":
            device_id = torch.device("cuda", rank)
            torch.cuda.set_device(device_id)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
            rank=rank, world_size=n, device_id=device_id)
        result = ("ok", job(rank, *args))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the test
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    sys.exit(0 if result[0] == "ok" else 1)


def run_world(n: int, job, args: tuple, tmp, timeout: float = JOIN_TIMEOUT_S,
              backend: str = "gloo") -> list:
    import multiprocessing as mp
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, n, tmp, job, args, backend),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    results, errors = [], []
    for r in range(n):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: no result (exit {procs[r].exitcode})")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if hung:
        raise AssertionError(f"ranks {hung} of {n} still ran after "
                             f"{timeout:.0f} s and were killed; "
                             + "\n".join(errors))
    if errors:
        raise AssertionError("\n".join(errors))
    return results
