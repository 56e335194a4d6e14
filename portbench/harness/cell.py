"""One run of one cell: set-up, the measured window, the metrics, and
the check.

Set-up draws the weights on the device from the seed, builds the
program's ``LMSession`` on them (the configuration file's ``as_run``,
registered in the program's ``ARCHS``; ``backend="cuda-lm"``, the
default kernel policy, no autotune, ``max_context`` the mix's prompt
plus its new tokens), starts one ``LMTokenServer`` with the mix's knobs, sends
it one batch at the cell's own shape (on a checkout's first run that
builds the kernel library into the checkout's ``build/``), and starts
the clients and, in a traced run, the profiler, which stays on until
the clients have stopped.  The
window opens when the clients are released and closes ``seconds``
later; the clients then stop, and the requests in flight are waited
for.  The peak memory is read, the program's state freed, and the
reference checks a sample of the window's batches.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from types import SimpleNamespace

from . import check as check_mod
from . import flops, stats
from .peaks import peaks_of
from .recorder import Recorder
from .trace import Tracer
from .traffic import ClosedLoop, prompt_stream
from .weights import draw_params

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the port, ``repro_torch``, is none of them)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def program_config(conf: dict, archs: dict):
    """The program's ``ModelConfig`` that the configuration file states:
    its ``arch`` entry of the program's ``ARCHS`` with every field that
    ``as_run`` lists, registered in ``archs`` under ``as_run``'s name so
    that ``LMConfig(arch=...)`` serves it."""
    cfg = dataclasses.replace(archs[conf["arch"]], **conf["as_run"])
    archs[cfg.name] = cfg
    return cfg


def run_cell(bench, cell: dict, seed: int, seconds: float, trace: bool, *,
             t_process: float, device: str = "cuda", smoke: bool = False,
             fault=None, control: bool = False, log=print):
    """Measure ``cell`` (``bench.cell(name)``); returns the run record.
    ``smoke`` runs the configuration's ``.smoke()`` shrink (CPU tests),
    ``fault(backend)`` breaks the program under the recorder (tests of
    the check), ``control`` adds the float8 reference's readings."""
    import torch
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.engine import LMConfig, LMSession, SessionConfig
    from repro_torch.models.stack import init_params
    from repro_torch.serve import LMTokenServer, ServerConfig

    conf, mix = cell["config"], cell["mix"]
    model_cfg = program_config(conf, ARCHS)
    arch = model_cfg.name
    if smoke:
        model_cfg = model_cfg.smoke()
    as_run = dataclasses.asdict(model_cfg) if smoke else conf["as_run"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- set-up ---------------------------------------------------------
    marks = {"start": t_process, "imports": time.perf_counter()}
    params = draw_params(init_params(model_cfg, device="meta"), seed, dev)
    marks["weights"] = _synced(torch, on_card)
    t, new, clients = mix["prompt_tokens"], mix["max_new"], mix["clients"]
    session = LMSession(SessionConfig(
        backend="cuda-lm", device=str(dev), lm=LMConfig(
            arch=arch, smoke=smoke, max_context=t + new,
            decode_batch=clients)), params=params)
    backend = session.backend
    marks["session"] = _synced(torch, on_card)
    server = LMTokenServer(session, config=ServerConfig(**mix["server"]))
    # one batch at the cell's shape through the server's own worker
    # thread (its first calls, the kernel library on a checkout's first
    # run, a first capture)
    stream = prompt_stream(seed, 0, t, model_cfg.vocab_size)
    for fut in [server.submit(next(stream), new) for _ in range(clients)]:
        fut.result()
    marks["warm batch"] = _synced(torch, on_card)
    if fault is not None:
        fault(backend)
    recorder = Recorder(backend).install()
    loop = ClosedLoop(server, mix, seed, model_cfg.vocab_size)
    tracer = Tracer(torch) if trace else None
    if tracer is not None:
        tracer.start()
    marks["clients"] = _synced(torch, on_card)
    names = list(marks)
    log("portbench: set-up " + ", ".join(
        f"{b} {marks[b] - marks[a]:.2f} s" for a, b in zip(names, names[1:])),
        file=sys.stderr)

    # -- the window -------------------------------------------------------
    t0 = loop.start(seconds)
    t1 = t0 + seconds
    _sleep_until(t1)
    loop.join()
    t_stop = time.perf_counter()
    if tracer is not None:
        tracer.stop()
    server.close()
    recorder.uninstall()
    loop.server = None
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    trace_reading = tracer.read(t0, t1) if tracer is not None else None
    if trace_reading is not None:
        log(f"portbench: profiler stop and read {time.perf_counter() - t_stop:.1f} s, "
            f"{len(trace_reading.ops)} device operations in the window",
            file=sys.stderr)

    # -- free the program's state; the weights stay for the reference ----
    del session, server, backend
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    failed = sum(1 for r in loop.requests if not r["ok"])
    run = SimpleNamespace(  # what a metric's reader reads
        cfg=as_run, lo=t0, hi=t1, setup_s=t0 - t_process,
        calls=recorder.calls, requests=loop.requests, trace=trace_reading,
        peaks=peaks_of(torch.cuda.get_device_name(dev)) if on_card else None,
        flops=flops, stats=stats, bench=bench)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the check ----------------------------------------------------------
    t_check = time.perf_counter()
    batches, served, unmatched = check_mod.sample(recorder, loop.requests,
                                                  mix, seed)
    numbers = check_mod.check(torch, batches, served, params, as_run,
                              conf["family"], dev, control=control)
    ok, compared = check_mod.verdict(
        numbers, dict(failed=failed, unmatched=unmatched), cell["limits"])
    log(f"portbench: check of {len(batches)} batches, "
        f"{numbers['tokens_checked']} tokens, "
        f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    del params
    return dict(
        correct=ok, attempted=len(loop.requests), failed=failed,
        metrics=metrics, memory_peak_bytes=memory_peak,
        trace=trace_reading, calls=recorder.calls, numbers=numbers,
        checks=compared, errors=loop.errors[:5])


def _synced(torch, on_card: bool) -> float:
    if on_card:
        torch.cuda.synchronize()
    return time.perf_counter()


def _sleep_until(when: float) -> None:
    while True:
        left = when - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))
