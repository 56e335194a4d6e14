#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order, each printing one JSON line (``time`` one per robot
layer); any failure propagates and the script exits non-zero:

1. device  — the card's name and power limit (the raw ``nvidia-smi`` line,
   also printed on its own), torch and CUDA versions, and TF32 switched
   off for cuDNN and matmul;
2. build   — the hand-written CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels/``:
   seconds, and ptxas's register and spill counts;
3. kernels — each kernel held against its plain PyTorch version
   (``kernels/ref.py``) on the card: conv2d on every conv shape of the
   four optimized nets at the main path's batches, the JAX suite's cases
   and a c_out that is no multiple of the thread block (fp32 at 1e-5,
   bf16 at 3e-2); maxpool2d on the JAX suite's cases and the robot's
   pools, exact;
4. time    — per robot layer at batch 256: the kernel, its plain version
   and one PyTorch library call, CUDA events around a replayed CUDA
   graph, median of repeats; bytes, fp32 operations and the bound;
5. main    — ``InferenceSession(backend="cuda")`` against
   ``backend="torch"`` on the card at rtol 1e-4 / atol 1e-5: the robot
   detector on 64 frames, ball, pedestrian and residual on 8; the robot
   also against the CPU on 4 frames;
6. e2e     — the robot forward at batch 256 with the input on the card,
   on both backends in turns, the card's busy share under the profiler,
   and batch-1 ``session.benchmark()``;
7. serve   — 256 robot frames through ``InferenceServer(workers=2,
   max_batch=32)``, each equal to ``session.predict`` (rtol 1e-5 /
   atol 1e-6); latency percentiles, QPS, batch occupancy, and the card's
   busy share while serving;
8. the kernels line — per kernel: launches in phases 5-7 (each phase
   counted from 0 and read as it ends), max error, and per robot forward
   at batch 256 the kernel's, plain version's, bound's and library's ms;
9. the last line — ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BATCH = 256
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:31"),
    "maxpool2d": ("src/repro_torch/kernels/csrc/maxpool2d.cu",
                  "src/repro/kernels/maxpool2d.py:17"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def compare(got, want, rtol: float, atol: float, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol*|want|
    everywhere, all values are finite and shapes and types agree."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {err.numel()} "
                             f"outside rtol {rtol} atol {atol}; max abs "
                             f"error {float(err.max())}")
    return float(err.max())


def events_ms(torch, step, per: int = 1, trials: int = 5) -> float:
    """Median over ``trials`` of the CUDA-event time of ``step()``, in ms,
    divided by ``per`` (the calls one step makes)."""
    out = []
    step()
    torch.cuda.synchronize()
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per)
    return statistics.median(out)


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed between CUDA events, so the host's launch
    overhead is left out and only the card's time is measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(torch, graph.replay, reps)


def device_busy(torch, fn):
    """Run ``fn()`` under the profiler; returns (busy_ms, wall_ms): the
    time in which the card ran at least one kernel or copy (the union of
    the device-side events, so overlapping streams count once) and the
    host wall time of the window, which ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, wall


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by, bytes_ms, ops_ms) on the published peaks."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def conv_layers(graph):
    """(in_shape, layer) of every Conv2D of an optimized graph."""
    from repro_torch.core.graph import Conv2D
    smap = graph.shape_map()
    return [(smap[l.inputs[0]], l) for l in graph.layers
            if isinstance(l, Conv2D)]


def pool_layers(graph):
    """(in_shape, layer) of every valid-padded MaxPool of a graph."""
    from repro_torch.core.graph import MaxPool
    smap = graph.shape_map()
    return [(smap[l.inputs[0]], l) for l in graph.layers
            if isinstance(l, MaxPool) and l.padding == "valid"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
    from repro_torch.core import passes
    from repro_torch.core.graph import pool_window_counts
    from repro_torch.engine import InferenceSession, SessionConfig
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as conv_mod
    from repro_torch.kernels import maxpool2d as pool_mod
    from repro_torch.kernels.ref import conv2d_ref, maxpool2d_ref
    from repro_torch.serve import InferenceServer, ServerConfig

    dev = torch.device("cuda:0")
    nets = {**PAPER_CNNS, **EXTRA_CNNS}
    main_batch = {"robot": 64, "ball": 8, "pedestrian": 8, "residual": 8}
    rng = np.random.default_rng(0)

    def rand(shape, dtype=torch.float32, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def counts():
        return {"conv2d": conv_mod.launches, "maxpool2d": pool_mod.launches}

    def reset_counts():
        conv_mod.launches = 0
        pool_mod.launches = 0

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    so = build.build()
    build.kernel_library()
    log = so.with_suffix(".log").read_text().splitlines()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(so.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in log
                if "registers" in ln or "spill" in ln])

    # -- 3. kernels against their plain versions -------------------------
    opt = {name: passes.optimize(f(0), simd_multiple=4)
           for name, f in nets.items()}
    conv_cases = [  # (n, h, w, ci, co, kh, kw, stride, padding, act)
        (1, 16, 16, 1, 8, 5, 5, 2, "same", "relu"),
        (2, 9, 7, 3, 4, 3, 3, 1, "same", "leaky_relu"),
        (1, 8, 8, 8, 12, 3, 3, 1, "valid", None),
        (2, 6, 6, 4, 16, 2, 2, 2, "valid", "relu"),
        (1, 12, 10, 2, 6, 1, 1, 1, "valid", None),
        (1, 60, 80, 3, 8, 3, 3, 1, "same", "leaky_relu"),
        (3, 7, 5, 5, 300, 3, 3, 1, "same", "relu"),  # c_out % 256 != 0
    ]
    pool_cases = [((1, 8, 8, 8), (2, 2), None),
                  ((2, 9, 9, 4), (3, 3), (2, 2)),
                  ((1, 16, 8, 12), (2, 2), (2, 2))]
    for name, g in opt.items():
        n = main_batch[name]
        for (h, w, ci), l in conv_layers(g):
            act = l.activation if l.activation != "softmax" else None
            conv_cases.append((n, h, w, ci, l.c_out, l.kh, l.kw,
                               l.strides[0], l.padding, act))
        for (h, w, c), l in pool_layers(g):
            pool_cases.append(((n, h, w, c), l.size, l.strides))
    err = {"conv2d": 0.0, "maxpool2d": 0.0}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        for n, h, w, ci, co, kh, kw, st, pad, act in conv_cases:
            x = rand((n, h, w, ci), dtype)
            wt = rand((kh, kw, ci, co), dtype, 0.2)
            b = rand((co,))
            kw_args = dict(strides=(st, st), padding=pad, act=act)
            e = compare(conv_mod.conv2d_cuda(x, wt, b, **kw_args),
                        conv2d_ref(x, wt, b, **kw_args), tol, tol,
                        f"conv2d {dtype} {(n, h, w, ci, co, kh, kw, st)}")
            if dtype == torch.float32:
                err["conv2d"] = max(err["conv2d"], e)
        for shape, size, stride in pool_cases:
            x = rand(shape, dtype)
            e = compare(pool_mod.maxpool2d_cuda(x, size=size, strides=stride),
                        maxpool2d_ref(x, size=size, strides=stride), 0.0, 0.0,
                        f"maxpool2d {dtype} {shape} {size} {stride}")
            err["maxpool2d"] = max(err["maxpool2d"], e)
    torch.cuda.synchronize()
    emit("kernels", conv2d_cases=len(conv_cases), maxpool2d_cases=len(
        pool_cases), dtypes=["float32", "bfloat16"],
         tolerance={"conv2d": {"float32": 1e-5, "bfloat16": 3e-2},
                    "maxpool2d": 0.0},
         max_abs_err_fp32=err)

    # -- 4. time at the robot detector's shapes, batch 256 ---------------
    robot = opt["robot"]
    rows = {"conv2d": [], "maxpool2d": []}
    for (h, w, ci), l in conv_layers(robot):
        x = rand((BATCH, h, w, ci))
        wt = torch.from_numpy(l.weights).to(dev)
        b = torch.from_numpy(l.bias).to(dev)
        kw_args = dict(strides=l.strides, padding=l.padding,
                       act=l.activation, alpha=l.alpha)
        pt, pb, pl, pr = l.pad_amounts((h, w, ci))
        assert (pt, pl) == (pb, pr), "the library call takes symmetric pads"
        x_lib = x.permute(0, 3, 1, 2)  # channels-last NCHW view, no copy
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        y = conv_mod.conv2d_cuda(x, wt, b, **kw_args)
        e = compare(y, conv2d_ref(x, wt, b, **kw_args), 1e-5, 1e-5,
                    f"conv2d {l.name} at batch {BATCH}")
        err["conv2d"] = max(err["conv2d"], e)
        taps = int(pool_window_counts((h, w, ci), (l.kh, l.kw), l.strides,
                                      (pt, pb, pl, pr)).sum())
        rows["conv2d"].append(dict(
            layer=l.name, x=list(x.shape), w=list(wt.shape),
            ms=graph_ms(torch, lambda: conv_mod.conv2d_cuda(
                x, wt, b, **kw_args)),
            plain_ms=graph_ms(torch, lambda: conv2d_ref(x, wt, b, **kw_args)),
            library_ms=graph_ms(torch, lambda: F.conv2d(
                x_lib, w_lib, b, stride=l.strides, padding=(pt, pl))),
            nbytes=nbytes(x, wt, b, y),
            ops=BATCH * (2 * taps * ci * l.c_out + y[0].numel())))
    for (h, w, c), l in pool_layers(robot):
        x = rand((BATCH, h, w, c))
        y = pool_mod.maxpool2d_cuda(x, size=l.size, strides=l.strides)
        compare(y, maxpool2d_ref(x, size=l.size, strides=l.strides), 0.0,
                0.0, f"maxpool2d {l.name} at batch {BATCH}")
        x_lib = x.permute(0, 3, 1, 2)
        rows["maxpool2d"].append(dict(
            layer=l.name, x=list(x.shape),
            ms=graph_ms(torch, lambda: pool_mod.maxpool2d_cuda(
                x, size=l.size, strides=l.strides)),
            plain_ms=graph_ms(torch, lambda: maxpool2d_ref(
                x, size=l.size, strides=l.strides)),
            library_ms=graph_ms(torch, lambda: F.max_pool2d(
                x_lib, l.size, l.strides)),
            nbytes=nbytes(x, y), ops=y.numel() * (l.size[0] * l.size[1] - 1)))
    for kernel, rs in rows.items():
        for r in rs:
            r["bound_ms"], r["bound_by"], _, _ = bound(r["nbytes"], r["ops"])
            emit("time", kernel=kernel, **r)

    # -- 5. the main path: sessions on the card --------------------------
    reset_counts()
    main_out, sessions = {}, {}
    for name, batch in main_batch.items():
        sess = InferenceSession(nets[name](0),
                                config=SessionConfig(backend="cuda"))
        plain = InferenceSession(nets[name](0),
                                 config=SessionConfig(backend="torch"))
        frames = np.random.default_rng(7).normal(
            size=(batch,) + tuple(sess.input_shape)).astype(np.float32)
        got = sess.predict(frames)
        assert got.shape == (batch,) + tuple(sess.output_shape), got.shape
        main_out[name] = dict(batch=batch, shape=list(got.shape),
                              max_abs_err=compare(
                                  torch.from_numpy(got),
                                  torch.from_numpy(plain.predict(frames)),
                                  1e-4, 1e-5, f"{name} cuda vs torch"))
        sessions[name] = (sess, plain)
    cpu = InferenceSession(nets["robot"](0), config=SessionConfig(
        backend="torch", device="cpu"))
    frames = np.random.default_rng(7).normal(
        size=(4,) + tuple(cpu.input_shape)).astype(np.float32)
    main_out["robot"]["max_abs_err_vs_cpu"] = compare(
        torch.from_numpy(sessions["robot"][0].predict(frames)),
        torch.from_numpy(cpu.predict(frames)), 1e-4, 1e-5,
        "robot cuda vs cpu")
    torch.cuda.synchronize()
    launches = {"main": counts()}
    emit("main", nets=main_out, launches=launches["main"])

    # -- 6. end to end: the robot forward at batch 256 -------------------
    robot_sess, robot_plain = sessions["robot"]
    pair = {"cuda": robot_sess, "torch": robot_plain}
    frames = np.random.default_rng(13).normal(
        size=(BATCH,) + tuple(robot_sess.input_shape)).astype(np.float32)
    x = torch.from_numpy(frames).to(dev)
    reset_counts()
    fwd = {"cuda": [], "torch": []}
    e2e = {}
    with torch.inference_mode():
        for backend in ("torch", "cuda", "cuda", "torch"):
            mod = pair[backend].backend.module
            fwd[backend].append(events_ms(
                torch, lambda: [mod(x) for _ in range(10)], 10))
        for backend, sess in pair.items():
            mod = sess.backend.module
            busy_ms, wall_ms = device_busy(
                torch, lambda: [mod(x) for _ in range(10)])
            e2e[backend] = dict(
                forward_ms=statistics.median(fwd[backend]),
                forward_ms_turns=fwd[backend],
                profiled_busy_ms=busy_ms / 10,
                profiled_wall_ms=wall_ms / 10,
                device_busy_share=busy_ms / wall_ms)
    for backend, sess in pair.items():
        e2e[backend]["latency_us_b1"] = sess.benchmark(iters=200, warmup=20)
    torch.cuda.synchronize()
    launches["e2e"] = counts()
    emit("e2e", net="robot", batch=BATCH, **e2e, launches=launches["e2e"])

    # -- 7. serve the robot detector -------------------------------------
    frames = np.random.default_rng(11).normal(
        size=(256,) + tuple(robot_sess.input_shape)).astype(np.float32)

    def serve():
        with InferenceServer(robot_sess, config=ServerConfig(
                workers=2, max_batch=32)) as srv:
            handles = [srv.submit(f) for f in frames]
            outs = [h.result(timeout=60) for h in handles]
            return outs, srv.stats()

    reset_counts()
    t0 = time.perf_counter()
    outs, st = serve()
    wall_s = time.perf_counter() - t0
    assert st["completed"] == len(frames), st
    assert st["failed"] == st["timeouts"] == 0, st
    for i, (o, f) in enumerate(zip(outs, frames)):
        compare(torch.from_numpy(o), torch.from_numpy(robot_sess.predict(f)),
                1e-5, 1e-6, f"served frame {i}")
    # the same frames again, under the profiler: the card's busy time
    # over the wall time of that run
    busy_ms, traced_wall_ms = device_busy(torch, serve)
    torch.cuda.synchronize()
    launches["serve"] = counts()
    emit("serve", frames=len(frames), wall_s=wall_s,
         latency_p50_us=st["latency_p50_us"],
         latency_p99_us=st["latency_p99_us"], qps=st["qps"],
         batches=st["batches"], batch_size_mean=st["batch_size_mean"],
         batch_occupancy=st["batch_occupancy"],
         traced_wall_ms=traced_wall_ms, traced_device_busy_ms=busy_ms,
         traced_device_busy_share=busy_ms / traced_wall_ms,
         launches=launches["serve"])

    # -- 8. the kernels line ---------------------------------------------
    for phase, got in launches.items():
        for kernel, n in got.items():
            assert n > 0, f"phase {phase} launched no {kernel} kernel"
    kernels = []
    for kernel, rs in rows.items():
        t_bytes = sum(bound(r["nbytes"], r["ops"])[2] for r in rs)
        t_ops = sum(bound(r["nbytes"], r["ops"])[3] for r in rs)
        source, replaces = KERNELS[kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(got[kernel] for got in launches.values()),
            "max_abs_err": err[kernel],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rs),
            "layers": len(rs), "batch": BATCH})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
