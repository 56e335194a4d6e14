#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order, each printing one JSON line (``time`` one per robot
layer, ``lm_main`` and ``lm_serve`` one per arch); any failure
propagates and the script exits non-zero:

1. device    — the card's name and power limit (the raw ``nvidia-smi``
   line, also printed on its own), torch and CUDA versions, and PyTorch's
   TF32 switches as they stand (the script leaves them at their
   defaults);
2. build     — the hand-written CUDA kernels built from
   ``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels/``:
   seconds, and ptxas's register and spill counts;
3. kernels   — the CNN kernels held against their plain PyTorch versions
   (``kernels/ref.py``) on the card: conv2d on every conv shape of the
   four optimized nets at the main path's batches, the JAX suite's cases
   and a c_out that is no multiple of the thread block (fp32 at 1e-5,
   bf16 at 3e-2); maxpool2d on the JAX suite's cases and the robot's
   pools, exact;
4. time      — per robot layer at batch 256: the kernel, its plain
   version and one PyTorch library call (cuDNN with TF32 off for that
   call only), CUDA events around a replayed CUDA graph, median of
   repeats; bytes, fp32 operations and the bound;
5. main      — ``InferenceSession(backend="cuda")`` against
   ``backend="torch"`` on the card at rtol 1e-4 / atol 1e-5, with the
   TF32 switches at PyTorch's defaults until the ``"torch"`` backend sets
   cuDNN's itself: the robot detector on 64 frames, ball, pedestrian and
   residual on 8; the robot also against the CPU on 4 frames;
6. e2e       — the robot forward at batch 256 with the input on the card,
   on both backends in turns, the card's busy share under the profiler,
   and batch-1 ``session.benchmark()``;
7. serve     — 256 robot frames through ``InferenceServer(workers=2,
   max_batch=32)``, each equal to ``session.predict`` (rtol 1e-5 /
   atol 1e-6); latency percentiles, QPS, batch occupancy, and the card's
   busy share while serving;
8. lm_kernels — flash attention and the linear scan against their plain
   versions on the card: the JAX suite's cases (flash fp32 2e-5 and
   bf16 3e-2; scan fp32 1e-4 and bf16 5e-2), the archs' head dims, and
   the main path's shapes; every bf16 output also within one rounding
   (2**-8 relative) of the fp32 function of the same inputs; the scan's
   two-halves state carry at 1e-5;
9. lm_time   — per LM kernel at the main path's shapes (gemma3-4b's
   global and local attention layers, rwkv6-7b's scan; batch 4, 1536
   tokens): the kernel, its plain version and the library call where
   one exists, through a replayed CUDA graph; bytes, operations and the
   bound;
10. lm_main  — per arch (gemma3-4b, rwkv6-7b) at full published width in
   bf16 with random weights from seed 0: ``LMSession(backend="cuda-lm")``
   with the kernel policy and with the plain policy on 4 prompts of 1536
   tokens, ``max_context`` 2048, 16 new tokens, each run's kernel
   launches counted from 0 (one per attention or RWKV layer of the
   prefill for the kernel policy, none for the plain); prefill and
   decode tokens/s, the card's busy share, the greedy-token agreement,
   and the last prefill logits of both policies against the same weights
   run in fp32 (there the policies agree within ``LM_FP32_REL_TOL``; in
   bf16 the kernel policy is no further from fp32 than
   ``LM_BF16_FACTOR`` times the plain one); the bf16 hidden states'
   distance from the fp32 model's after every layer; then the arch's
   ``.smoke()`` config in fp32, where both policies give the same
   tokens;
11. lm_serve — per arch, 5 requests through ``LMTokenServer(workers=1)``:
   each result equals ``session.generate`` on the same prompts;
12. the kernels line — per kernel: launches in phases 5-7 (CNN) or 10-11
   (LM: the kernel policy's run in ``lm_main``, the server's in
   ``lm_serve``), each counted from 0 and read as it ends, max error, and
   the kernel's, plain version's, bound's and library's ms per robot
   forward at batch 256 or per LM prefill;
13. the last line — ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
# cores, dense bf16 tensor-core rate
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
BATCH = 256
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
               "src/repro/kernels/conv2d.py:31"),
    "maxpool2d": ("src/repro_torch/kernels/csrc/maxpool2d.cu",
                  "src/repro/kernels/maxpool2d.py:17"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:26"),
    "linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan.py:31"),
}
# the LM main path: 4 prompts of 1536 tokens (longer than gemma3-4b's
# window of 1024, so its ring caches roll), 16 new tokens
LM_ARCHS = ("gemma3-4b", "rwkv6-7b")
LM_BATCH, LM_PROMPT, LM_CONTEXT, LM_NEW = 4, 1536, 2048, 16
# The kernel and plain policies compute the same function.  In fp32 at
# full width their sums differ in order only (relative ~1e-7 an op), and
# 1e-3 in relative L2 of the last prefill logits leaves room for that
# to grow through 32-34 layers.  In bf16 (8 significant bits) both
# policies round at the same places, but a rounding that falls the
# other way grows through the random-weight layers to 0.1 (rwkv6-7b,
# measured; the JAX package's own bf16 model drifts as far, see
# tests/test_torch_lm_model.py): there the kernel policy must lie no
# further from the fp32 model than LM_BF16_FACTOR times the plain
# policy's distance (plus the fp32 allowance, the precision to which
# that model is known).  The measured ratio is 0.98-0.99.
LM_FP32_REL_TOL = 1e-3
LM_BF16_FACTOR = 1.2
# A bf16 kernel output is its fp32 result rounded once: within half a
# unit in the last place, 2**-8 of the value, of the fp32 function of the
# same (upcast) inputs; atol covers fp32 sums in another order near 0.
BF16_ROUND_RTOL, BF16_ROUND_ATOL = 2.0 ** -8, 1e-5
FLASH_CASES = [  # (b, hq, hkv, t, d, causal, window): the JAX suite's
    (1, 4, 4, 128, 32, True, None), (2, 8, 2, 128, 64, True, None),
    (1, 4, 1, 256, 32, True, 64), (1, 2, 2, 128, 32, False, None),
    (1, 4, 2, 192, 64, True, 100),
    # the archs' head dims, ragged T, every row masked (window 0)
    (1, 4, 2, 77, 120, True, 16), (2, 4, 4, 100, 128, False, 30),
    (1, 2, 1, 33, 16, True, 0)]
SCAN_CASES = [(1, 64, 2, 8, 16), (2, 128, 4, 16, 16), (1, 96, 1, 4, 8),
              (1, 33, 2, 32, 80)]  # (b, t, h, n, m)


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


def device_busy(torch, fn, top: int = 8):
    """Run ``fn()`` under the profiler; returns (busy_ms, wall_ms, by
    kernel): the time in which the card ran at least one kernel or copy
    (the union of the device-side events, so overlapping streams count
    once), the host wall time of the window, which ends in a
    synchronize, and the ``top`` device kernels by summed time as
    ``[name, ms, launches]``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        ms, n = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e3, wall, [[name, ms, n] for name, (ms, n) in ranked]


def bound(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by, bytes_ms, ops_ms) on the published peaks."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import linear_scan as scan_mod
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

    counted = {"conv2d": conv_mod, "maxpool2d": pool_mod,
               "flash_attention": flash_mod, "linear_scan": scan_mod}

    def counts():
        return {name: mod.launches for name, mod in counted.items()}

    def reset_counts():
        for mod in counted.values():
            mod.launches = 0

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
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
    def fp32_cudnn_ms(fn):
        """The library call's time with cuDNN in fp32 for that call only
        (the same function as the kernel's); the script is single-
        threaded here, and the switch returns to PyTorch's default."""
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return graph_ms(torch, fn)

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
            library_ms=fp32_cudnn_ms(lambda: F.conv2d(
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
            (r["bound_ms"], r["bound_by"], r["bytes_ms"],
             r["ops_ms"]) = bound(r["nbytes"], r["ops"])
            emit("time", kernel=kernel, **r)

    # -- 5. the main path: sessions on the card --------------------------
    reset_counts()
    main_out, sessions = {}, {}
    tf32_before = torch.backends.cudnn.allow_tf32
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
    emit("main", nets=main_out, launches=launches["main"],
         cudnn_allow_tf32_before=tf32_before,
         cudnn_allow_tf32_after=torch.backends.cudnn.allow_tf32)

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
            busy_ms, wall_ms, _ = device_busy(
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
    busy_ms, traced_wall_ms, _ = device_busy(torch, serve)
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

    # -- 8. LM kernels against their plain versions ----------------------
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.engine import CudaLMBackend, LMConfig, LMSession
    from repro_torch.models.kernel_policy import (DEFAULT_KERNELS,
                                                  PLAIN_KERNELS)
    from repro_torch.kernels.ref import attention_ref, linear_scan_ref
    from repro_torch.models.lm import embed_tokens, param_count
    from repro_torch.models.stack import (apply_block, init_params,
                                          stack_blocks)
    from repro_torch.serve import LMTokenServer

    gemma, rwkv = ARCHS["gemma3-4b"], ARCHS["rwkv6-7b"]
    heads = (gemma.n_heads, gemma.n_kv_heads, gemma.head_dim)
    rwkv_h, rwkv_n = rwkv.d_model // rwkv.ssm_head_dim, rwkv.ssm_head_dim
    layers = gemma.prologue + gemma.pattern * gemma.n_groups
    flash_main = {  # layer kind -> (window, launches per prefill)
        "global": (None, layers.count("A")),
        "local": (gemma.window, layers.count("L"))}
    f32, bf16 = torch.float32, torch.bfloat16

    def attn_inputs(b, hq, hkv, t, d, dtype, model_layout=False):
        """q, k, v as (B,H,T,D); with ``model_layout`` as the model hands
        them over: (B,T,H,D) activations viewed transposed."""
        if model_layout:
            return [rand((b, t, h, d), dtype).transpose(1, 2)
                    for h in (hq, hkv, hkv)]
        return [rand((b, h, t, d), dtype) for h in (hq, hkv, hkv)]

    def scan_inputs(b, t, h, n, m, dtype):
        decay = (torch.sigmoid(rand((b, t, h, n))) * 0.5 + 0.5).to(dtype)
        return ([decay] + [rand(shape, dtype, 0.3) for shape in
                           ((b, t, h, n), (b, t, h, m), (b, t, h, n))]
                + [rand((b, h, n, m), f32, 0.1)])

    def rel_l2_t(got, want):
        return float((got.float() - want).norm() / want.norm())

    def upcast(*ts):
        return [a.float() for a in ts]

    lm_err = {"flash_attention": {}, "linear_scan": {}}
    main_rel_l2 = {}  # bf16 kernel vs fp32 function, the main shapes
    for dtype, tol in ((f32, 2e-5), (bf16, 3e-2)):
        cases = [c + (False,) for c in FLASH_CASES] + [
            (LM_BATCH, *heads[:2], LM_PROMPT, heads[2], True, w, True)
            for w, _ in flash_main.values()]
        for b, hq, hkv, t, d, causal, window, model_layout in cases:
            q, k, v = attn_inputs(b, hq, hkv, t, d, dtype, model_layout)
            what = f"flash_attention {dtype} {(b, hq, hkv, t, d, window)}"
            o = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
            e = compare(o, attention_ref(q, k, v, causal=causal,
                                         window=window), tol, tol, what)
            if dtype == bf16:
                o32 = attention_ref(*upcast(q, k, v), causal=causal,
                                    window=window)
                compare(o.float(), o32, BF16_ROUND_RTOL, BF16_ROUND_ATOL,
                        what + " vs fp32")
                if model_layout:
                    main_rel_l2[f"flash_attention window={window}"] = (
                        rel_l2_t(o, o32))
            key = str(dtype).replace("torch.", "")
            lm_err["flash_attention"][key] = max(
                lm_err["flash_attention"].get(key, 0.0), e)
    for dtype, tol in ((f32, 1e-4), (bf16, 5e-2)):
        for b, t, h, n, m in SCAN_CASES + [
                (LM_BATCH, LM_PROMPT, rwkv_h, rwkv_n, rwkv_n)]:
            args = scan_inputs(b, t, h, n, m, dtype)
            (y, s_t), (y_ref, s_ref) = (scan_mod.linear_scan_cuda(*args),
                                        linear_scan_ref(*args))
            what = f"linear_scan {dtype} {(b, t, h, n, m)}"
            e = max(compare(y, y_ref, tol, tol, what),
                    compare(s_t, s_ref, tol, tol, what + " state"))
            if dtype == bf16:
                y32, s32 = linear_scan_ref(*upcast(*args))
                compare(y.float(), y32, BF16_ROUND_RTOL, BF16_ROUND_ATOL,
                        what + " vs fp32")
                compare(s_t, s32, 1e-4, 1e-4, what + " state vs fp32")
                if t == LM_PROMPT:
                    main_rel_l2["linear_scan"] = rel_l2_t(y, y32)
            key = str(dtype).replace("torch.", "")
            lm_err["linear_scan"][key] = max(
                lm_err["linear_scan"].get(key, 0.0), e)
    # two half scans, the second from the first's final state, equal one
    decay, k, v, r, s0 = scan_inputs(1, 64, 2, 4, 8, f32)
    y_full, s_full = scan_mod.linear_scan_cuda(decay, k, v, r, s0)
    halves = [[a[:, i:i + 32].contiguous() for a in (decay, k, v, r)]
              for i in (0, 32)]
    y1, s1 = scan_mod.linear_scan_cuda(*halves[0], s0)
    y2, s2 = scan_mod.linear_scan_cuda(*halves[1], s1)
    carry_err = max(compare(torch.cat([y1, y2], 1), y_full, 1e-5, 1e-5,
                            "scan state carry"),
                    compare(s2, s_full, 1e-5, 1e-5, "scan state carry"))
    torch.cuda.synchronize()
    emit("lm_kernels", flash_cases=len(cases), scan_cases=len(SCAN_CASES) + 1,
         tolerance={"flash_attention": {"float32": 2e-5, "bfloat16": 3e-2},
                    "linear_scan": {"float32": 1e-4, "bfloat16": 5e-2},
                    "bfloat16_vs_fp32": {"rtol": BF16_ROUND_RTOL,
                                         "atol": BF16_ROUND_ATOL},
                    "state_carry": 1e-5},
         max_abs_err=lm_err, state_carry_err=carry_err,
         bf16_main_shape_rel_l2_vs_fp32=main_rel_l2)

    # -- 9. LM kernel time at the main path's shapes ---------------------
    lm_rows = {"flash_attention": [], "linear_scan": []}
    t = LM_PROMPT
    for kind, (window, per_prefill) in flash_main.items():
        q, k, v = attn_inputs(LM_BATCH, *heads[:2], t, heads[2], bf16, True)
        qi = torch.arange(t, device=dev)[:, None]
        kj = torch.arange(t, device=dev)[None, :]
        mask = (kj <= qi) & ((qi - kj) < (window or t))
        o = flash_mod.flash_attention_cuda(q, k, v, window=window)
        if window is None:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        compare(library(), o, 3e-2, 3e-2, f"library attention {kind}")
        lm_rows["flash_attention"].append(dict(
            layer=kind, window=window, per_prefill=per_prefill,
            q=list(q.shape), k=list(k.shape), dtype="bfloat16",
            ms=graph_ms(torch, lambda: flash_mod.flash_attention_cuda(
                q, k, v, window=window)),
            plain_ms=graph_ms(torch, lambda: attention_ref(
                q, k, v, window=window), reps=3),
            library_ms=graph_ms(torch, library),
            nbytes=nbytes(q, k, v, o),
            ops=4 * LM_BATCH * heads[0] * heads[2] * int(mask.sum()),
            ops_rate="bf16 tensor cores, 989 TFLOP/s"))
    args = scan_inputs(LM_BATCH, t, rwkv_h, rwkv_n, rwkv_n, f32)
    y, s_t = scan_mod.linear_scan_cuda(*args)
    lm_rows["linear_scan"].append(dict(
        layer="rwkv6 time mix", per_prefill=rwkv.n_layers,
        shape=list(args[2].shape), dtype="float32",
        ms=graph_ms(torch, lambda: scan_mod.linear_scan_cuda(*args)),
        plain_ms=graph_ms(torch, lambda: linear_scan_ref(*args), reps=1),
        library_ms=None, nbytes=nbytes(*args, y, s_t),
        ops=5 * LM_BATCH * t * rwkv_h * rwkv_n * rwkv_n,
        ops_rate="fp32 outside the tensor cores, 67 TFLOP/s"))
    for kernel, rs in lm_rows.items():
        rate = BF16_OPS_PER_S if kernel == "flash_attention" else None
        for r in rs:
            (r["bound_ms"], r["bound_by"], r["bytes_ms"],
             r["ops_ms"]) = bound(r["nbytes"], r["ops"],
                                  rate or FP32_OPS_PER_S)
            emit("lm_time", kernel=kernel, **r)

    # -- 10-11. the LM main path and serving, one arch at a time ---------
    def timed_generate(sess, prompts, max_new):
        """Greedy tokens, the prefill's last logits, and the seconds of
        the prefill and of the decode steps (each ends on the host)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, handle = sess.prefill(prompts)
        t1 = time.perf_counter()
        tok = np.argmax(logits, axis=-1).astype(np.int32)
        out = [tok]
        for _ in range(max_new - 1):
            tok = np.argmax(sess.decode(handle, tok), axis=-1).astype(
                np.int32)
            out.append(tok)
        return np.stack(out, axis=1), logits, t1 - t0, time.perf_counter() - t1

    def lm_session(arch, params=None, smoke=False, **pins):
        return LMSession(config=SessionConfig(backend="cuda-lm", lm=LMConfig(
            arch=arch, smoke=smoke, max_context=LM_CONTEXT,
            decode_batch=LM_BATCH, **pins)), params=params)

    def tree_float(tree):
        if isinstance(tree, dict):
            return {k: tree_float(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [tree_float(v) for v in tree]
        return tree.float()

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    policies = {"kernels": DEFAULT_KERNELS, "plain": PLAIN_KERNELS}

    def layer_drift(cfg, params, params32, prompts):
        """Per layer, the relative L2 distance of the bf16 hidden states
        from the fp32 model's on the same weights and prompts: carried
        through the stack under each policy, and of one bf16 layer (the
        kernel policy) fed the fp32 model's input to that layer."""
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        tok = torch.from_numpy(prompts.astype(np.int64)).to(dev)
        positions = torch.arange(tok.shape[1], device=dev)[None].expand(
            *tok.shape)
        out = {"kernels": [], "plain": [], "one_layer": []}
        with torch.inference_mode():
            x32 = embed_tokens(params32, cfg32, tok)
            xs = {name: embed_tokens(params, cfg, tok) for name in policies}
            for (kind, p16, _), (_, p32, _) in zip(
                    stack_blocks(params, cfg), stack_blocks(params32, cfg32)):
                y32 = apply_block(x32, kind, p32, cfg32, DEFAULT_KERNELS,
                                  positions=positions)
                one = apply_block(x32.to(bf16), kind, p16, cfg,
                                  DEFAULT_KERNELS, positions=positions)
                out["one_layer"].append(rel_l2_t(one, y32))
                for name, policy in policies.items():
                    xs[name] = apply_block(xs[name], kind, p16, cfg, policy,
                                           positions=positions)
                    out[name].append(rel_l2_t(xs[name], y32))
                x32 = y32
        return out

    plain_pins = dict(attn_variant="reference", scan_variant="chunked")
    lm_kernel_of = {"gemma3-4b": "flash_attention", "rwkv6-7b": "linear_scan"}
    per_prefill = {"flash_attention": sum(n for _, n in flash_main.values()),
                   "linear_scan": rwkv.n_layers}

    def lm_phases(arch: str) -> None:
        """lm_main and lm_serve of one arch; its weights and sessions are
        freed when this returns."""
        cfg = ARCHS[arch]
        kernel = lm_kernel_of[arch]
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        kern = lm_session(arch, params)
        plain = lm_session(arch, params, **plain_pins)
        prompts = np.random.default_rng(21).integers(
            0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
        for sess in (kern, plain):  # first calls: allocator, cuBLAS
            sess.generate(prompts[:, :128], 2)
        # the main path: one prefill and LM_NEW - 1 decode steps through
        # each session, counted from 0; the kernel policy launches its
        # kernel once per layer of the prefill and never in decode, the
        # plain policy never
        runs, run_launches = {}, {}
        for name, sess in (("kernels", kern), ("plain", plain)):
            reset_counts()
            toks, logits, pre_s, dec_s = timed_generate(sess, prompts, LM_NEW)
            torch.cuda.synchronize()
            run_launches[name] = counts()
            if logits.shape != (LM_BATCH, cfg.vocab_size) or not np.isfinite(
                    logits).all():
                raise AssertionError(f"{arch} {name}: bad logits "
                                     f"{logits.shape}")
            runs[name] = dict(tokens=toks, logits=logits, prefill_s=pre_s,
                              decode_s=dec_s)
        launches["lm_main " + arch] = run_launches["kernels"]
        want_launches = {k: per_prefill[kernel] if k == kernel else 0
                         for k in counted}
        if run_launches != {"kernels": want_launches,
                            "plain": dict.fromkeys(counted, 0)}:
            raise AssertionError(f"{arch}: main-path launches {run_launches}, "
                                 f"want {want_launches} and none")
        lk, lp = runs["kernels"]["logits"], runs["plain"]["logits"]
        tk, tp = runs["kernels"]["tokens"], runs["plain"]["tokens"]
        # the same weights and prompts through the fp32 model, both
        # policies: the reference the bf16 runs are measured against
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_float(params)
        l32 = {name: CudaLMBackend(
            cfg32, params=params32, max_context=LM_CONTEXT,
            decode_batch=LM_BATCH, policy=policy).prefill(prompts)[0]
            for name, policy in policies.items()}
        drift = layer_drift(cfg, params, params32, prompts)
        del params32
        rel = {"fp32_kernels_vs_plain": rel_l2(l32["kernels"], l32["plain"]),
               "bf16_kernels_vs_plain": rel_l2(lk, lp),
               "bf16_kernels_vs_fp32": rel_l2(lk, l32["plain"]),
               "bf16_plain_vs_fp32": rel_l2(lp, l32["plain"])}
        busy_ms, wall_ms, top = device_busy(
            torch, lambda: kern.generate(prompts, LM_NEW))
        # the smoke config in fp32: both policies give the same tokens
        small = np.random.default_rng(22).integers(
            0, 256, size=(2, 20)).astype(np.int32)
        sk = lm_session(arch, smoke=True)
        sp = lm_session(arch, sk.backend.params, smoke=True, **plain_pins)
        (stk, slk, _, _), (stp, slp, _, _) = (
            timed_generate(s_, small, 8) for s_ in (sk, sp))
        if not np.array_equal(stk, stp):
            raise AssertionError(f"{arch} smoke: greedy tokens differ")
        smoke_err = compare(torch.from_numpy(slk), torch.from_numpy(slp),
                            1e-4, 1e-4, f"{arch} smoke logits")
        torch.cuda.synchronize()
        tokens_in, tokens_out = LM_BATCH * LM_PROMPT, LM_BATCH * (LM_NEW - 1)
        emit("lm_main", arch=arch, n_params=param_count(cfg),
             dtype=cfg.dtype, batch=LM_BATCH, prompt=LM_PROMPT,
             max_context=LM_CONTEXT, new_tokens=LM_NEW,
             **{f"{name}_{key}": value for name, r in runs.items()
                for key, value in (
                    ("prefill_s", r["prefill_s"]),
                    ("prefill_tok_s", tokens_in / r["prefill_s"]),
                    ("decode_s", r["decode_s"]),
                    ("decode_tok_s", tokens_out / r["decode_s"]))},
             logits_rel_l2=rel, fp32_rel_tol=LM_FP32_REL_TOL,
             bf16_factor=LM_BF16_FACTOR, layer_drift_rel_l2=drift,
             logits_max_abs_diff=float(np.abs(lk - lp).max()),
             logits_max_abs=float(np.abs(lp).max()),
             greedy_agreement=float((tk == tp).mean()),
             first_token_agreement=float((tk[:, 0] == tp[:, 0]).mean()),
             profiled_wall_ms=wall_ms, profiled_device_busy_ms=busy_ms,
             device_busy_share=busy_ms / wall_ms, top_device_kernels=top,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             smoke=dict(dtype="float32", tokens_equal=True,
                        max_abs_err=smoke_err),
             launches=run_launches["kernels"],
             launches_plain=run_launches["plain"])
        if not rel["fp32_kernels_vs_plain"] <= LM_FP32_REL_TOL:
            raise AssertionError(f"{arch}: fp32 prefill logits, kernel vs "
                                 f"plain policy: {rel}")
        if not (rel["bf16_kernels_vs_fp32"] <= LM_BF16_FACTOR
                * rel["bf16_plain_vs_fp32"] + LM_FP32_REL_TOL):
            raise AssertionError(f"{arch}: bf16 kernel policy further from "
                                 f"the fp32 model than the plain: {rel}")

        short = prompts[0, :700]
        want_short = kern.generate(short[None], 8)[0]
        reset_counts()
        t0 = time.perf_counter()
        with LMTokenServer(kern, config=ServerConfig(
                workers=1, max_batch=8, batch_deadline_ms=500.0,
                request_timeout_ms=None)) as srv:
            futs = [srv.submit(p_, max_new=LM_NEW) for p_ in prompts]
            futs.append(srv.submit(short, max_new=8))
            outs = [f.result(timeout=600) for f in futs]
            st = srv.stats()
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches["lm_serve " + arch] = counts()
        # the four long prompts rode one generate call: the same batch as
        # the kernel run of lm_main; the short one rode alone
        if not (np.array_equal(np.stack(outs[:LM_BATCH]), tk)
                and np.array_equal(outs[-1], want_short)):
            raise AssertionError(f"{arch}: served tokens differ from "
                                 f"session.generate")
        emit("lm_serve", arch=arch, requests=len(futs), wall_s=wall_s,
             tokens_out=LM_BATCH * LM_NEW + 8,
             tokens_out_per_s=(LM_BATCH * LM_NEW + 8) / wall_s,
             latency_p50_us=st["latency_p50_us"],
             latency_p99_us=st["latency_p99_us"], batches=st["batches"],
             batch_size_mean=st["batch_size_mean"],
             launches=launches["lm_serve " + arch])

    for arch in LM_ARCHS:
        lm_phases(arch)
        torch.cuda.empty_cache()

    # -- 12. the kernels line --------------------------------------------
    for phase, got in launches.items():
        want = ([lm_kernel_of[phase.split()[1]]] if phase.startswith("lm_")
                else ["conv2d", "maxpool2d"])
        for kernel in want:
            assert got[kernel] > 0, f"phase {phase} launched no {kernel}"
    kernels = []
    for kernel, rs in {**rows, **lm_rows}.items():
        per = [r.get("per_prefill", 1) for r in rs]
        t_bytes = sum(n * r["bytes_ms"] for n, r in zip(per, rs))
        t_ops = sum(n * r["ops_ms"] for n, r in zip(per, rs))
        source, replaces = KERNELS[kernel]
        lib = [r["library_ms"] for r in rs]
        entry = {
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(got[kernel] for got in launches.values()),
            "max_abs_err": (err[kernel] if kernel in err
                            else lm_err[kernel]["float32"]),
            "ms": sum(n * r["ms"] for n, r in zip(per, rs)),
            "plain_ms": sum(n * r["plain_ms"] for n, r in zip(per, rs)),
            "bound_ms": sum(n * r["bound_ms"] for n, r in zip(per, rs)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (None if None in lib else
                           sum(n * x for n, x in zip(per, lib)))}
        if kernel in rows:
            entry.update(per="robot forward", layers=len(rs), batch=BATCH)
        else:
            arch = {v: a for a, v in lm_kernel_of.items()}[kernel]
            entry.update(per=f"{arch} prefill", launches_per_prefill=sum(per),
                         batch=LM_BATCH, tokens=LM_PROMPT)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
