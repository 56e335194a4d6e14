#!/usr/bin/env python
"""CI gate for the paper's "plain ANSI C" claim, on the PyTorch port's
code generator.

Generates the C file for the paper's ball CNN, the residual DAG config
and a pooling/Concat DAG (generic SIMD mode — the intrinsics headers are
deliberately out of scope for ANSI), then compiles each with

    gcc -std=c89 -Wall -Wextra -Werror -pedantic-errors

Any warning, any C99-ism (mid-block declarations, ``//`` comments,
``for (int ...``, bare ``restrict``) fails the build.  Exercises both
the fully-unrolled (weights-as-literals) and rolled (const-array)
emission paths, the epilogue-fused and unfused schedules, and the
layer-pipelined (stage functions + ``<func>_pipeline`` driver) builds
— float and int8.  The int8 cases calibrate on the card unless
``--device`` names another device (``--device cpu`` off the card).

Exit codes: 0 every case compiles, 1 a case fails, 2 no C compiler.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.cnn_paper import (  # noqa: E402
    ball_classifier, residual_cnn,
)
from repro_torch.core import cgen, codegen, passes, quantize  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    fusable_concats, fusable_pools, make_schedule,
)
from repro_torch.core.torch_exec import resolve_device  # noqa: E402

STRICT_FLAGS = ["-std=c89", "-Wall", "-Wextra", "-Werror",
                "-pedantic-errors"]


def pool_concat_dag():
    """Branchy DAG exercising the pooling/Concat fused epilogues: a
    MaxPool and an AvgPool each absorbed into their producer conv, a
    two-edge fused Concat, and (under ``:pc``) a per-channel-requanted
    stem whose zero-point table feeds the epilogue."""
    from repro_torch.core.graph import (
        AvgPool, CNNGraph, Concat, Conv2D, Input, MaxPool,
    )
    rng = np.random.default_rng(11)

    def conv(kh, kw, ci, co, **kw_args):
        return Conv2D(
            weights=rng.normal(0, 0.5, (kh, kw, ci, co)).astype(
                np.float32),
            bias=rng.normal(0, 0.1, (co,)).astype(np.float32),
            **kw_args)

    return CNNGraph([
        Input(shape=(12, 12, 2), name="in"),
        conv(3, 3, 2, 20, padding="valid", activation="relu", name="s"),
        conv(1, 1, 20, 16, activation="relu", name="pm"),
        MaxPool(size=(2, 2), name="mp"),
        conv(1, 1, 20, 16, activation="leaky_relu", name="pa",
             inputs=["s"]),
        AvgPool(size=(2, 2), name="ap"),
        conv(3, 3, 16, 16, padding="same", name="cb1", inputs=["mp"]),
        conv(1, 1, 16, 16, name="cb2", inputs=["ap"]),
        Concat(name="cat", inputs=["cb1", "cb2"]),
        conv(1, 1, 32, 7, name="head"),
    ])


# (tag, builder, unroll, quant method or None, nstages, fusion);
# a ":pc" method suffix selects per-channel requant zero points
CASES = [
    ("ball-unrolled", ball_classifier, 0, None, 1, True),
    ("ball-rolled", ball_classifier, None, None, 1, True),
    # DAG config (Add/Concat/depthwise) — fused schedule folds the
    # residual Adds into their producer conv loops
    ("residual-fused", residual_cnn, None, None, 1, True),
    ("residual-unfused", residual_cnn, None, None, 1, False),
    # layer-pipelined float build: stage functions, interface buffers,
    # the <func>_pipeline driver — all must survive -std=c89
    ("residual-pipe2", residual_cnn, None, None, 2, True),
    # post-training-quantized builds, one per calibration method (the
    # requant constants differ; the emitted C must stay strict-ANSI
    # regardless of how the ranges were selected)
    ("ball-int8", ball_classifier, None, "minmax", 1, True),
    ("ball-int8-mse", ball_classifier, None, "mse", 1, True),
    # quantized DAG build: per-branch Concat requant under percentile,
    # fused int8 epilogues
    ("residual-int8", residual_cnn, None, "percentile", 1, True),
    # layer-pipelined int8 build
    ("residual-int8-pipe2", residual_cnn, None, "percentile", 2, True),
    # pooling/Concat fused epilogues (MaxPool + AvgPool absorbed into
    # their producer loops, fused Concat slice stores) — float, int8,
    # and int8 with per-channel requant zero-point tables
    ("poolcat-fused", pool_concat_dag, None, None, 1, True),
    ("poolcat-int8", pool_concat_dag, None, "minmax", 1, True),
    ("poolcat-int8-pc", pool_concat_dag, None, "minmax:pc", 1, True),
]


def case_graph(tag, builder):
    """The case's optimized float graph (ISA width 1, as generic C
    takes it); the poolcat cases must keep their fusable pools and
    Concat."""
    g = passes.optimize(builder(), simd_multiple=1)
    if tag.startswith("poolcat"):
        # the case exists to gate the fused pool/Concat C —
        # fail loudly if the optimizer ever defeats that shape
        assert fusable_pools(g) and fusable_concats(g), tag
    return g


def calibration_frames(graph) -> np.ndarray:
    """The 8 normal frames every int8 case calibrates on."""
    return np.random.default_rng(0).normal(
        size=(8,) + tuple(graph.input_shape)).astype(np.float32)


def case_unit(graph, method, device):
    """``graph`` itself for a float case; else its int8 build calibrated
    on :func:`calibration_frames` on ``device`` by ``method`` (a ``:pc``
    suffix: per-channel zero points, which must then be emitted)."""
    if method is None:
        return graph
    method, _, pc = method.partition(":")
    unit = quantize.quantize(graph, calibration_frames(graph),
                             method=method, per_channel=pc == "pc",
                             device=device)
    if pc == "pc":
        assert unit.channel_acts, \
            "per-channel case must emit zero-point tables"
    return unit


def compile_unit(unit, unroll, nstages, fusion) -> str:
    """The generic C source of ``unit`` (a float graph or a quantized
    graph) under the case's unroll, stage count and fusion."""
    graph = unit.graph if isinstance(unit, quantize.QuantizedGraph) \
        else unit
    opts = cgen.CodegenOptions(simd="generic", unroll=unroll)
    sched = make_schedule(graph, nstages=nstages, fusion=fusion)
    return codegen.compile(unit, opts, schedule=sched).source


def strict_compile(cc, src, tag, tmp) -> subprocess.CompletedProcess:
    """``cc`` under :data:`STRICT_FLAGS` on ``src``, to an object only."""
    c_path = os.path.join(tmp, f"{tag}.c")
    with open(c_path, "w") as f:
        f.write(src)
    return subprocess.run([cc, *STRICT_FLAGS, "-c", c_path, "-o",
                           c_path + ".o"], capture_output=True, text=True)


def find_cc():
    return shutil.which("gcc") or shutil.which("cc")


def run_cases(cc, device, tmp):
    """Generate and strictly compile every case, in order; yields
    ``(tag, source bytes, CompletedProcess)``."""
    for tag, builder, unroll, method, nstages, fusion in CASES:
        unit = case_unit(case_graph(tag, builder), method, device)
        src = compile_unit(unit, unroll, nstages, fusion)
        yield tag, len(src), strict_compile(cc, src, tag, tmp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the int8 cases' calibration device (default: "
                         "the card, cuda:0)")
    args = ap.parse_args(argv)
    gcc = find_cc()
    if gcc is None:
        print("strict_c89: no C compiler found", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    failures = 0
    with tempfile.TemporaryDirectory() as tmp:
        for tag, nbytes, proc in run_cases(gcc, device, tmp):
            if proc.returncode == 0:
                print(f"strict_c89: {tag}: OK ({nbytes} bytes)")
            else:
                failures += 1
                print(f"strict_c89: {tag}: FAILED\n{proc.stderr[:4000]}",
                      file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
