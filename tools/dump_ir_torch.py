#!/usr/bin/env python
"""Dump the typed loop-nest IR (``repro_torch.core.lowering.Program``) a
net lowers to — the inspection window between the schedule and the C
text, from the PyTorch port's code generator.

Usage::

    python tools/dump_ir_torch.py ball                 # float build
    python tools/dump_ir_torch.py robot --int8         # calibrated int8
    python tools/dump_ir_torch.py robot --int8 --device cpu
    python tools/dump_ir_torch.py residual --no-fusion # legacy layout
    python tools/dump_ir_torch.py ball --simd sse --stages 2 --bodies

Prints each nest with its loop structure (``~`` marks unrolled loops),
kernel kind/variant, epilogue chain (requant, activation, fused
Add/pool/Concat consumers), and the planned arena buffers with byte
offsets and live ranges.  ``--bodies`` inlines the rendered C lines of
every kernel span.  ``--c`` prints the rendered translation unit
instead (what ``render(program)`` — and therefore ``compile()`` —
emits).  ``--int8`` calibrates on the card unless ``--device`` names
another device; without a card it stops rather than fall back to the
CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import cnn_paper  # noqa: E402
from repro_torch.core import codegen, passes  # noqa: E402
from repro_torch.core.cgen import CodegenOptions  # noqa: E402
from repro_torch.core.lowering import format_program, render  # noqa: E402
from repro_torch.core.schedule import make_schedule  # noqa: E402

NETS = {
    "ball": cnn_paper.ball_classifier,
    "pedestrian": cnn_paper.pedestrian_classifier,
    "robot": cnn_paper.robot_detector,
    "residual": cnn_paper.residual_cnn,
}


def dump(target, schedule, *, simd: str = "generic", bodies: bool = False,
         c: bool = False) -> str:
    """The text the tool prints for ``target`` (a float graph or a
    quantized graph) lowered under ``schedule``: the rendered C with
    ``c``, else the ``# schedule:`` line and the formatted program."""
    _, program = codegen.lower(target, CodegenOptions(simd=simd),
                               schedule=schedule)
    if c:
        return render(program)
    return (f"# schedule: {schedule.describe()}\n"
            f"{format_program(program, bodies=bodies)}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("net", choices=sorted(NETS),
                    help="bench net to lower")
    ap.add_argument("--int8", action="store_true",
                    help="calibrate (synthetic frames) and lower the "
                         "quantized build")
    ap.add_argument("--per-channel", action="store_true",
                    help="with --int8: per-channel requant zero points")
    ap.add_argument("--simd", default="generic",
                    help="kernel variant (default: generic)")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stage count (default: 1)")
    ap.add_argument("--no-fusion", action="store_true",
                    help="legacy unfused schedule")
    ap.add_argument("--bodies", action="store_true",
                    help="inline the rendered C lines of each kernel")
    ap.add_argument("--c", action="store_true",
                    help="print the rendered C instead of the IR")
    ap.add_argument("--device", default=None,
                    help="with --int8: the calibration's device (default: "
                         "the card, cuda:0)")
    args = ap.parse_args(argv)

    graph = passes.optimize(NETS[args.net]())
    target = graph
    if args.int8:
        from repro_torch.core import quantize
        from repro_torch.core.torch_exec import resolve_device
        from repro_torch.data.pipeline import camera_frame_batch
        device = resolve_device(args.device)
        calib = camera_frame_batch(16, graph.input_shape, seed=0)
        target = quantize.quantize(graph, np.asarray(calib),
                                   method="percentile",
                                   per_channel=args.per_channel,
                                   device=device)
    schedule = make_schedule(graph, fusion=not args.no_fusion,
                             nstages=args.stages)
    sys.stdout.write(dump(target, schedule, simd=args.simd,
                          bodies=args.bodies, c=args.c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
