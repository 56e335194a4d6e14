"""Unified codegen front-end: one ``compile()`` for both precisions (the
port's copy of the JAX package's ``core/codegen.py``).

:func:`compile` is the generator's one entry point: a single call
returning a frozen :class:`GeneratedSource` value object — source text
plus everything a loader, cache key or report needs (entry symbols,
workspace sizes, arena stats).

A :class:`~repro_torch.core.schedule.Schedule` (epilogue fusion + pipeline
stage assignment) rides along: the default schedule fuses every
eligible Add/pool/Concat epilogue (bitwise-identical output, smaller
arena) and emits a single stage; pass
``schedule=make_schedule(g, nstages=k)`` for the layer-pipelined build.

Since the loop-nest IR split, generation is two explicit phases:
:func:`lower` produces a typed :class:`~repro_torch.core.lowering.Program`
(loop nests, kernel variants, epilogue chains, planned buffers) and
:func:`~repro_torch.core.lowering.render` turns it into the C string —
``compile()`` does both and keeps the ``Program`` on the result for
inspection.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .cgen import (CODEGEN_VERSION, CGenerator, CodegenOptions,
                   QuantCGenerator)
from .lowering import Program, render
from .quantize import QuantizedGraph
from .schedule import Schedule, make_schedule

__all__ = ["GeneratedSource", "compile", "lower", "CodegenOptions",
           "Schedule", "make_schedule", "Program", "render",
           "CODEGEN_VERSION"]


@dataclass(frozen=True)
class GeneratedSource:
    """One generated C translation unit plus its ABI and plan summary.

    ``workspace_elems`` is the size (in ``elem_bytes``-sized elements)
    of the caller-supplied workspace for the ``entry_ws`` /
    ``entry_batch_ws`` / ``entry_pipeline`` entries: the liveness-packed
    arena (``arena_elems``) plus, for pipelined builds, the stage
    interface buffers (``iface_elems``, one per stage boundary).
    """

    source: str
    func_name: str
    precision: str                       # 'fp32' | 'int8'
    simd: str
    codegen_version: int
    schedule: Schedule
    # entry symbols (None when not emitted for this build)
    entry: str
    entry_ws: str
    entry_batch: Optional[str]
    entry_batch_ws: Optional[str]
    entry_pipeline: Optional[str]        # None for single-stage builds
    stage_entries: Tuple[str, ...] = ()
    # sizes (elements are floats for fp32, bytes for int8)
    workspace_elems: int = 0
    elem_bytes: int = 4
    arena_elems: int = 0
    iface_elems: Tuple[int, ...] = ()
    in_elems: int = 0
    out_elems: int = 0
    # arena plan summary (bytes)
    arena_bytes: int = 0
    arena_buffer_sum_bytes: int = 0
    peak_live_bytes: int = 0
    per_layer_live_bytes: Optional[Dict[str, int]] = None
    # the lowered IR the source was rendered from (identity-compared
    # only: Program is mutable and not part of the value semantics)
    program: Optional[Program] = field(default=None, compare=False)

    @property
    def workspace_bytes(self) -> int:
        return self.workspace_elems * self.elem_bytes

    @property
    def nstages(self) -> int:
        return self.schedule.nstages

    def describe(self) -> Dict[str, object]:
        """JSON-able summary (no source text) for info()/telemetry."""
        return {
            "func_name": self.func_name,
            "precision": self.precision,
            "simd": self.simd,
            "codegen_version": self.codegen_version,
            "schedule": self.schedule.describe(),
            "entry_pipeline": self.entry_pipeline,
            "workspace_bytes": self.workspace_bytes,
            "arena_bytes": self.arena_bytes,
            "iface_elems": list(self.iface_elems),
        }


def lower(graph_or_qgraph, opts: Optional[CodegenOptions] = None,
          schedule: Optional[Schedule] = None):
    """Lower a graph to a :class:`~repro_torch.core.lowering.Program` without
    rendering it.  Returns ``(generator, program)`` — the generator
    carries the plan and entry-symbol metadata ``compile()`` packages.
    """
    opts = opts or CodegenOptions()
    quantized = isinstance(graph_or_qgraph, QuantizedGraph)
    graph = graph_or_qgraph.graph if quantized else graph_or_qgraph
    if schedule is None:
        schedule = make_schedule(graph, fusion=True, nstages=1)
    gen = (QuantCGenerator(graph_or_qgraph, opts, schedule=schedule)
           if quantized else CGenerator(graph, opts, schedule=schedule))
    return gen, gen.lower()


def compile(graph_or_qgraph, opts: Optional[CodegenOptions] = None,
            schedule: Optional[Schedule] = None) -> GeneratedSource:
    """Generate ANSI C for a float :class:`~repro_torch.core.graph.CNNGraph`
    or a calibrated :class:`~repro_torch.core.quantize.QuantizedGraph`.

    ``schedule=None`` builds the default: every eligible Add/pool/
    Concat epilogue fused (output bitwise identical to the unfused
    graph, arena never larger), single stage.
    ``make_schedule(g, fusion=False)`` reproduces the legacy layout
    byte-for-byte; ``make_schedule(g, nstages=k)`` adds the
    ``<func>_stage<i>`` / ``<func>_pipeline`` entries for
    layer-pipelined execution.
    """
    opts = opts or CodegenOptions()
    quantized = isinstance(graph_or_qgraph, QuantizedGraph)
    graph = graph_or_qgraph.graph if quantized else graph_or_qgraph
    if schedule is None:
        schedule = make_schedule(graph, fusion=True, nstages=1)
    gen = (QuantCGenerator(graph_or_qgraph, opts, schedule=schedule)
           if quantized else CGenerator(graph, opts, schedule=schedule))
    program = gen.lower()
    source = render(program)
    plan = gen.plan
    S = schedule.nstages
    peak = max(plan.per_layer_live.values(), default=0) * plan.elem_bytes
    return GeneratedSource(
        source=source,
        func_name=opts.func_name,
        precision="int8" if quantized else "fp32",
        simd=opts.simd,
        codegen_version=CODEGEN_VERSION,
        schedule=schedule,
        entry=opts.func_name,
        entry_ws=opts.ws_func_name,
        entry_batch=opts.batch_func_name if opts.emit_batch else None,
        entry_batch_ws=(opts.batch_ws_func_name if opts.emit_batch
                        else None),
        entry_pipeline=opts.pipeline_func_name if S > 1 else None,
        stage_entries=gen.stage_syms,
        workspace_elems=gen.ws_total_elems,
        elem_bytes=plan.elem_bytes,
        arena_elems=plan.total_floats,
        iface_elems=gen.iface_elems,
        in_elems=int(np.prod(graph.input_shape)),
        out_elems=int(np.prod(graph.output_shape)),
        arena_bytes=gen.ws_total_elems * plan.elem_bytes,
        arena_buffer_sum_bytes=plan.buffer_sum_bytes,
        peak_live_bytes=peak,
        per_layer_live_bytes={k: v * plan.elem_bytes
                              for k, v in plan.per_layer_live.items()},
        program=program,
    )
