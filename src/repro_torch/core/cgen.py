"""NNCG — the ANSI C code generator (paper §II); the port's copy of
the JAX package's ``core/cgen.py``, which emits the same C byte for byte
but for the banner's first line.

Generates, from a trained :class:`CNNGraph` (a DAG — residual Adds,
Concats, depthwise convs and pooling all supported), one plain C file
exposing:

    void <func>_ws(const float *x, float *out, float *workspace);
    void <func>(const float *x, float *out);          /* static arena */
    void <func>_batch(const float *x, float *out, int n);
    long <func>_workspace_floats(void);

implementing the four design principles:

* **P1 unroll levels** — per-layer ``level``: 0 = all loops unrolled
  (straight-line code), 1 = keep the outermost spatial loop, 2 = keep both
  spatial loops, ``None`` = no unrolling (plain loop nest).  Matches the
  paper: "At level 0 all loops are unrolled. Level 1 does not unroll the
  outer most loop and so forth."
* **P2 conditional moves** — activations and pooling emit the C ternary
  operator, never an ``if`` block.
* **P3 constants** — with any unrolling the trained weights are printed
  as literals into the code line; without unrolling they are emitted as
  ``static const`` arrays.  Zero padding taps are *elided entirely* at
  level 0 (a static-knowledge win no generic library has).
* **P4 SIMD structure** — three modes: ``generic`` (paper's scalar
  baseline, output-channel loop outside the tap loops), ``structured``
  (channel loop innermost over contiguous memory → auto-vectorizable),
  and ``sse`` (explicit SSSE3/SSE intrinsics over groups of 4 output
  channels, the paper's shipped mode).

**Memory**: instead of one never-reused ``static float`` buffer per
layer, a liveness-based **arena planner** (:func:`plan_arena`) computes
tensor lifetimes over the topological order and packs all intermediate
buffers — including zero-padding scratch — into one workspace via
interval-interference best-fit.  ``<func>_ws`` takes the workspace from
the caller, making the generated code **reentrant** (thread-parallel
batch serving); ``<func>`` binds the planned static arena for the
paper's single-image embedded deployment.

The emitted file is strict ANSI C89 (declarations first, no ``//``
comments, ``restrict`` behind a feature macro), so ``gcc -std=c89
-Wall -Wextra -Werror -pedantic-errors`` accepts it — the paper's
"plain C compilable by any ANSI compiler" claim, enforced in CI.  The
only dependencies are ``math.h`` (softmax) and, in ``sse``/``avx``
mode, the intrinsics header — exactly the paper's dependency set.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .graph import (
    Add,
    AvgPool,
    BatchNorm,
    CNNGraph,
    Concat,
    Conv2D,
    Dense,
    DepthwiseConv2D,
    Dropout,
    Flatten,
    GlobalAvgPool,
    Input,
    LeakyReLU,
    MaxPool,
    ReLU,
    Softmax,
    pool_window_counts,
)

from .lowering import (
    AddFuse,
    Buffer,
    ConcatFuse,
    Epilogue,
    FuseNode,
    KernelCall,
    Loop,
    LoopNest,
    PoolFuse,
    Program,
    render,
)
from .numerics import flit
from .schedule import Schedule, make_schedule  # noqa: F401  (re-export)

Level = Optional[int]  # 0 | 1 | 2 | None (no unroll)

# bump whenever the emitted C changes for the same (graph, options) —
# cached artifacts measured on older generated code must not be reused
CODEGEN_VERSION = 8

# the single source of truth for the unroll/icache emission budget
# (both CodegenOptions.term_budget and choose_levels read it)
TERM_BUDGET_DEFAULT = 60_000

# layers that emit no code: Input is the function argument, Dropout is
# identity at inference, Flatten is a no-op on flat NHWC memory
IDENTITY_LAYERS = (Input, Dropout, Flatten)


@dataclass(frozen=True)
class ISA:
    """Vector instruction-set descriptor (P4). The paper ships SSSE3 and
    names AVX as future work — ``avx`` implements it (8-wide + FMA)."""

    name: str
    width: int
    reg: str
    header: str
    cc_flags: tuple
    prefix: str

    def load(self, ptr: str) -> str:
        return f"{self.prefix}_loadu_ps(&{ptr})"

    def store(self, ptr: str, reg: str) -> str:
        return f"{self.prefix}_storeu_ps(&{ptr}, {reg});"

    def set1(self, x: str) -> str:
        return f"{self.prefix}_set1_ps({x})"

    def zero(self) -> str:
        return f"{self.prefix}_setzero_ps()"

    def add(self, a: str, b: str) -> str:
        return f"{self.prefix}_add_ps({a}, {b})"

    def mul(self, a: str, b: str) -> str:
        return f"{self.prefix}_mul_ps({a}, {b})"

    def vmax(self, a: str, b: str) -> str:
        return f"{self.prefix}_max_ps({a}, {b})"

    def fmadd(self, a: str, b: str, c: str) -> str:
        """a*b + c."""
        if self.name == "avx":
            return f"{self.prefix}_fmadd_ps({a}, {b}, {c})"
        return self.add(c, self.mul(a, b))

    def set_lits(self, vals) -> str:
        lits = ", ".join(_flit(v) for v in reversed(list(vals)))
        return f"{self.prefix}_set_ps({lits})"


SSE = ISA(name="sse", width=4, reg="__m128", header="emmintrin.h",
          cc_flags=("-mssse3",), prefix="_mm")
AVX = ISA(name="avx", width=8, reg="__m256", header="immintrin.h",
          cc_flags=("-mavx2", "-mfma"), prefix="_mm256")
ISAS = {"sse": SSE, "avx": AVX}


@dataclass(frozen=True)
class QISA:
    """Int8 dot-product kernel descriptor — the integer analogue of
    :class:`ISA`, one entry per tiled kernel variant.

    The quantized conv/dense emitters tile ``group`` output channels
    into one int32 accumulator vector and fold ``lane_taps`` input taps
    into every 32-bit lane per dot-product instruction; the requant
    epilogue (rescale, activation, round-half-up, zero point, saturate)
    runs vectorized on the same accumulator, so int8 results go from
    register file to arena without a scalar round trip.

    ``unsigned_x`` marks the u8·s8 instructions (``vpmaddubsw``,
    ``vpdpbusd``): activations are re-biased to unsigned by XORing the
    sign bit and the matching ``128 * sum(w)`` correction is folded into
    the int32 bias (:meth:`QuantizedGraph.effective_bias`), keeping the
    accumulator bit-identical to the signed variants.

    ``cpu_flags`` are the /proc/cpuinfo tokens the compiled object
    needs at *load* time; :func:`repro_torch.core.runtime.resolve_int8_simd`
    walks ``fallback`` until it reaches a variant the host supports, so
    e.g. an AVX-512-VNNI .so is never loaded on a non-VNNI machine.
    """

    name: str
    arch: str                 # 'x86' | 'arm'
    group: int                # output channels per accumulator vector
    lane_taps: int            # taps folded into each 32-bit lane
    header: str
    cc_flags: tuple
    cpu_flags: tuple          # /proc/cpuinfo tokens required to run
    unsigned_x: bool = False  # u8*s8 dot: x codes re-biased by +128
    fallback: Optional[str] = None  # next-best variant when unsupported

    @property
    def wide(self) -> bool:
        """256-bit x86 variant (group of 8) vs 128-bit (group of 4)."""
        return self.group == 8


QISAS = {
    # SSE2 pair-madd: 2 sign-extended int16 taps per lane,
    # _mm_madd_epi16 (exact: every i16*i16 pair sum fits int32)
    "sse": QISA(name="sse", arch="x86", group=4, lane_taps=2,
                header="emmintrin.h", cc_flags=("-mssse3",),
                cpu_flags=("ssse3",), fallback="generic"),
    # AVX2 pair-madd: the 256-bit _mm256_madd_epi16 form
    "avx": QISA(name="avx", arch="x86", group=8, lane_taps=2,
                header="immintrin.h", cc_flags=("-mavx2", "-mfma"),
                cpu_flags=("avx2", "fma"), fallback="sse"),
    # AVX2 u8*s8 quad: vpmaddubsw + vpmaddwd(1).  vpmaddubsw saturates
    # its int16 pair sums, so this variant is emitted per layer ONLY
    # when the trained weights *prove* saturation impossible
    # (maddubsw_safe); otherwise the layer falls back to pair-madd.
    "avx_ubs": QISA(name="avx_ubs", arch="x86", group=8, lane_taps=4,
                    header="immintrin.h", cc_flags=("-mavx2", "-mfma"),
                    cpu_flags=("avx2", "fma"), unsigned_x=True,
                    fallback="avx"),
    # AVX-512-VNNI u8*s8 quad on 256-bit registers: one vpdpbusd per 4
    # taps x 8 channels, products widened to int32 before summing —
    # exact for every weight, no saturation proof needed
    "avx_vnni": QISA(name="avx_vnni", arch="x86", group=8, lane_taps=4,
                     header="immintrin.h",
                     cc_flags=("-mavx512vnni", "-mavx512vl",
                               "-mavx512bw", "-mavx512f",
                               "-mavx2", "-mfma"),
                     cpu_flags=("avx512f", "avx512bw", "avx512vl",
                                "avx512_vnni"),
                     unsigned_x=True, fallback="avx"),
    # NEON baseline (every ARMv8-A core): widening multiply-accumulate,
    # one vmlal_s16 per tap x 4 channels
    "neon": QISA(name="neon", arch="arm", group=4, lane_taps=1,
                 header="arm_neon.h", cc_flags=(),
                 cpu_flags=("asimd",), fallback="generic"),
    # ARMv8.2 dot product: one s8*s8 vdotq_s32 per 4 taps x 4 channels
    "neon_dot": QISA(name="neon_dot", arch="arm", group=4, lane_taps=4,
                     header="arm_neon.h",
                     cc_flags=("-march=armv8.2-a+dotprod",),
                     cpu_flags=("asimddp",), fallback="neon"),
}

# channel-group chunk cap: at most 8 int32 accumulator vectors live at
# once (plus the broadcast and a weight load, the 16-register budget of
# SSE/AVX/NEON); wider layers run multiple passes per output position
_QTILE_MAX_GROUPS = 8


@dataclass
class CodegenOptions:
    simd: str = "sse"            # 'generic' | 'structured' | 'sse' | 'avx'
                                 # int8 builds additionally accept the
                                 # QISAS kernel variants ('avx_ubs',
                                 # 'avx_vnni', 'neon', 'neon_dot')
    unroll: Union[Level, Dict[str, Level]] = 0
    func_name: str = "nncg_net"
    term_budget: int = TERM_BUDGET_DEFAULT
    # max emitted FMA terms per layer before the level is demoted
    # (icache trade-off)
    emit_batch: bool = True      # also emit `<func>_batch(x, out, n)` —
                                 # a loop-over-images serving entry point

    @property
    def isa(self) -> Optional[ISA]:
        return ISAS.get(self.simd)

    @property
    def batch_func_name(self) -> str:
        return self.func_name + "_batch"

    @property
    def batch_ws_func_name(self) -> str:
        """Reentrant batch entry: N images through one foreign call,
        caller-provided workspace — the serving worker-pool hot path."""
        return self.func_name + "_batch_ws"

    @property
    def ws_func_name(self) -> str:
        """The reentrant entry point taking a caller-provided workspace."""
        return self.func_name + "_ws"

    @property
    def pipeline_func_name(self) -> str:
        """Multi-stage entry: `<func>_pipeline(x, out, ws, nstages)` —
        emitted when the schedule has more than one stage."""
        return self.func_name + "_pipeline"

    @property
    def pipeline_nstages_func_name(self) -> str:
        return self.func_name + "_pipeline_nstages"

    def stage_func_name(self, s: int) -> str:
        """Per-stage function of the pipelined build."""
        return f"{self.func_name}_stage{s}"

    @property
    def ws_size_func_name(self) -> str:
        return self.func_name + "_workspace_floats"

    @property
    def ws_bytes_func_name(self) -> str:
        """Workspace size entry of the quantized build (int8 arena)."""
        return self.func_name + "_workspace_bytes"

    def level_for(self, layer_name: str) -> Level:
        if isinstance(self.unroll, dict):
            return self.unroll.get(layer_name, None)
        return self.unroll


# float32 -> shortest round-trip C literal (paper P3) — shared with the
# quantizer so printed constants are bit-identical across modules
_flit = flit


# most-negative finite float32 — the padding fill for max pooling (C89
# has no INFINITY); a window always covers >=1 valid tap, so the fill
# can never be the result
_NEG_FLT_MAX = _flit(np.finfo(np.float32).min)


def _cfor(var: str, bound, body: str, start: int = 0, step: int = 1) -> str:
    """A one-line C89 counted loop: the index is declared in its own
    block so the statement is legal anywhere."""
    inc = f"++{var}" if step == 1 else f"{var} += {step}"
    return (f"{{ int {var}; for ({var} = {start}; {var} < {bound}; {inc}) "
            f"{body} }}")


class _W:
    """Tiny indented writer."""

    def __init__(self) -> None:
        self.lines: List[str] = []
        self._ind = 0

    def __call__(self, line: str = "") -> None:
        self.lines.append("    " * self._ind + line if line else "")

    def open(self, line: str) -> None:
        self(line + " {" if line else "{")
        self._ind += 1

    def close(self) -> None:
        self._ind -= 1
        self("}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def estimate_terms(layer, in_shape, level: Level) -> int:
    """Emitted multiply-add terms for a conv/pool at an unroll level —
    the code-size side of the paper's unroll/icache trade-off."""
    if isinstance(layer, Conv2D):
        oh, ow, co = layer.out_shape(in_shape)
        taps = layer.kh * layer.kw * layer.c_in
        per_out = taps
        n_out = {0: oh * ow * co, 1: ow * co, 2: co}.get(level, 0)
        return n_out * per_out if level is not None else taps
    if isinstance(layer, MaxPool):
        oh, ow, c = layer.out_shape(in_shape)
        taps = layer.size[0] * layer.size[1]
        n_out = {0: oh * ow * c, 1: ow * c, 2: c}.get(level, 0)
        return n_out * taps if level is not None else taps
    return 0


def effective_level(layer, in_shape, opts: "CodegenOptions") -> Level:
    """The unroll level actually emitted: the configured level, demoted
    until the emitted-term count fits the budget (icache trade-off, P1).
    The arena planner calls this too, so scratch planning and emission
    can never disagree."""
    level = opts.level_for(layer.name)
    while level is not None and \
            estimate_terms(layer, in_shape, level) > opts.term_budget:
        level = {0: 1, 1: 2, 2: None}[level]
    return level


def enumerate_variants(layer, in_shape, term_cap: int = 200_000) -> List[Level]:
    """Candidate unroll levels for one layer, deepest (level 0) first.

    This is the variant space the paper benchmarks per layer ("we
    independently benchmark every code version and select the one with
    the best runtime performance").  Levels whose emitted-term count
    exceeds ``term_cap`` are dropped — they would blow the icache (and
    the compile time) before they could win; ``None`` (rolled loops) is
    always feasible.  Returns ``[]`` for layers with no codegen variants.
    """
    if not isinstance(layer, (Conv2D, MaxPool)):
        return []
    return [lvl for lvl in (0, 1, 2, None)
            if lvl is None or estimate_terms(layer, in_shape, lvl) <= term_cap]


def choose_levels(graph: CNNGraph,
                  budget: int = TERM_BUDGET_DEFAULT) -> Dict[str, Level]:
    """Pick, per layer, the deepest unroll level within the term budget.

    This is the static analogue of the paper's per-layer variant
    benchmarking — the :mod:`repro_torch.engine.autotune` tuner explores the
    same :func:`enumerate_variants` space dynamically and can override
    any choice made here.  Walks the DAG via edges, so branch layers get
    their true input shapes.
    """
    levels: Dict[str, Level] = {}
    smap = graph.shape_map()
    for layer in graph.layers:
        ish = smap[layer.inputs[0]] if layer.inputs else None
        for lvl in enumerate_variants(layer, ish, term_cap=budget):
            levels[layer.name] = lvl
            break
    return levels


# ---------------------------------------------------------------------------
# arena planning (liveness over the topological order)
# ---------------------------------------------------------------------------


@dataclass
class ArenaInterval:
    """One planned allocation: a value live over ``[start, end]`` layer
    steps, placed at ``offset`` floats into the arena.  ``align`` (in
    arena elements) constrains the placement — int32 scratch inside the
    int8 byte arena plans with ``align=4``."""

    value: str
    start: int
    end: int
    size: int
    offset: int = -1
    align: int = 1


@dataclass
class ArenaPlan:
    """The packed workspace: element offsets for every intermediate
    tensor (and padding scratch), sized by interval interference.

    Elements are float32 for the float path and int8 for the quantized
    path (``elem_bytes`` 4 vs 1) — ``total_floats`` keeps its historic
    name but counts *elements*."""

    total_floats: int
    offsets: Dict[str, int] = field(default_factory=dict)
    intervals: List[ArenaInterval] = field(default_factory=list)
    per_layer_live: Dict[str, int] = field(default_factory=dict)
    buffer_sum_floats: int = 0  # what one-static-buffer-per-tensor costs
    elem_bytes: int = 4

    @property
    def total_bytes(self) -> int:
        return self.total_floats * self.elem_bytes

    @property
    def buffer_sum_bytes(self) -> int:
        return self.buffer_sum_floats * self.elem_bytes

    @property
    def peak_live_floats(self) -> int:
        return max(self.per_layer_live.values(), default=0)


def _value_map(graph: CNNGraph, quantized: bool = False,
               schedule: Optional[Schedule] = None) -> Dict[str, str]:
    """Layer name -> the value (buffer) holding its output. Identity
    layers alias their producer; Input aliases the ``x`` argument — in
    quantized mode the input is itself quantized into an arena buffer
    (``xq``), so Input *defines* a value.

    Under a fusing ``schedule``, a fused producer writes straight into
    its consumer's buffer (Add, pool or Concat) — its own tensor never
    exists, so its name aliases the consumer's value.  (No identity
    layer can alias a fused producer: every fusion predicate requires
    the consumer to be the producer's sole consumer.)"""
    val: Dict[str, str] = {}
    for l in graph.layers:
        if isinstance(l, Input):
            val[l.name] = "xq" if quantized else "x"
        elif isinstance(l, (Dropout, Flatten)):
            val[l.name] = val[l.inputs[0]]
        else:
            val[l.name] = l.name
    if schedule is not None:
        for p, cname in schedule.fused_by_producer.items():
            val[p] = val[cname]
    return val


def _pad_scratch_elems(layer, in_shape, opts: CodegenOptions,
                       elide_static: bool = True) -> int:
    """Elements of padding scratch the emitter will request for this
    layer (0 when padding is statically elided or absent).

    ``elide_static=False`` is the quantized planner's view: the int8
    emitters are rolled (no unroll levels), so padding scratch is
    always materialized."""
    if not isinstance(layer, (Conv2D, DepthwiseConv2D, MaxPool, AvgPool)):
        return 0
    pads = layer.pad_amounts(in_shape)
    if not any(pads):
        return 0
    if elide_static and isinstance(layer, (Conv2D, MaxPool)) and \
            effective_level(layer, in_shape, opts) == 0:
        return 0  # level 0 elides out-of-bounds taps statically
    h, w, c = in_shape
    pt, pb, pl, pr = pads
    return (h + pt + pb) * (w + pl + pr) * c


def _pack_qweights(wt: np.ndarray, co: int, kh: int, row: int,
                   G: int, L: int) -> Tuple[np.ndarray, int]:
    """Tile int8 weight codes for the register-blocked kernels.

    ``wt`` is ``(co, kh*row)`` (taps of one output channel contiguous,
    window rows of ``row`` taps).  Returns ``(packed, P)`` where ``P =
    ceil(row/L)`` lane blocks per window row and ``packed`` is the flat
    ``[n][p][g][k][l]`` layout: for window row ``n`` and lane block
    ``p``, the ``G*L`` codes of channel group ``g`` sit contiguously —
    lane ``k`` holds the ``L`` consecutive taps of output channel
    ``g*G+k`` (zero-padded past the row end), which is exactly the
    operand layout of one madd/dpbusd/dot against a broadcast of those
    ``L`` input taps.  Only the ``(co // G) * G`` fully-grouped channels
    are packed; the remainder runs the per-channel fallback loop."""
    ng = co // G
    P = -(-row // L)
    full = np.zeros((ng * G, kh, P * L), dtype=np.int64)
    full[:, :, :row] = wt[:ng * G].reshape(ng * G, kh, row)
    packed = full.reshape(ng, G, kh, P, L).transpose(2, 3, 0, 1, 4)
    return np.ascontiguousarray(packed).reshape(-1), P


def maddubsw_safe(wt: np.ndarray, co: int, kh: int, row: int) -> bool:
    """Static saturation proof for the ``avx_ubs`` variant.

    ``vpmaddubsw`` sums each pair of adjacent u8*s8 products into a
    *saturating* int16.  With activations re-biased to u8 (0..255), the
    pair over weights ``(a, b)`` spans ``[255*min(a,0)+255*min(b,0),
    255*max(a,0)+255*max(b,0)]`` — in range iff the positive pair sum
    is <= 128 and the negative pair sum is >= -128.  The weights are
    compile-time constants (paper P3), so this is decidable per layer:
    eligible layers get the 4-tap maddubsw kernel, the rest fall back
    to the always-exact pair-madd tile in the same build."""
    packed, _ = _pack_qweights(wt, co, kh, row, G=8, L=4)
    pairs = packed.reshape(-1, 2)
    pos = np.clip(pairs, 0, None).sum(axis=1)
    neg = np.clip(pairs, None, 0).sum(axis=1)
    return bool(pos.max(initial=0) <= 128 and neg.min(initial=0) >= -128)


def maddubsw_any_eligible(qgraph) -> bool:
    """True when at least one conv/dense layer of ``qgraph`` would
    actually use the u8*s8 ``vpmaddubsw`` scheme under 'avx_ubs'.
    When no layer qualifies the variant degenerates layer-by-layer to
    the 'avx' pair-madd build, so it isn't worth enumerating."""
    for layer in qgraph.graph.layers:
        if isinstance(layer, Conv2D):
            co = int(layer.weights.shape[3])
            kh, row = layer.kh, layer.kw * layer.c_in
            wt = np.transpose(qgraph.weights[layer.name].w_q,
                              (3, 0, 1, 2)).reshape(co, kh * row)
        elif isinstance(layer, Dense):
            wt = qgraph.weights[layer.name].w_q.T
            co, row = wt.shape
            kh = 1
        else:
            continue
        if co >= QISAS["avx_ubs"].group and maddubsw_safe(wt, co, kh, row):
            return True
    return False


def plan_arena(graph: CNNGraph,
               opts: Optional[CodegenOptions] = None,
               *, quantized: bool = False,
               schedule: Optional[Schedule] = None) -> ArenaPlan:
    """Liveness-planned packing of every intermediate tensor.

    A value is live from the step of its defining layer to the step of
    its last consumer (interval interference over the topological
    order); padding scratch is live only during its own layer.  The
    network input (``x``) and output (``out``) are caller memory and
    never enter the arena — except in quantized mode, where the int8
    code of the input (``xq``) is itself an arena value.  Placement is
    first-fit at the lowest offset not overlapping any time-overlapping
    interval — for chains this degenerates to ping-pong double
    buffering, for DAGs the skip edges extend lifetimes exactly as long
    as needed.  Quantized plans are in int8 elements (1 byte each), the
    ~4x memory win the int8 path exists for.

    Under a fusing ``schedule`` a fused producer *defines* its
    consumer's value (the store happens inside the producer's loop), so
    the interval starts at the producer's step — the earliest producer
    for a multi-edge fused Concat — and is sized by the *consumer's*
    shape (equal for Add, smaller for a fused pool, larger for a fused
    Concat slice); the consumer's own step only extends lifetimes (the
    other operands are read there in the unfused reference semantics,
    and reading them during the producer's loop is covered because
    their intervals span it).
    """
    opts = opts or CodegenOptions()
    smap = graph.shape_map()
    val = _value_map(graph, quantized, schedule)
    out_value = val[graph.sink.name]
    fused_by_p = schedule.fused_by_producer if schedule is not None else {}

    defs: Dict[str, int] = {}
    last: Dict[str, int] = {}
    sizes: Dict[str, int] = {}
    ivals: List[ArenaInterval] = []
    for i, layer in enumerate(graph.layers):
        if quantized and isinstance(layer, Input):
            defs["xq"] = i
            sizes["xq"] = int(np.prod(smap[layer.name]))
        elif not isinstance(layer, IDENTITY_LAYERS):
            v = val[layer.name]
            defines = v == layer.name or fused_by_p.get(layer.name) == v
            if defines and v not in defs:  # first (producer) def wins
                defs[v] = i
                sizes[v] = int(np.prod(smap[v]))
            scratch = _pad_scratch_elems(layer, smap[layer.inputs[0]],
                                         opts, elide_static=not quantized)
            if scratch:
                ivals.append(ArenaInterval(
                    value=layer.name + "__pad", start=i, end=i,
                    size=scratch))
        for src in layer.inputs:
            sv = val[src]
            if sv != "x":
                last[sv] = i
    for v, d in defs.items():
        if v == out_value:
            continue  # written straight to the caller's `out`
        ivals.append(ArenaInterval(value=v, start=d,
                                   end=last.get(v, d), size=sizes[v]))

    if quantized and schedule is not None:
        # int32 window-sum scratch for fused average pools: the
        # producer's stores accumulate here, the finalize pass requants
        # — live only during the producer's step, 4-byte aligned
        step = {l.name: i for i, l in enumerate(graph.layers)}
        for p, cname in getattr(schedule, "fused_pools", ()):
            if isinstance(graph.layer(cname), AvgPool):
                i = step[p]
                ivals.append(ArenaInterval(
                    value=cname + "__acc", start=i, end=i,
                    size=int(np.prod(smap[cname])) * 4, align=4))

    # first-fit placement over interfering intervals
    ivals.sort(key=lambda iv: (iv.start, -iv.size, iv.value))
    placed: List[ArenaInterval] = []
    for iv in ivals:
        overlap = [p for p in placed
                   if not (iv.end < p.start or p.end < iv.start)]
        for cand in sorted({0} | {p.offset + p.size for p in overlap}):
            cand = -(-cand // iv.align) * iv.align
            if all(cand + iv.size <= p.offset or p.offset + p.size <= cand
                   for p in overlap):
                iv.offset = cand
                break
        placed.append(iv)

    total = max((iv.offset + iv.size for iv in placed), default=0)
    per_layer_live = {
        layer.name: sum(iv.size for iv in placed
                        if iv.start <= i <= iv.end)
        for i, layer in enumerate(graph.layers)
    }
    return ArenaPlan(
        total_floats=total,
        offsets={iv.value: iv.offset for iv in placed},
        intervals=placed,
        per_layer_live=per_layer_live,
        buffer_sum_floats=sum(iv.size for iv in placed),
        elem_bytes=1 if quantized else 4,
    )


# ---------------------------------------------------------------------------
# code generation
# ---------------------------------------------------------------------------


def _cname(value: str) -> str:
    """Sanitize a value name into a C identifier."""
    return "t_" + re.sub(r"[^0-9A-Za-z_]", "_", value)


# back-compat alias: the Add fusion context now lives in the lowering
# IR module alongside the pool/concat variants
_FuseCtx = AddFuse


class CGenerator:
    def __init__(self, graph: CNNGraph, opts: CodegenOptions,
                 schedule: Optional[Schedule] = None):
        self.g = graph
        self.opts = opts
        self.schedule = schedule if schedule is not None else \
            make_schedule(graph, fusion=True, nstages=1)
        self.w = _W()
        self.decls = _W()
        self._uid = 0
        self._epi: Optional[FuseNode] = None   # active store-site fusion
        self._stage = 0                        # pipeline stage being emitted
        self.nests: List[LoopNest] = []        # lowered IR, filled by lower()
        self.plan: Optional[ArenaPlan] = None  # filled by lower()
        self._program: Optional[Program] = None  # lower() result, cached
        self.ws_total_elems: int = 0           # arena + stage interfaces
        self.iface_elems: Tuple[int, ...] = ()
        self.stage_syms: Tuple[str, ...] = ()

    @property
    def _fuse(self) -> Optional[AddFuse]:
        """The active Add fusion context, if any — the legacy view used
        by the Add-specific store paths."""
        return self._epi if isinstance(self._epi, AddFuse) else None

    @property
    def _pool_fuse(self) -> Optional[PoolFuse]:
        return self._epi if isinstance(self._epi, PoolFuse) else None

    @property
    def _concat_fuse(self) -> Optional[ConcatFuse]:
        return self._epi if isinstance(self._epi, ConcatFuse) else None

    # -- helpers ------------------------------------------------------------

    def uid(self) -> int:
        self._uid += 1
        return self._uid

    def const_array(self, name: str, arr: np.ndarray) -> str:
        vals = ", ".join(_flit(v) for v in np.asarray(arr, np.float32).ravel())
        self.decls(f"static const float {name}[{arr.size}] = {{{vals}}};")
        return name

    def floop(self, var: str, bound, step: int = 1) -> None:
        """Open a counted loop with a C89-scoped index; pair with
        :meth:`fclose`."""
        w = self.w
        w.open("")
        w(f"int {var};")
        inc = f"++{var}" if step == 1 else f"{var} += {step}"
        w.open(f"for ({var} = 0; {var} < {bound}; {inc})")

    def fclose(self, n: int = 1) -> None:
        for _ in range(n):
            self.w.close()
            self.w.close()

    # -- activation epilogues (P2: ternary, never a branch) ------------------

    def act_scalar(self, expr: str, act: Optional[str], alpha: float) -> str:
        if act == "relu":
            return f"(({expr}) > 0.0f ? ({expr}) : 0.0f)"
        if act == "leaky_relu":
            return f"(({expr}) > 0.0f ? ({expr}) : {_flit(alpha)} * ({expr}))"
        return expr

    def act_sse(self, reg: str, act: Optional[str], alpha: float) -> List[str]:
        isa = self.opts.isa
        if act == "relu":
            return [f"{reg} = {isa.vmax(reg, isa.zero())};"]
        if act == "leaky_relu":
            # max(x, a*x) == leaky_relu(x) for 0 < a < 1 — branch-free
            return [f"{reg} = {isa.vmax(reg, isa.mul(reg, isa.set1(_flit(alpha))))};"]
        return []

    # -- fused stores (graph-level epilogue fusion) --------------------------
    #
    # With an active AddFuse the producer's store site performs the
    # downstream Add: the activated accumulator is substituted at the
    # producer's position in the Add's left-associated input-order sum,
    # then the Add's activation is applied — the exact float op order
    # of the unfused graph (emit_add), so fusion is bitwise identical.
    #
    # A PoolFuse reduces the producer's store into the pooled output
    # element its position maps to (stride == window, so each element
    # lands in exactly one window): max via the same strict-> ternary
    # chain the unfused pool emits, avg via the same in-order sum; the
    # divisor multiply runs in a finalize pass.  A ConcatFuse stores
    # straight into the producer's channel slice of the Concat output.
    # Both visit window taps / elements in the producer's row-major
    # order — the unfused op order — so float results stay bitwise.

    def _fused_rhs(self, layer, expr: str, oidx: str) -> str:
        """RHS stored for output element ``oidx`` of ``layer`` given
        its (pre-activation) accumulator expression."""
        act = layer.activation if layer.activation != "softmax" else None
        term = self.act_scalar(expr, act, layer.alpha)
        fc = self._fuse
        if fc is None:
            return term
        terms = [term if i == fc.pos else f"{s}[{oidx}]"
                 for i, s in enumerate(fc.srcs)]
        return self.act_scalar(" + ".join(terms), fc.add.activation,
                               fc.add.alpha)

    def _store_stmt(self, layer, expr: str, oidx: str, dst: str,
                    pos=None) -> str:
        """The C statement storing output element ``oidx`` (producer
        position ``pos`` = (i, j, k)) with the active epilogue chain
        applied."""
        pf, cf = self._pool_fuse, self._concat_fuse
        if pf is not None or cf is not None:
            assert pos is not None, \
                f"{layer.name}: fused store needs an output position"
        act = layer.activation if layer.activation != "softmax" else None
        if pf is not None:
            di = pf.dst_index(pos)
            term = self.act_scalar(expr, act, layer.alpha)
            if pf.kind == "max":
                return (f"{{ const float pv = {term}; {dst}[{di}] = "
                        f"pv > {dst}[{di}] ? pv : {dst}[{di}]; }}")
            return f"{dst}[{di}] += {term};"
        if cf is not None:
            return (f"{dst}[{cf.dst_index(pos)}] = "
                    f"{self.act_scalar(expr, act, layer.alpha)};")
        return f"{dst}[{oidx}] = {self._fused_rhs(layer, expr, oidx)};"

    def _store_scalar(self, layer, expr: str, oidx: str, dst: str,
                      pos=None) -> None:
        self.w(self._store_stmt(layer, expr, oidx, dst, pos))

    def _store_vec(self, layer, reg: str, oidx: str, dst: str,
                   pos=None) -> None:
        """Vector store of ``reg`` (one ISA-width channel group at flat
        output index ``oidx``), with the producer's activation and, when
        fusing, the consumer's epilogue applied in-register."""
        w, isa = self.w, self.opts.isa
        act = layer.activation if layer.activation != "softmax" else None
        for ln in self.act_sse(reg, act, layer.alpha):
            w(ln)
        pf, cf = self._pool_fuse, self._concat_fuse
        if pf is not None:
            di = pf.dst_index(pos)
            if pf.kind == "max":
                # new > old ? new : old — the scalar ternary's order
                w(f"{reg} = {isa.vmax(reg, isa.load(f'{dst}[{di}]'))};")
            else:
                # old + new — the scalar `dst += term` order
                w(f"{reg} = {isa.add(isa.load(f'{dst}[{di}]'), reg)};")
            w(isa.store(f"{dst}[{di}]", reg))
            return
        if cf is not None:
            w(isa.store(f"{dst}[{cf.dst_index(pos)}]", reg))
            return
        fc = self._fuse
        if fc is not None:
            expr = None
            for i, s in enumerate(fc.srcs):
                t = reg if i == fc.pos else isa.load(f"{s}[{oidx}]")
                expr = t if expr is None else isa.add(expr, t)
            w(f"{reg} = {expr};")
            for ln in self.act_sse(reg, fc.add.activation, fc.add.alpha):
                w(ln)
        w(isa.store(f"{dst}[{oidx}]", reg))

    # -- padding ------------------------------------------------------------

    def emit_padded_copy(self, src: str, in_shape, pads, buf: str,
                         fill: str = "0.0f"
                         ) -> Tuple[str, Tuple[int, int, int]]:
        """Materialize a padded copy (paper Eq. 1) into the planned
        arena scratch ``buf``, for the looped modes where tap bounds are
        not static.  ``fill`` is the pad value — zero for conv/avg-pool
        sums, ``-FLT_MAX`` for max pooling."""
        h, wdt, c = in_shape
        pt, pb, pl, pr = pads
        ph, pw = h + pt + pb, wdt + pl + pr
        w = self.w
        w(f"/* pad {src} with {fill}: ({h}x{wdt}x{c}) -> "
          f"({ph}x{pw}x{c}) */")
        w(_cfor("z", ph * pw * c, f"{buf}[z] = {fill};"))
        self.floop("i", h)
        w(_cfor("z", wdt * c,
                f"{buf}[((i + {pt}) * {pw} + {pl}) * {c} + z] = "
                f"{src}[i * {wdt * c} + z];"))
        self.fclose()
        return buf, (ph, pw, c)

    # -- conv ---------------------------------------------------------------

    def emit_conv(self, layer: Conv2D, in_shape, src: str, dst: str,
                  pad_buf: Optional[str] = None) -> None:
        opts, w = self.opts, self.w
        level = effective_level(layer, in_shape, opts)
        oh, ow, co = layer.out_shape(in_shape)
        sh, sw = layer.strides
        pads = layer.pad_amounts(in_shape)
        kh, kw_, ci = layer.kh, layer.kw, layer.c_in
        W_ = layer.weights  # HWIO
        B_ = layer.bias

        w(f"/* Conv2D {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} "
          f"act={layer.activation} level={level} simd={opts.simd} */")

        use_pad_buf = any(pads) and level != 0
        if use_pad_buf:
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy(src, in_shape, pads, pad_buf)
            pads = (0, 0, 0, 0)
        h, wdt, _ = in_shape
        pt, _pb, pl, _pr = pads

        literals = level is not None
        wname = bname = None
        if not literals:
            wname = self.const_array(f"w{self.uid()}", W_)
            bname = self.const_array(f"b{self.uid()}", B_)

        def x_index(i, j, n, m, o) -> str:
            """Index into src for output (i,j) tap (n,m,o); i/j may be C exprs."""
            if isinstance(i, int):
                row = i * sh + n - pt
            else:
                row = f"({i} * {sh} + {n - pt})"
            if isinstance(j, int):
                col = j * sw + m - pl
            else:
                col = f"({j} * {sw} + {m - pl})"
            if isinstance(row, int) and isinstance(col, int):
                return str((row * wdt + col) * ci + o)
            return f"(({row}) * {wdt} + ({col})) * {ci} + {o}"

        def out_index(i, j, k) -> str:
            if isinstance(i, int) and isinstance(j, int) and isinstance(k, int):
                return str((i * ow + j) * co + k)
            ke = str(k)
            return f"(({i}) * {ow} + ({j})) * {co} + {ke}"

        def in_bounds(i, j, n, m) -> bool:
            """Static OOB elision (only callable when i and j are ints)."""
            r, c = i * sh + n - pt, j * sw + m - pl
            return 0 <= r < h and 0 <= c < wdt

        def emit_body(i, j) -> None:
            static_ij = isinstance(i, int) and isinstance(j, int)
            if opts.isa is not None:
                self._conv_body_sse(layer, W_, B_, wname, bname, literals,
                                    i, j, static_ij, x_index, out_index,
                                    in_bounds, dst, src)
            else:
                self._conv_body_generic(layer, W_, B_, wname, bname, literals,
                                        i, j, static_ij, x_index, out_index,
                                        in_bounds, dst, src)

        if level == 0:
            for i in range(oh):
                for j in range(ow):
                    emit_body(i, j)
        elif level == 1:
            self.floop("i", oh)
            for j in range(ow):
                emit_body("i", j)
            self.fclose()
        elif level == 2:
            self.floop("i", oh)
            self.floop("j", ow)
            emit_body("i", "j")
            self.fclose(2)
        else:
            self.floop("i", oh)
            self.floop("j", ow)
            self._conv_loops_rolled(layer, wname, bname, in_shape,
                                    (oh, ow, co), dst, src, pads)
            self.fclose(2)

        if layer.activation == "softmax":
            self.emit_softmax((oh, ow, co), dst)

    # rolled inner loops (level=None): weights from const arrays
    def _conv_loops_rolled(self, layer, wname, bname, in_shape, out_shape,
                           dst, src, pads):
        w = self.w
        h, wdt, ci = in_shape
        oh, ow, co = out_shape
        kh, kw_ = layer.kh, layer.kw
        sh, sw = layer.strides
        pt, _, pl, _ = pads
        assert pt == 0 and pl == 0, "rolled mode uses padded buffers"
        act = layer.activation if layer.activation != "softmax" else None
        if self.opts.isa is not None:
            isa = self.opts.isa
            co4 = co - co % isa.width
            if co4:
                self.floop("k", co4, step=isa.width)
                w(f"{isa.reg} acc = {isa.load(f'{bname}[k]')};")
                self.floop("n", kh)
                self.floop("m", kw_)
                self.floop("o", ci)
                xv = f"{src}[((i * {sh} + n) * {wdt} + (j * {sw} + m)) * {ci} + o]"
                wv = f"{wname}[((n * {kw_} + m) * {ci} + o) * {co} + k]"
                w(f"acc = {isa.fmadd(isa.set1(xv), isa.load(wv), 'acc')};")
                self.fclose(3)
                self._store_vec(layer, "acc", f"(i * {ow} + j) * {co} + k",
                                dst, pos=("i", "j", "k"))
                self.fclose()
            ks = range(co4, co)
        elif self.opts.simd == "structured":
            # channel loop innermost over contiguous memory -> auto-vec
            w.open("")
            w(f"float acc[{co}];")
            w(_cfor("k", co, f"acc[k] = {bname}[k];"))
            self.floop("n", kh)
            self.floop("m", kw_)
            self.floop("o", ci)
            w(f"const float xv = {src}[((i * {sh} + n) * {wdt} + "
              f"(j * {sw} + m)) * {ci} + o];")
            w(_cfor("k", co,
                    f"acc[k] += xv * "
                    f"{wname}[((n * {kw_} + m) * {ci} + o) * {co} + k];"))
            self.fclose(3)
            w(_cfor("k", co,
                    self._store_stmt(layer, "acc[k]",
                                     f"(i * {ow} + j) * {co} + k", dst,
                                     ("i", "j", "k"))))
            w.close()
            ks = ()
        else:
            self.floop("k", co)
            w(f"float acc = {bname}[k];")
            self.floop("n", kh)
            self.floop("m", kw_)
            self.floop("o", ci)
            w(f"acc += {wname}[((n * {kw_} + m) * {ci} + o) * {co} + k] * "
              f"{src}[((i * {sh} + n) * {wdt} + (j * {sw} + m)) * {ci} + o];")
            self.fclose(3)
            self._store_scalar(layer, "acc", f"(i * {ow} + j) * {co} + k",
                               dst, pos=("i", "j", "k"))
            self.fclose()
            ks = ()
        # scalar tail for sse mode
        for k in ks:
            w.open("")
            w(f"float acc = {bname}[{k}];")
            w(_cfor("n", kh, _cfor("m", kw_, _cfor(
                "o", ci,
                f"acc += {wname}[((n * {kw_} + m) * {ci} + o) * {co} + {k}] * "
                f"{src}[((i * {sh} + n) * {wdt} + (j * {sw} + m)) * {ci} + o];"
            ))))
            self._store_scalar(layer, "acc",
                               f"(i * {ow} + j) * {co} + {k}", dst,
                               pos=("i", "j", k))
            w.close()

    # unrolled bodies --------------------------------------------------------

    def _taps(self, layer, i, j, static_ij, in_bounds):
        for n in range(layer.kh):
            for m in range(layer.kw):
                if static_ij and not in_bounds(i, j, n, m):
                    continue  # P3: zero tap elided entirely
                for o in range(layer.c_in):
                    yield n, m, o

    def _conv_body_generic(self, layer, W_, B_, wname, bname, literals,
                           i, j, static_ij, x_index, out_index, in_bounds,
                           dst, src):
        w = self.w
        co = layer.c_out
        act = layer.activation if layer.activation != "softmax" else None
        w.open("")  # scope block
        for k in range(co):
            bias = _flit(B_[k]) if literals else f"{bname}[{k}]"
            w(f"float a{k} = {bias};")
        for n, m, o in self._taps(layer, i, j, static_ij, in_bounds):
            xv = f"{src}[{x_index(i, j, n, m, o)}]"
            for k in range(co):
                wv = (_flit(W_[n, m, o, k]) if literals
                      else f"{wname}[{((n * layer.kw + m) * layer.c_in + o) * co + k}]")
                w(f"a{k} += {xv} * {wv};")
        for k in range(co):
            self._store_scalar(layer, f"a{k}", out_index(i, j, k), dst,
                               pos=(i, j, k))
        w.close()

    def _conv_body_sse(self, layer, W_, B_, wname, bname, literals,
                       i, j, static_ij, x_index, out_index, in_bounds,
                       dst, src):
        w = self.w
        isa = self.opts.isa
        vw = isa.width
        co = layer.c_out
        co4 = co - co % vw
        act = layer.activation if layer.activation != "softmax" else None
        w.open("")
        for kg in range(0, co4, vw):
            if literals:
                w(f"{isa.reg} v{kg} = "
                  f"{isa.set_lits(B_[kg:kg + vw])};")
            else:
                w(f"{isa.reg} v{kg} = {isa.load(f'{bname}[{kg}]')};")
        for n, m, o in self._taps(layer, i, j, static_ij, in_bounds):
            xv = f"{src}[{x_index(i, j, n, m, o)}]"
            w(f"{{ const {isa.reg} xb = {isa.set1(xv)};")
            for kg in range(0, co4, vw):
                if literals:
                    wreg = isa.set_lits(W_[n, m, o, kg:kg + vw])
                else:
                    off = ((n * layer.kw + m) * layer.c_in + o) * co + kg
                    wreg = isa.load(f"{wname}[{off}]")
                w(f"  v{kg} = {isa.fmadd('xb', wreg, f'v{kg}')};")
            w("}")
        for kg in range(0, co4, vw):
            self._store_vec(layer, f"v{kg}", out_index(i, j, kg), dst,
                            pos=(i, j, kg))
        # scalar tail, each channel in its own block (C89: decls first)
        for k in range(co4, co):
            bias = _flit(B_[k]) if literals else f"{bname}[{k}]"
            w.open("")
            w(f"float t{k} = {bias};")
            for n, m, o in self._taps(layer, i, j, static_ij, in_bounds):
                xv = f"{src}[{x_index(i, j, n, m, o)}]"
                wv = (_flit(W_[n, m, o, k]) if literals
                      else f"{wname}[{((n * layer.kw + m) * layer.c_in + o) * co + k}]")
                w(f"t{k} += {xv} * {wv};")
            self._store_scalar(layer, f"t{k}", out_index(i, j, k), dst,
                               pos=(i, j, k))
            w.close()
        w.close()

    # -- depthwise conv ------------------------------------------------------

    def emit_depthwise(self, layer: DepthwiseConv2D, in_shape, src: str,
                       dst: str, pad_buf: Optional[str] = None) -> None:
        w = self.w
        oh, ow, co = layer.out_shape(in_shape)
        pads = layer.pad_amounts(in_shape)
        kh, kw_, ci, mult = layer.kh, layer.kw, layer.c_in, layer.multiplier
        sh, sw = layer.strides
        w(f"/* DepthwiseConv2D {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} mult={mult} pad={layer.padding} "
          f"act={layer.activation} */")
        if any(pads):
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy(src, in_shape, pads, pad_buf)
        h, wdt, _ = in_shape
        wname = self.const_array(f"w{self.uid()}", layer.weights)
        bname = self.const_array(f"b{self.uid()}", layer.bias)
        act = layer.activation if layer.activation != "softmax" else None
        self.floop("i", oh)
        self.floop("j", ow)
        self.floop("c", ci)
        for m_ in range(mult):
            w.open("")
            w(f"float acc = {bname}[c * {mult} + {m_}];")
            w(_cfor("n", kh, _cfor(
                "m", kw_,
                f"acc += {src}[((i * {sh} + n) * {wdt} + "
                f"(j * {sw} + m)) * {ci} + c] * "
                f"{wname}[((n * {kw_} + m) * {ci} + c) * {mult} + {m_}];")))
            self._store_scalar(layer, "acc",
                               f"(i * {ow} + j) * {co} + c * {mult} + {m_}",
                               dst, pos=("i", "j", f"c * {mult} + {m_}"))
            w.close()
        self.fclose(3)
        if layer.activation == "softmax":
            self.emit_softmax((oh, ow, co), dst)

    # -- pooling / merge / elementwise / softmax / dense ---------------------

    def emit_maxpool(self, layer: MaxPool, in_shape, src: str, dst: str,
                     pad_buf: Optional[str] = None) -> None:
        w, opts = self.w, self.opts
        oh, ow, co = layer.out_shape(in_shape)
        kh, kw_ = layer.size
        sh, sw = layer.strides
        pads = layer.pad_amounts(in_shape)
        level = effective_level(layer, in_shape, opts)
        w(f"/* MaxPool {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} level={level} */")

        # like conv: level 0 elides out-of-bounds taps statically; any
        # looped level materializes a -FLT_MAX-padded copy (the fill
        # never wins — every window covers >=1 valid tap)
        if any(pads) and level != 0:
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy(src, in_shape, pads,
                                                  pad_buf, _NEG_FLT_MAX)
            pads = (0, 0, 0, 0)
        h, wdt, c = in_shape
        pt, _pb, pl, _pr = pads

        def in_bounds(i, j, n, m) -> bool:
            r, cc = i * sh + n - pt, j * sw + m - pl
            return 0 <= r < h and 0 <= cc < wdt

        def taps(i, j):
            static_ij = isinstance(i, int) and isinstance(j, int)
            for n in range(kh):
                for m in range(kw_):
                    if static_ij and not in_bounds(i, j, n, m):
                        continue  # P3: padding tap elided entirely
                    yield n, m

        def body(i, j):
            isa = opts.isa
            if isa is not None and c % isa.width == 0:
                for kg in range(0, c, isa.width):
                    w.open("")
                    first = True
                    for n, m in taps(i, j):
                        idx = x_idx(i, j, n, m, kg)
                        if first:
                            w(f"{isa.reg} p = "
                              f"{isa.load(f'{src}[{idx}]')};")
                            first = False
                        else:
                            w(f"p = {isa.vmax('p', isa.load(f'{src}[{idx}]'))};")
                    w(isa.store(f"{dst}[{o_idx(i, j, kg)}]", "p"))
                    w.close()
            else:
                for k in range(c):
                    w.open("")
                    first = True
                    for n, m in taps(i, j):
                        idx = x_idx(i, j, n, m, k)
                        if first:
                            w(f"float q = {src}[{idx}];")
                            first = False
                        else:
                            # P2: ternary, not an if
                            w(f"q = {src}[{idx}] > q ? "
                              f"{src}[{idx}] : q;")
                    w(f"{dst}[{o_idx(i, j, k)}] = q;")
                    w.close()

        def x_idx(i, j, n, m, k):
            if isinstance(i, int) and isinstance(j, int):
                return str(((i * sh + n - pt) * wdt + (j * sw + m - pl))
                           * c + k)
            return (f"(({i} * {sh} + {n - pt}) * {wdt} + "
                    f"({j} * {sw} + {m - pl})) * {c} + {k}")

        def o_idx(i, j, k):
            if isinstance(i, int) and isinstance(j, int):
                return str((i * ow + j) * co + k)
            return f"(({i}) * {ow} + ({j})) * {co} + {k}"

        if level == 0:
            for i in range(oh):
                for j in range(ow):
                    body(i, j)
        elif level == 1:
            self.floop("i", oh)
            for j in range(ow):
                body("i", j)
            self.fclose()
        elif level == 2:
            self.floop("i", oh)
            self.floop("j", ow)
            body("i", "j")
            self.fclose(2)
        else:
            self.floop("i", oh)
            self.floop("j", ow)
            if opts.isa is not None and c % opts.isa.width == 0:
                isa = opts.isa
                self.floop("k", c, step=isa.width)
                w(f"{isa.reg} p = "
                  f"{isa.load(f'{src}[' + x_idx('i', 'j', 0, 0, 0) + ' + k]')};")
                for n in range(kh):
                    for m in range(kw_):
                        if n == 0 and m == 0:
                            continue
                        ld = isa.load(f"{src}[" + x_idx('i', 'j', n, m, 0)
                                      + " + k]")
                        w(f"p = {isa.vmax('p', ld)};")
                w(isa.store(f"{dst}[(i * {ow} + j) * {co} + k]", "p"))
                self.fclose()
            else:
                self.floop("k", c)
                w(f"float q = {src}[{x_idx('i', 'j', 0, 0, 0)} + k];")
                for n in range(kh):
                    for m in range(kw_):
                        if n == 0 and m == 0:
                            continue
                        w(f"q = {src}[{x_idx('i', 'j', n, m, 0)} + k] > q ? "
                          f"{src}[{x_idx('i', 'j', n, m, 0)} + k] : q;")
                w(f"{dst}[(i * {ow} + j) * {co} + k] = q;")
                self.fclose()
            self.fclose(2)

    def emit_avgpool(self, layer: AvgPool, in_shape, src: str, dst: str,
                     pad_buf: Optional[str] = None) -> None:
        w = self.w
        oh, ow, co = layer.out_shape(in_shape)
        kh, kw_ = layer.size
        sh, sw = layer.strides
        pads = layer.pad_amounts(in_shape)
        counts = pool_window_counts(in_shape, layer.size, layer.strides,
                                    pads)
        w(f"/* AvgPool {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} */")
        if any(pads):
            # zero fill keeps the window sum correct; the divisor below
            # counts only the valid taps (edge-correct, not 1/(kh*kw))
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy(src, in_shape, pads,
                                                  pad_buf)
        h, wdt, c = in_shape
        if counts.min() == counts.max():
            inv_expr = _flit(1.0 / counts.max())
        else:
            # edge windows cover fewer valid taps: per-window inverse
            # divisor table, indexed by the output position
            invm = self.const_array(
                f"pinv{self.uid()}",
                (1.0 / counts.astype(np.float64)).astype(np.float32))
            inv_expr = f"{invm}[i * {ow} + j]"
        self.floop("i", oh)
        self.floop("j", ow)
        self.floop("k", c)
        w("float s = 0.0f;")
        w(_cfor("n", kh, _cfor(
            "m", kw_,
            f"s += {src}[((i * {sh} + n) * {wdt} + "
            f"(j * {sw} + m)) * {c} + k];")))
        w(f"{dst}[(i * {ow} + j) * {co} + k] = s * {inv_expr};")
        self.fclose(3)

    def emit_global_avgpool(self, layer: GlobalAvgPool, in_shape,
                            src: str, dst: str) -> None:
        w = self.w
        h, wdt, c = in_shape
        inv = _flit(1.0 / (h * wdt))
        w(f"/* GlobalAvgPool {layer.name}: {in_shape}->(1, 1, {c}) */")
        self.floop("k", c)
        w("float s = 0.0f;")
        w(_cfor("p", h * wdt, f"s += {src}[p * {c} + k];"))
        w(f"{dst}[k] = s * {inv};")
        self.fclose()

    def emit_add(self, layer: Add, shape, srcs: List[str], dst: str) -> None:
        w = self.w
        n = int(np.prod(shape))
        isa = self.opts.isa
        act = layer.activation if layer.activation != "softmax" else None
        w(f"/* Add {layer.name}: {len(srcs)} inputs, {shape}, "
          f"act={layer.activation} */")
        if isa is not None and n % isa.width == 0 and len(srcs) >= 2:
            self.floop("z", n, step=isa.width)
            w(f"{isa.reg} v = {isa.load(f'{srcs[0]}[z]')};")
            for s in srcs[1:]:
                w(f"v = {isa.add('v', isa.load(f'{s}[z]'))};")
            for ln in self.act_sse("v", act, layer.alpha):
                w(ln)
            w(isa.store(f"{dst}[z]", "v"))
            self.fclose()
        else:
            expr = " + ".join(f"{s}[z]" for s in srcs)
            w(_cfor("z", n,
                    f"{dst}[z] = {self.act_scalar(expr, act, layer.alpha)};"))

    def emit_concat(self, layer: Concat, in_shapes, srcs: List[str],
                    dst: str) -> None:
        w = self.w
        h, wdt, _ = in_shapes[0]
        co = int(sum(s[2] for s in in_shapes))
        fused_by_p = self.schedule.fused_by_producer
        fused = [fused_by_p.get(n) == layer.name for n in layer.inputs]
        w(f"/* Concat {layer.name}: {[tuple(s) for s in in_shapes]} -> "
          f"({h}, {wdt}, {co}) */")
        if all(fused):
            w("/* all inputs fused into their producers' stores */")
            return
        self.floop("p", h * wdt)
        off = 0
        for s, ish, fz in zip(srcs, in_shapes, fused):
            ck = int(ish[2])
            if not fz:
                w(_cfor("z", ck,
                        f"{dst}[p * {co} + {off} + z] = {s}[p * {ck} + z];"))
            off += ck
        self.fclose()

    def emit_elementwise(self, in_shape, src, dst, act, alpha) -> None:
        w = self.w
        n = int(np.prod(in_shape))
        isa = self.opts.isa
        if isa is not None and n % isa.width == 0 and act in (
                "relu", "leaky_relu"):
            self.floop("z", n, step=isa.width)
            w(f"{isa.reg} v = {isa.load(f'{src}[z]')};")
            for ln in self.act_sse("v", act, alpha):
                w(ln)
            w(isa.store(f"{dst}[z]", "v"))
            self.fclose()
        else:
            w(_cfor("z", n,
                    f"{dst}[z] = {self.act_scalar(f'{src}[z]', act, alpha)};"))

    def emit_batchnorm(self, layer: BatchNorm, in_shape, src, dst) -> None:
        w = self.w
        scale, shift = layer.scale_shift()
        c = in_shape[2]
        sname = self.const_array(f"s{self.uid()}", scale)
        tname = self.const_array(f"t{self.uid()}", shift)
        n = int(np.prod(in_shape))
        w(_cfor("z", n,
                f"{dst}[z] = {src}[z] * {sname}[z % {c}] + "
                f"{tname}[z % {c}];"))

    def emit_softmax(self, shape, buf) -> None:
        w = self.w
        h, wdt, c = shape
        w(f"/* softmax over {c} channels */")
        self.floop("p", h * wdt)
        w(f"float mx = {buf}[p * {c}];")
        w("float s = 0.0f;")
        w(_cfor("k", c,
                f"mx = {buf}[p * {c} + k] > mx ? {buf}[p * {c} + k] : mx;",
                start=1))
        w(_cfor("k", c,
                f"{{ {buf}[p * {c} + k] = expf({buf}[p * {c} + k] - mx); "
                f"s += {buf}[p * {c} + k]; }}"))
        w(_cfor("k", c, f"{buf}[p * {c} + k] /= s;"))
        self.fclose()

    def emit_dense(self, layer: Dense, in_shape, src, dst) -> None:
        w = self.w
        d_in, d_out = layer.weights.shape
        wname = self.const_array(f"w{self.uid()}", layer.weights)
        bname = self.const_array(f"b{self.uid()}", layer.bias)
        act = layer.activation if layer.activation != "softmax" else None
        w(f"/* Dense {layer.name}: {d_in}->{d_out} */")
        self.floop("k", d_out)
        w(f"float acc = {bname}[k];")
        w(_cfor("z", d_in, f"acc += {src}[z] * {wname}[z * {d_out} + k];"))
        self._store_scalar(layer, "acc", "k", dst, pos=(0, 0, "k"))
        self.fclose()
        if layer.activation == "softmax":
            self.emit_softmax((1, 1, d_out), dst)

    # -- driver ---------------------------------------------------------------

    _elem = "float"       # arena / intermediate element C type
    _quantized = False

    def _emit_layer(self, layer, smap, val, ref, plan) -> None:
        """Emit one layer's code with sources/destination resolved by
        ``ref`` — shared by the monolithic body and the stage bodies."""
        w = self.w
        ishs = [smap[n] for n in layer.inputs]
        srcs = [ref(val[n]) for n in layer.inputs]
        dst = ref(val[layer.name])
        pad_buf = (_cname(layer.name + "__pad")
                   if layer.name + "__pad" in plan.offsets else None)
        if isinstance(layer, Conv2D):
            self.emit_conv(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, DepthwiseConv2D):
            self.emit_depthwise(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, MaxPool):
            self.emit_maxpool(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, AvgPool):
            self.emit_avgpool(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, GlobalAvgPool):
            self.emit_global_avgpool(layer, ishs[0], srcs[0], dst)
        elif isinstance(layer, Add):
            self.emit_add(layer, smap[layer.name], srcs, dst)
        elif isinstance(layer, Concat):
            self.emit_concat(layer, ishs, srcs, dst)
        elif isinstance(layer, ReLU):
            self.emit_elementwise(ishs[0], srcs[0], dst, "relu", 0.0)
        elif isinstance(layer, LeakyReLU):
            self.emit_elementwise(ishs[0], srcs[0], dst, "leaky_relu",
                                  layer.alpha)
        elif isinstance(layer, Softmax):
            if srcs[0] != dst:
                w(_cfor("z", int(np.prod(ishs[0])),
                        f"{dst}[z] = {srcs[0]}[z];"))
            self.emit_softmax(ishs[0], dst)
        elif isinstance(layer, BatchNorm):
            self.emit_batchnorm(layer, ishs[0], srcs[0], dst)
        elif isinstance(layer, Dense):
            self.emit_dense(layer, ishs[0], srcs[0], dst)
        else:  # pragma: no cover
            raise TypeError(f"cgen: unhandled layer {type(layer).__name__}")

    def _fuse_node(self, layer, smap, val, ref) -> Optional[FuseNode]:
        """Build the live fusion context for ``layer`` when the schedule
        folds one of its consumers into its store site."""
        cname = self.schedule.fused_by_producer.get(layer.name)
        if cname is None:
            return None
        cons = self.g.layer(cname)
        if isinstance(cons, Add):
            return AddFuse(add=cons, pos=cons.inputs.index(layer.name),
                           srcs=[ref(val[n]) for n in cons.inputs])
        if isinstance(cons, (MaxPool, AvgPool)):
            ph, pw, c = smap[cname]
            sh, sw = cons.strides
            kh, kw_ = cons.size
            kind = "max" if isinstance(cons, MaxPool) else "avg"
            return PoolFuse(
                pool=cons, kind=kind, pw=pw, c=c, sh=sh, sw=sw,
                dst=ref(val[cname]), n=ph * pw * c,
                inv=_flit(1.0 / (kh * kw_)),
                acc=(_cname(cname + "__acc")
                     if self._quantized and kind == "avg" else ""))
        pos = cons.inputs.index(layer.name)
        return ConcatFuse(
            concat=cons, pos=pos,
            c_off=int(sum(smap[n][2] for n in cons.inputs[:pos])),
            c_total=int(smap[cname][2]), ow=int(smap[cname][1]))

    def _emit_fuse_init(self, node: FuseNode, smap) -> None:
        """Prologue before a fused producer's loops: pooling fills the
        consumer's output with the reduction identity."""
        if isinstance(node, PoolFuse):
            p = node.pool
            self.w(f"/* fused {type(p).__name__} {p.name}: producer "
                   f"stores reduce straight into the {node.kind} "
                   f"windows */")
            fill = _NEG_FLT_MAX if node.kind == "max" else "0.0f"
            self.w(_cfor("z", node.n, f"{node.dst}[z] = {fill};"))
        elif isinstance(node, ConcatFuse):
            self.w(f"/* fused Concat {node.concat.name} edge {node.pos}: "
                   f"producer writes its channel slice at offset "
                   f"{node.c_off} directly */")

    def _emit_fuse_finalize(self, node: FuseNode, smap) -> None:
        """Epilogue after a fused producer's loops: average pooling
        applies the window divisor (same op order as the unfused
        ``s * inv`` store, so results stay bitwise)."""
        if isinstance(node, PoolFuse) and node.kind == "avg":
            self.w(_cfor("z", node.n, f"{node.dst}[z] *= {node.inv};"))

    def _record_nest(self, layer, smap, node: Optional[FuseNode],
                     start: int, end: int) -> None:
        """Append the typed :class:`LoopNest` for the layer span just
        emitted into ``self.w.lines[start:end]``."""
        out_shape = tuple(smap[layer.name])
        if isinstance(layer, (Conv2D, DepthwiseConv2D, MaxPool, AvgPool)):
            oh, ow, c = out_shape
            lvl = (effective_level(layer, smap[layer.inputs[0]], self.opts)
                   if not self._quantized
                   and isinstance(layer, (Conv2D, MaxPool)) else None)
            loops = (Loop("i", oh, unrolled=lvl == 0),
                     Loop("j", ow, unrolled=lvl in (0, 1)),
                     Loop("k", c, unrolled=lvl is not None))
            variant = f"level={lvl} simd={self.opts.simd}"
        elif isinstance(layer, Dense):
            loops = (Loop("k", out_shape[-1]),)
            variant = f"simd={self.opts.simd}"
        else:
            loops = (Loop("z", int(np.prod(out_shape))),)
            variant = f"simd={self.opts.simd}"
        kind = ("q" if self._quantized else "") + type(layer).__name__.lower()
        eps: List[Epilogue] = []
        act = getattr(layer, "activation", None)
        if act == "softmax":
            eps.append(Epilogue("softmax", layer.name))
        elif act:
            eps.append(Epilogue("act", layer.name, act))
        if self._quantized and layer is not self.g.sink and \
                isinstance(layer, (Conv2D, DepthwiseConv2D, Dense)):
            eps.append(Epilogue("requant", layer.name))
        if isinstance(node, AddFuse):
            eps.append(Epilogue("add_fuse", node.add.name,
                                f"pos={node.pos}"))
            if node.add.activation:
                eps.append(Epilogue("act", node.add.name,
                                    node.add.activation))
            if self._quantized:
                eps.append(Epilogue("requant", node.add.name))
        elif isinstance(node, PoolFuse):
            eps.append(Epilogue(f"{node.kind}pool_fuse", node.pool.name))
            if self._quantized:
                eps.append(Epilogue("requant", node.pool.name))
        elif isinstance(node, ConcatFuse):
            eps.append(Epilogue("concat_fuse", node.concat.name,
                                f"edge={node.pos} c_off={node.c_off}"))
            if self._quantized:
                eps.append(Epilogue("requant", node.concat.name))
        self.nests.append(LoopNest(
            layer=layer.name, op=type(layer).__name__,
            out_shape=out_shape, loops=loops,
            kernel=KernelCall(kind=kind, layer=layer.name,
                              variant=variant, span=(start, end)),
            epilogue=tuple(eps), stage=self._stage))

    def _emit_graph_body(self, layers, smap, val, ref, plan) -> None:
        """Emit ``layers`` in order, skipping identity layers and
        absorbed consumers (fused Adds/pools), arming the fusion
        context around fused producers."""
        absorbed = self.schedule.absorbed_consumers
        for layer in layers:
            if isinstance(layer, IDENTITY_LAYERS) or \
                    layer.name in absorbed:
                continue
            node = self._fuse_node(layer, smap, val, ref)
            start = len(self.w.lines)
            if node is not None:
                self._emit_fuse_init(node, smap)
            self._epi = node
            self._emit_layer(layer, smap, val, ref, plan)
            self._epi = None
            if node is not None:
                self._emit_fuse_finalize(node, smap)
            self._record_nest(layer, smap, node, start, len(self.w.lines))

    # -- pipeline emission ---------------------------------------------------

    def _emit_pipeline(self, smap, val, out_value, plan) -> None:
        """Emit one function per schedule stage plus the
        ``<func>_pipeline`` driver.

        Stage ``s`` is ``void <func>_stage<s>(in, out, ws)``: ``in`` is
        the interface buffer written by stage ``s-1`` (the raw network
        input for stage 0), ``out`` the interface it feeds stage ``s+1``
        (the network output for the last stage), ``ws`` the ordinary
        arena for values that never cross a stage boundary (plus pad
        scratch).  A value defined in one stage and consumed two or more
        stages later is forwarded by memcpy through every interface in
        between.  The sequential driver carves the interfaces from the
        tail of one workspace; ``runtime.PipelineRunner`` instead
        double-buffers each interface and runs the stages on separate
        threads for batch-1 stream throughput."""
        g, opts, w, sched = self.g, self.opts, self.w, self.schedule
        elem = self._elem
        quantized = self._quantized
        S = sched.nstages
        stage_of = {u: s for s, us in enumerate(sched.stages) for u in us}
        absorbed_by = sched.fused_by_consumer

        def eff_stage(name: str) -> int:
            """Stage where layer ``name``'s reads/writes actually run."""
            if name in absorbed_by:
                return stage_of[absorbed_by[name]]
            return stage_of[name]

        # def/last-use stages per value; sizes in elements
        def_stage: Dict[str, int] = {}
        vsizes: Dict[str, int] = {}
        if quantized:
            def_stage["xq"] = 0  # the input-quant prologue runs in stage 0
            vsizes["xq"] = int(np.prod(g.input_shape))
        else:
            def_stage["x"] = -1  # the caller's input argument
            vsizes["x"] = int(np.prod(g.input_shape))
        for u in stage_of:
            v = val[u]
            if v not in def_stage:
                def_stage[v] = stage_of[u]
                vsizes[v] = int(np.prod(smap[u]))
        last_stage: Dict[str, int] = {}
        for layer in g.layers:
            if isinstance(layer, IDENTITY_LAYERS):
                continue
            s_l = eff_stage(layer.name)
            for n in layer.inputs:
                v = val[n]
                if v in def_stage:
                    last_stage[v] = max(last_stage.get(v, s_l), s_l)

        def crosses(v: str, b: int) -> bool:
            """Value ``v`` is transported over boundary ``b`` (between
            stage ``b`` and ``b+1``)."""
            return def_stage[v] <= b < last_stage.get(v, def_stage[v])

        iface_vals: List[List[str]] = []
        iface_off: List[Dict[str, int]] = []
        iface_sz: List[int] = []
        for b in range(S - 1):
            vs = sorted(v for v in def_stage if crosses(v, b))
            offs, cum = {}, 0
            for v in vs:
                offs[v] = cum
                cum += vsizes[v]
            iface_vals.append(vs)
            iface_off.append(offs)
            iface_sz.append(cum)
        self.iface_elems = tuple(iface_sz)

        copy_n = (f"{{n}} * sizeof(float)" if not quantized else "{n}")
        for s in range(S):
            self._stage = s
            in_ty = "const float" if s == 0 or not quantized \
                else f"const {elem}"
            out_ty = "float" if s == S - 1 else elem
            units = sched.stages[s]
            layers = [g.layer(u) for u in units]

            # every value touched in this stage, in a stable order
            used: List[str] = []

            def need(v: str) -> None:
                if v not in used:
                    used.append(v)
            pads: List[str] = []
            accs: List[str] = []
            for layer in layers:
                need(val[layer.name])
                for n in layer.inputs:
                    need(val[n])
                a = self.schedule.fused_by_producer.get(layer.name)
                if a is not None:
                    for n in g.layer(a).inputs:
                        need(val[n])
                    if a + "__acc" in plan.offsets:
                        accs.append(a + "__acc")
                if layer.name + "__pad" in plan.offsets:
                    pads.append(layer.name + "__pad")
            passthrough = [] if s == S - 1 else \
                [v for v in iface_vals[s] if def_stage[v] != s]
            for v in passthrough:
                need(v)
            if quantized and s == 0:
                need("xq")

            names: Dict[str, str] = {}
            decls: List[str] = []
            uses_ws = bool(pads or accs)
            for v in sorted(used):
                if not quantized and v == "x" and s == 0:
                    names[v] = "in"
                elif v == out_value and s == S - 1:
                    names[v] = "out"
                elif def_stage[v] == s:
                    names[v] = _cname(v)
                    if s < S - 1 and crosses(v, s):
                        decls.append(f"{out_ty} *const {names[v]} = "
                                     f"out + {iface_off[s][v]};")
                    else:
                        decls.append(f"{elem} *const {names[v]} = "
                                     f"ws + {plan.offsets[v]};")
                        uses_ws = True
                else:  # defined in an earlier stage: read the in iface
                    names[v] = _cname(v)
                    decls.append(f"{in_ty} *const {names[v]} = "
                                 f"in + {iface_off[s - 1][v]};")

            w.open(f"void {opts.stage_func_name(s)}("
                   f"{in_ty} *NNCG_RESTRICT in, "
                   f"{out_ty} *NNCG_RESTRICT out, "
                   f"{elem} *NNCG_RESTRICT ws)")
            for d in decls:
                w(d)
            for p in pads:
                w(f"{elem} *const {_cname(p)} = ws + {plan.offsets[p]};")
            for acc in accs:
                w(f"int *const {_cname(acc)} = "
                  f"(int *)(void *)(ws + {plan.offsets[acc]});")
            if not uses_ws:
                w("(void) ws;")
            for v in passthrough:
                src = names[v]  # "in" for x at stage 0, a decl otherwise
                w(f"memcpy(out + {iface_off[s][v]}, {src}, "
                  f"{copy_n.format(n=vsizes[v])});")
            if quantized and s == 0:
                self._emit_input_quant("in")
            self._emit_graph_body(layers, smap, val,
                                  lambda v: names[v], plan)
            w.close()
            w("")
        self._stage = 0

        # sequential driver: interfaces carved from the workspace tail,
        # every stage sharing one arena (interface and arena subranges
        # are disjoint, so the restrict contract holds)
        w.open(f"void {opts.pipeline_func_name}("
               f"const float *NNCG_RESTRICT x, "
               f"float *NNCG_RESTRICT out, "
               f"{elem} *NNCG_RESTRICT ws, int nstages)")
        cum = plan.total_floats
        for b in range(S - 1):
            w(f"{elem} *const iface{b} = ws + {cum}; "
              f"/* stage {b} -> {b + 1}: {iface_sz[b]} elems */")
            cum += iface_sz[b]
        w("(void) nstages;")
        for s in range(S):
            a = "x" if s == 0 else f"iface{s - 1}"
            o = "out" if s == S - 1 else f"iface{s}"
            w(f"{opts.stage_func_name(s)}({a}, {o}, ws);")
        w.close()
        w("")
        w.open(f"long {opts.pipeline_nstages_func_name}(void)")
        w(f"return {S}L;")
        w.close()
        w("")
        self.ws_total_elems = cum
        self.stage_syms = tuple(opts.stage_func_name(s) for s in range(S))

    def lower(self) -> Program:
        """Lower the scheduled graph into the loop-nest IR — fills the
        writer blocks and ``self.nests`` and returns the
        :class:`Program` that :func:`repro_torch.core.lowering.render` turns
        into C source."""
        if self._program is not None:
            return self._program
        g, opts, w = self.g, self.opts, self.w
        sched = self.schedule
        smap = g.shape_map()
        plan = self.plan = plan_arena(g, opts, schedule=sched)
        val = _value_map(g, schedule=sched)
        out_value = val[g.sink.name]
        S = sched.nstages
        self.ws_total_elems = plan.total_floats

        def ref(v: str) -> str:
            if v == "x":
                return "x"
            if v == out_value:
                return "out"
            return _cname(v)

        if S > 1:
            self._emit_pipeline(smap, val, out_value, plan)

        w.open(f"void {opts.ws_func_name}(const float *NNCG_RESTRICT x, "
               f"float *NNCG_RESTRICT out, float *NNCG_RESTRICT ws)")
        if S > 1:
            # the layer code lives in the stage functions exactly once;
            # the classic entry routes through the sequential driver
            w(f"{opts.pipeline_func_name}(x, out, ws, {S});")
        else:
            # workspace carving: all pointer declarations first (C89)
            for iv in sorted(plan.intervals,
                             key=lambda iv: (iv.offset, iv.value)):
                w(f"float *const {_cname(iv.value)} = ws + {iv.offset}; "
                  f"/* {iv.size} floats, live layers "
                  f"[{iv.start}, {iv.end}] */")
            if not plan.intervals:
                w("(void) ws;")
            self._emit_graph_body(g.layers, smap, val, ref, plan)
            if out_value == "x":  # degenerate identity graph
                w(_cfor("z", int(np.prod(g.input_shape)), "out[z] = x[z];"))
        w.close()

        # static-arena wrapper: the paper's embedded single-image entry
        arena = f"{opts.func_name}_arena"
        self.decls(f"static float {arena}[{max(self.ws_total_elems, 1)}];")
        w("")
        w.open(f"void {opts.func_name}(const float *NNCG_RESTRICT x, "
               f"float *NNCG_RESTRICT out)")
        w(f"{opts.ws_func_name}(x, out, {arena});")
        w.close()
        w("")
        w.open(f"long {opts.ws_size_func_name}(void)")
        w(f"return {self.ws_total_elems}L;")
        w.close()

        if opts.emit_batch:
            # serving entry points: N images through the single-image
            # function.  <func>_batch runs over the static arena;
            # <func>_batch_ws takes a caller workspace, so a server
            # worker pool pushes whole batches through one foreign call
            # per batch, each worker on its own arena.
            in_n = int(np.prod(g.input_shape))
            out_n = int(np.prod(smap[g.sink.name]))
            w("")
            w.open(f"void {opts.batch_ws_func_name}("
                   f"const float *NNCG_RESTRICT x, "
                   f"float *NNCG_RESTRICT out, int n, "
                   f"float *NNCG_RESTRICT workspace)")
            w("int b;")
            w(f"for (b = 0; b < n; ++b) "
              f"{opts.ws_func_name}(x + (long)b * {in_n}, "
              f"out + (long)b * {out_n}, workspace);")
            w.close()
            w("")
            w.open(f"void {opts.batch_func_name}("
                   f"const float *NNCG_RESTRICT x, "
                   f"float *NNCG_RESTRICT out, int n)")
            w(f"{opts.batch_ws_func_name}(x, out, n, {arena});")
            w.close()

        hdr = _W()
        hdr("/* Generated by NNCG (PyTorch port; repro of Urbann et al., 2020).")
        hdr(f" * net: in {g.input_shape} -> out {smap[g.sink.name]}, "
            f"{g.param_count()} params, simd={opts.simd},")
        hdr(f" * arena {plan.total_bytes} B "
            f"(one-buffer-per-layer would be {plan.buffer_sum_bytes} B)"
            f"{f', pipeline stages={S}' if S > 1 else ''} */")
        hdr("#include <math.h>")
        if S > 1:
            hdr("#include <string.h>")  # stage pass-through memcpy
        if opts.isa is not None:
            hdr(f"#include <{opts.isa.header}>")
        hdr("#if defined(__STDC_VERSION__) && __STDC_VERSION__ >= 199901L")
        hdr("#define NNCG_RESTRICT restrict")
        hdr("#else")
        hdr("#define NNCG_RESTRICT")
        hdr("extern float expf(float);")
        hdr("#endif")
        hdr("")
        return self._finish_program(hdr, plan, "fp32")

    def _finish_program(self, hdr: _W, plan: ArenaPlan,
                        precision: str) -> Program:
        self._program = Program(
            func_name=self.opts.func_name, precision=precision,
            header=hdr.lines, decls=self.decls.lines, body=self.w.lines,
            nests=self.nests,
            buffers=[Buffer(name=iv.value, cname=_cname(iv.value),
                            offset=iv.offset, size=iv.size,
                            elem=("int" if iv.value.endswith("__acc")
                                  else self._elem),
                            start=iv.start, end=iv.end)
                     for iv in plan.intervals],
            arena_elems=plan.total_floats, elem_bytes=plan.elem_bytes)
        return self._program

    def generate(self) -> str:
        """Emit the complete C translation unit (``render`` over the
        lowered :class:`Program` — the single rendering path)."""
        return render(self.lower())


# ---------------------------------------------------------------------------
# quantized code generation (int8 weights/intermediates, int32 accumulators)
# ---------------------------------------------------------------------------


class QuantCGenerator(CGenerator):
    """Int8 code generator for a calibrated
    :class:`repro_torch.core.quantize.QuantizedGraph`.

    Same external contract as the float generator (float in, float out,
    reentrant ``_ws`` entry, static-arena wrapper, batch loop) but every
    weight is a ``static const signed char`` array, every intermediate
    tensor is an int8 code in a **byte**-planned arena (~4x smaller),
    accumulation is int32, and requantization multiplies by float32
    constants shared bit-exactly with the int8 reference
    (:func:`repro_torch.core.torch_exec.forward_quantized`).

    ``simd='sse'``/``'avx'`` vectorizes the conv/dense inner dot product
    with SSE2 integer intrinsics (sign-extend + ``_mm_madd_epi16``, 16
    taps per iteration).  Integer addition is associative, so the SIMD
    build produces *identical* results to the scalar one.  Any other
    mode emits portable scalar code — strict ANSI C89, like the float
    path (CI-enforced).
    """

    _elem = "signed char"
    _quantized = True

    def __init__(self, qgraph, opts: CodegenOptions,
                 schedule: Optional[Schedule] = None):
        super().__init__(qgraph.graph, opts, schedule)
        self.qg = qgraph

    # -- const emitters -------------------------------------------------------

    def const_i8(self, name: str, arr: np.ndarray) -> str:
        vals = ", ".join(str(int(v))
                         for v in np.asarray(arr, np.int8).ravel())
        self.decls(f"static const signed char {name}[{arr.size}] = "
                   f"{{{vals}}};")
        return name

    def const_i16(self, name: str, arr: np.ndarray) -> str:
        """Int8 weight codes pre-widened to int16 for the SSE madd
        path (values still fit int8; layout-only)."""
        vals = ", ".join(str(int(v))
                         for v in np.asarray(arr, np.int16).ravel())
        self.decls(f"static const short {name}[{arr.size}] = {{{vals}}};")
        return name

    def const_i32(self, name: str, arr: np.ndarray) -> str:
        vals = ", ".join(str(int(v))
                         for v in np.asarray(arr, np.int32).ravel())
        self.decls(f"static const int {name}[{arr.size}] = {{{vals}}};")
        return name

    # -- shared emission fragments -------------------------------------------

    _REQ_DECLS = "float t; float u; int q;"

    @property
    def _req_decls(self) -> str:
        """Requant scratch decls for a weighted layer's store block —
        fused stores additionally hold the producer's own int8 code in
        ``qf`` before feeding the consumer's epilogue."""
        return self._REQ_DECLS + (" signed char qf;"
                                  if self._epi is not None else "")

    def _q_store(self, zp_out, oidx: str, dst: str,
                 pos=None) -> None:
        """Store the requant result ``t`` as the int8 code of output
        element ``oidx``.  ``zp_out`` is an int, or a C expression
        string indexing a per-channel zero-point table.
        Unfused: the ordinary round/clamp into ``dst``.  Fused: requantize to the producer's own code first
        (``qf`` — exactly the value the unfused kernel would have
        written to memory), then run the fused consumer's arithmetic on
        it: the Add's per-edge dequant sum (bit-exact with
        :meth:`_qadd_scalar_body`), the max-pool code ternary
        (:meth:`emit_qmaxpool`), the avg-pool int32 window sum
        (:meth:`emit_qavgpool` — finalized after the producer loops), or
        the Concat per-edge requant (:meth:`emit_qconcat`)."""
        epi = self._epi
        if epi is None:
            self._round_clamp(zp_out, f"{dst}[{oidx}]")
            return
        qg, w = self.qg, self.w
        if isinstance(epi, PoolFuse):
            di = epi.dst_index(pos)
            self._round_clamp(zp_out, "qf")
            if epi.kind == "max":
                w(f"{dst}[{di}] = qf > {dst}[{di}] ? qf : {dst}[{di}];")
            else:
                w(f"{epi.acc}[{di}] += qf;")
            return
        if isinstance(epi, ConcatFuse):
            cat = epi.concat
            di = epi.dst_index(pos)
            self._round_clamp(zp_out, "qf")
            w(f"t = (float)(qf - {qg.in_qp(cat, epi.pos).zero_point}) * "
              f"{_flit(qg.rescale(cat, epi.pos))};")
            self._round_clamp(qg.out_qp(cat).zero_point, f"{dst}[{di}]")
            return
        fc, add = epi, epi.add
        self._round_clamp(zp_out, "qf")
        for i, s in enumerate(fc.srcs):
            op = "=" if i == 0 else "+="
            qp = qg.in_qp(add, i)
            sref = "qf" if i == fc.pos else f"{s}[{oidx}]"
            w(f"t {op} (float)({sref} - {qp.zero_point}) * "
              f"{_flit(qg.rescale(add, i))};")
        self._act_float(add.activation, add.alpha)
        self._round_clamp(qg.out_qp(add).zero_point, f"{dst}[{oidx}]")

    def _fused_lane_loop(self, G: int, base: str, dst: str,
                         pos=None) -> None:
        """Fused epilogue after a vector requant into ``qtmp``: for each
        of the ``G`` just-produced producer codes, run the consumer's
        scalar reference arithmetic — the Add dequant sum, the max-pool
        code ternary, the avg-pool int32 window accumulate, or the
        Concat per-edge requant — so the tiled kernels stay bit-exact
        with the unfused emission."""
        epi = self._epi
        qg, w = self.qg, self.w
        if isinstance(epi, PoolFuse):
            i, j, k = pos
            di = epi.dst_index((i, j, f"{k} + lz"))
            w.open("")
            w("int lz;")
            w.open(f"for (lz = 0; lz < {G}; ++lz)")
            if epi.kind == "max":
                w(f"{dst}[{di}] = qtmp[lz] > {dst}[{di}] ? "
                  f"qtmp[lz] : {dst}[{di}];")
            else:
                w(f"{epi.acc}[{di}] += qtmp[lz];")
            w.close()
            w.close()
            return
        if isinstance(epi, ConcatFuse):
            i, j, k = pos
            cat = epi.concat
            di = epi.dst_index((i, j, f"{k} + lz"))
            w.open("")
            w("int lz; float t; float u; int q;")
            w.open(f"for (lz = 0; lz < {G}; ++lz)")
            w(f"t = (float)(qtmp[lz] - "
              f"{qg.in_qp(cat, epi.pos).zero_point}) * "
              f"{_flit(qg.rescale(cat, epi.pos))};")
            self._round_clamp(qg.out_qp(cat).zero_point, f"{dst}[{di}]")
            w.close()
            w.close()
            return
        fc, add = epi, epi.add
        w.open("")
        w("int lz; float t; float u; int q;")
        w.open(f"for (lz = 0; lz < {G}; ++lz)")
        for i, s in enumerate(fc.srcs):
            op = "=" if i == 0 else "+="
            qp = qg.in_qp(add, i)
            sref = "qtmp[lz]" if i == fc.pos else f"{s}[{base} + lz]"
            w(f"t {op} (float)({sref} - {qp.zero_point}) * "
              f"{_flit(qg.rescale(add, i))};")
        self._act_float(add.activation, add.alpha)
        self._round_clamp(qg.out_qp(add).zero_point, f"{dst}[{base} + lz]")
        w.close()
        w.close()

    def _vec_requant_fused(self, eff: QISA, tf_init: str, mexpr: str,
                           act: Optional[str], alpha: float, zp_mid: int,
                           base: str, dst: str) -> None:
        """Wide-x86 vector form of the fused-Add epilogue: requantize
        the producer vector to its int8 codes in-register (same
        trunc+fixup floor, with an explicit min/max standing in for the
        pack instruction's saturation), then run the Add's per-edge
        dequant sum, activation and output requant on the whole group.
        Bit-exact with :meth:`_fused_lane_loop` — mul and add stay
        separate intrinsics, so no contraction can change a rounding —
        which remains the fallback for the 128-bit variants (the SSE2
        tier has no ``_mm_min_epi32``) and NEON."""
        fc = self._fuse
        qg, w, add = self.qg, self.w, fc.add
        w.open("")
        w(f"__m256 tf = {tf_init};")
        w(f"tf = _mm256_mul_ps(tf, {mexpr});")
        if act == "relu":
            w("tf = _mm256_max_ps(tf, _mm256_setzero_ps());")
        elif act == "leaky_relu":
            w(f"tf = _mm256_max_ps(tf, _mm256_mul_ps(tf, "
              f"_mm256_set1_ps({_flit(alpha)})));")
        w("__m256 uf = _mm256_add_ps(tf, _mm256_set1_ps(0.5f));")
        w("__m256i qi = _mm256_cvttps_epi32(uf);")
        w("qi = _mm256_add_epi32(qi, _mm256_castps_si256("
          "_mm256_cmp_ps(_mm256_cvtepi32_ps(qi), uf, _CMP_GT_OQ)));")
        w(f"qi = _mm256_add_epi32(qi, _mm256_set1_epi32({zp_mid}));")
        w("qi = _mm256_min_epi32(_mm256_max_epi32(qi, "
          "_mm256_set1_epi32(-128)), _mm256_set1_epi32(127));")
        for i, s in enumerate(fc.srcs):
            qp = qg.in_qp(add, i)
            if i == fc.pos:
                vi = f"_mm256_sub_epi32(qi, _mm256_set1_epi32({qp.zero_point}))"
            else:
                w(f"__m256i v{i} = _mm256_cvtepi8_epi32(_mm_loadl_epi64("
                  f"(const __m128i *)({s} + {base})));")
                vi = (f"_mm256_sub_epi32(v{i}, "
                      f"_mm256_set1_epi32({qp.zero_point}))")
            term = (f"_mm256_mul_ps(_mm256_cvtepi32_ps({vi}), "
                    f"_mm256_set1_ps({_flit(qg.rescale(add, i))}))")
            w(f"tf = {term};" if i == 0
              else f"tf = _mm256_add_ps(tf, {term});")
        if add.activation == "relu":
            w("tf = _mm256_max_ps(tf, _mm256_setzero_ps());")
        elif add.activation == "leaky_relu":
            w(f"tf = _mm256_max_ps(tf, _mm256_mul_ps(tf, "
              f"_mm256_set1_ps({_flit(add.alpha)})));")
        w("uf = _mm256_add_ps(tf, _mm256_set1_ps(0.5f));")
        w("qi = _mm256_cvttps_epi32(uf);")
        w("qi = _mm256_add_epi32(qi, _mm256_castps_si256("
          "_mm256_cmp_ps(_mm256_cvtepi32_ps(qi), uf, _CMP_GT_OQ)));")
        w(f"qi = _mm256_add_epi32(qi, "
          f"_mm256_set1_epi32({qg.out_qp(add).zero_point}));")
        w.open("")
        w("__m128i pk = _mm_packs_epi32(_mm256_castsi256_si128(qi), "
          "_mm256_extracti128_si256(qi, 1));")
        w("pk = _mm_packs_epi16(pk, pk);")
        w(f"_mm_storel_epi64((__m128i *)({dst} + {base}), pk);")
        w.close()
        w.close()

    def _round_clamp(self, zp_out, dst_expr: str) -> None:
        """``t`` (float, s_out units) -> int8 code at ``dst_expr``;
        round half up (``floor(t + 0.5)``), add the zero point
        (an int, or a per-channel table index expression), saturate.  The floor is truncate-then-fixup — exact for every
        in-range value and, unlike ``floorf``, never a libm call on
        pre-SSE4.1 targets (it was the requant hot spot).  Requires
        ``float t; float u; int q;`` declared in the enclosing block."""
        w = self.w
        w("u = t + 0.5f;")
        w("q = (int)u;")                      # trunc toward zero
        w(f"q = (q - ((float)q > u)) + {zp_out};")  # fix-up -> floor
        w(f"{dst_expr} = (signed char)"
          f"(q < -128 ? -128 : (q > 127 ? 127 : q));")

    def _act_float(self, act: Optional[str], alpha: float) -> None:
        if act in ("relu", "leaky_relu"):
            self.w(f"t = {self.act_scalar('t', act, alpha)};")

    def emit_padded_copy_i8(self, src: str, in_shape, pads, buf: str,
                            fill: str) -> Tuple[str, Tuple[int, int, int]]:
        """Int8 padded copy — byte-identical emission to the float
        version (element type comes from the arena declaration);
        ``fill`` is the input zero-point code for conv/avg sums
        (cancelled by the folded bias correction) or -128 for max
        pooling."""
        return self.emit_padded_copy(src, in_shape, pads, buf, fill)

    def _madd16(self, x_expr: str, w_expr: str) -> None:
        """One SSE2 iteration: 16 int8 taps x 16 int8 weights summed
        into ``vacc`` (4 x int32) — sign-extend via unpack+srai, then
        ``_mm_madd_epi16``.  Emits the body of a block (decls first)."""
        w = self.w
        w(f"__m128i xv = _mm_loadu_si128((const __m128i *)({x_expr}));")
        w(f"__m128i wv = _mm_loadu_si128((const __m128i *)({w_expr}));")
        w("__m128i xlo = _mm_srai_epi16(_mm_unpacklo_epi8(xv, xv), 8);")
        w("__m128i xhi = _mm_srai_epi16(_mm_unpackhi_epi8(xv, xv), 8);")
        w("__m128i wlo = _mm_srai_epi16(_mm_unpacklo_epi8(wv, wv), 8);")
        w("__m128i whi = _mm_srai_epi16(_mm_unpackhi_epi8(wv, wv), 8);")
        w("vacc = _mm_add_epi32(vacc, _mm_madd_epi16(xlo, wlo));")
        w("vacc = _mm_add_epi32(vacc, _mm_madd_epi16(xhi, whi));")

    def _dot_inner(self, src: str, wname: str, row: int, use_sse: bool,
                   x_base: str, w_base: str) -> None:
        """``acc += sum_z src[x_base+z] * w[w_base+z]`` over a
        contiguous run of ``row`` taps (one window row, all channels).
        SSE2 path: 16 int8 taps/iteration via sign-extend + madd; the
        remainder and the scalar mode share the same exact int32 sum."""
        w = self.w
        w.open("")
        w(f"const signed char *xr = {src} + {x_base};")
        w(f"const signed char *wr = {wname} + {w_base};")
        if use_sse:
            w.open("")
            w("int z;")
            w.open(f"for (z = 0; z + 16 <= {row}; z += 16)")
            self._madd16("xr + z", "wr + z")
            w.close()
            w(f"for (; z < {row}; ++z) acc += xr[z] * wr[z];")
            w.close()
        else:
            w(_cfor("z", row, "acc += xr[z] * wr[z];"))
        w.close()

    def _hsum_sse(self) -> None:
        w = self.w
        w("vacc = _mm_add_epi32(vacc, _mm_srli_si128(vacc, 8));")
        w("vacc = _mm_add_epi32(vacc, _mm_srli_si128(vacc, 4));")
        w("acc += _mm_cvtsi128_si32(vacc);")

    # -- tiled dot-product kernels --------------------------------------------

    @property
    def qisa(self) -> Optional[QISA]:
        return QISAS.get(self.opts.simd)

    @property
    def _x86(self) -> bool:
        q = self.qisa
        return q is not None and q.arch == "x86"

    def _layer_qisa(self, wt: np.ndarray, co: int, kh: int,
                    row: int) -> Optional[QISA]:
        """The kernel variant actually emitted for one weighted layer:
        the session's variant when the layer tiles (>= one full channel
        group), with the per-layer ``avx_ubs`` -> ``avx`` demotion when
        the weights cannot prove ``vpmaddubsw`` saturation-free."""
        q = self.qisa
        if q is None or co < q.group:
            return None
        if q.name == "avx_ubs" and not maddubsw_safe(wt, co, kh, row):
            return QISAS["avx"]
        return q

    def _vec_requant(self, eff: QISA, tf_init: str, mexpr: Optional[str],
                     act: Optional[str], alpha: float, is_sink: bool,
                     zp: int, dstp: str,
                     zp_vec: Optional[str] = None) -> None:
        """The fused requant epilogue on one ``group``-wide vector:
        float rescale, activation, round-half-up (trunc+fixup floor, the
        scalar emitter's exact sequence), zero point, saturating int8
        pack, one store — no scalar round trip.  ``tf_init`` yields the
        pre-scale float vector (an int32 accumulator convert, or a raw
        float load for input quantization); ``mexpr`` the multiplier
        vector (``None`` to skip); ``dstp`` the destination pointer
        (float for the sink, int8 codes otherwise).  ``zp_vec`` (a
        pointer expression into a per-channel zero-point table)
        replaces the scalar ``zp`` broadcast for per-channel requant."""
        w = self.w
        if eff.arch == "arm":
            w.open("")
            w(f"float32x4_t tf = {tf_init};")
            if mexpr is not None:
                w(f"tf = vmulq_f32(tf, {mexpr});")
            if act == "relu":
                w("tf = vmaxq_f32(tf, vdupq_n_f32(0.0f));")
            elif act == "leaky_relu":
                w(f"tf = vmaxq_f32(tf, vmulq_f32(tf, "
                  f"vdupq_n_f32({_flit(alpha)})));")
            if is_sink:
                w(f"vst1q_f32({dstp}, tf);")
                w.close()
                return
            # vrndm (floor) then truncating convert == the scalar
            # trunc+fixup floor for every non-saturating value
            w("float32x4_t uf = vaddq_f32(tf, vdupq_n_f32(0.5f));")
            w("int32x4_t qi = vcvtq_s32_f32(vrndmq_f32(uf));")
            if zp_vec is not None:
                w(f"qi = vaddq_s32(qi, vld1q_s32({zp_vec}));")
            else:
                w(f"qi = vaddq_s32(qi, vdupq_n_s32({zp}));")
            w.open("")
            w("int16x4_t q16 = vqmovn_s32(qi);")
            w("int8x8_t q8 = vqmovn_s16(vcombine_s16(q16, q16));")
            w("int s4 = vget_lane_s32(vreinterpret_s32_s8(q8), 0);")
            w(f"memcpy({dstp}, &s4, 4);")
            w.close()
            w.close()
            return
        pfx = "_mm256" if eff.wide else "_mm"
        rf = "__m256" if eff.wide else "__m128"
        w.open("")
        w(f"{rf} tf = {tf_init};")
        if mexpr is not None:
            w(f"tf = {pfx}_mul_ps(tf, {mexpr});")
        if act == "relu":
            w(f"tf = {pfx}_max_ps(tf, {pfx}_setzero_ps());")
        elif act == "leaky_relu":
            w(f"tf = {pfx}_max_ps(tf, {pfx}_mul_ps(tf, "
              f"{pfx}_set1_ps({_flit(alpha)})));")
        if is_sink:
            w(f"{pfx}_storeu_ps({dstp}, tf);")
            w.close()
            return
        w(f"{rf} uf = {pfx}_add_ps(tf, {pfx}_set1_ps(0.5f));")
        w(f"{rf}i qi = {pfx}_cvttps_epi32(uf);")
        if eff.wide:
            w("qi = _mm256_add_epi32(qi, _mm256_castps_si256("
              "_mm256_cmp_ps(_mm256_cvtepi32_ps(qi), uf, _CMP_GT_OQ)));")
        else:
            w("qi = _mm_add_epi32(qi, _mm_castps_si128("
              "_mm_cmpgt_ps(_mm_cvtepi32_ps(qi), uf)));")
        if zp_vec is not None:
            ri = "__m256i" if eff.wide else "__m128i"
            ld = "_mm256_loadu_si256" if eff.wide else "_mm_loadu_si128"
            w(f"qi = {pfx}_add_epi32(qi, {ld}((const {ri} *)"
              f"({zp_vec})));")
        else:
            w(f"qi = {pfx}_add_epi32(qi, {pfx}_set1_epi32({zp}));")
        w.open("")
        if eff.wide:
            w("__m128i pk = _mm_packs_epi32(_mm256_castsi256_si128(qi), "
              "_mm256_extracti128_si256(qi, 1));")
            w("pk = _mm_packs_epi16(pk, pk);")
            w(f"_mm_storel_epi64((__m128i *)({dstp}), pk);")
        else:
            w("__m128i pk = _mm_packs_epi16(_mm_packs_epi32(qi, qi), qi);")
            w("int s4 = _mm_cvtsi128_si32(pk);")
            w(f"memcpy({dstp}, &s4, 4);")
        w.close()
        w.close()

    def _tiled_x_block(self, eff: QISA, n: int, t0: int, real: int) -> None:
        """Broadcast ``lane_taps`` consecutive input codes from window
        row ``n`` into ``vx`` (declared here).  Full blocks are one
        4-byte load (or a 2-tap sign-extended pair); the statically-last
        partial block of each row builds the word from single bytes so
        the zero-padded weight lanes never read past the row."""
        w = self.w
        L = eff.lane_taps
        if eff.arch == "arm" and L == 1:
            w(f"const int16x4_t vx = vdup_n_s16((short)xr{n}[{t0}]);")
            return
        w("int xp;")
        if L == 2:
            if real == 2:
                w(f"xp = (int)(((unsigned)xr{n}[{t0 + 1}] << 16) | "
                  f"((unsigned)xr{n}[{t0}] & 0xffffu));")
            else:
                w(f"xp = (int)((unsigned)xr{n}[{t0}] & 0xffffu);")
            w(f"{'__m256i' if eff.wide else '__m128i'} vx = "
              f"{'_mm256' if eff.wide else '_mm'}_set1_epi32(xp);")
            return
        # L == 4 (vnni / maddubsw / neon_dot)
        if real == 4:
            w(f"memcpy(&xp, xr{n} + {t0}, 4);")
        else:
            parts = [f"((unsigned)(xr{n}[{t0 + i}] & 255) << {8 * i})"
                     for i in range(real)]
            w(f"xp = (int)({' | '.join(parts)});")
        if eff.arch == "arm":
            w("int8x16_t vx = vreinterpretq_s8_s32(vdupq_n_s32(xp));")
        elif eff.unsigned_x:
            w("__m256i vx = _mm256_xor_si256(_mm256_set1_epi32(xp), "
              "vflip);")
        else:
            w("__m256i vx = _mm256_set1_epi32(xp);")

    def _tiled_acc_line(self, eff: QISA, g: int, wname: str,
                        off: int) -> str:
        if eff.name == "avx_vnni":
            return (f"acc{g} = _mm256_dpbusd_epi32(acc{g}, vx, "
                    f"_mm256_loadu_si256((const __m256i *)"
                    f"({wname} + {off})));")
        if eff.name == "avx_ubs":
            return (f"acc{g} = _mm256_add_epi32(acc{g}, _mm256_madd_epi16("
                    f"_mm256_maddubs_epi16(vx, _mm256_loadu_si256("
                    f"(const __m256i *)({wname} + {off}))), vone16));")
        if eff.name == "avx":
            return (f"acc{g} = _mm256_add_epi32(acc{g}, _mm256_madd_epi16("
                    f"vx, _mm256_loadu_si256((const __m256i *)"
                    f"({wname} + {off}))));")
        if eff.name == "sse":
            return (f"acc{g} = _mm_add_epi32(acc{g}, _mm_madd_epi16(vx, "
                    f"_mm_loadu_si128((const __m128i *)({wname} + {off}))));")
        if eff.name == "neon_dot":
            return (f"acc{g} = vdotq_s32(acc{g}, vx, "
                    f"vld1q_s8({wname} + {off}));")
        return (f"acc{g} = vmlal_s16(acc{g}, vx, "
                f"vld1_s16({wname} + {off}));")  # neon vmlal_s16

    def _emit_tiled_layer(self, eff: QISA, *, src: str, dst: str, co: int,
                          kh: int, row: int, wt: np.ndarray,
                          bias_main: np.ndarray, bias_plain: np.ndarray,
                          scales: np.ndarray, act: Optional[str],
                          alpha: float, is_sink: bool, zp_out: int,
                          xbase, xbase_var: str, oidx: str,
                          opos=(0, 0),
                          zp_tab: Optional[str] = None) -> None:
        """The register-tiled channel-group kernel for one conv/dense
        layer (caller has opened the output-position loops and resolved
        padding).  Weight tiles are packed so each dot instruction feeds
        ``group`` output-channel accumulators from one broadcast of the
        input taps; accumulators stay in registers from the int32 bias
        load to the fused requant store.  Channels past the last full
        group run the per-channel rolled fallback (bit-identical: int32
        sums are exact in any order)."""
        w = self.w
        G, L = eff.group, eff.lane_taps
        ng = co // G
        taps = kh * row
        packed, P = _pack_qweights(wt, co, kh, row, G, L)
        if L == 4:
            wname = self.const_i8(f"w{self.uid()}", packed)
        else:
            wname = self.const_i16(f"w{self.uid()}", packed)
        bname = self.const_i32(f"b{self.uid()}", bias_main[:ng * G])
        mname = self.const_array(f"m{self.uid()}", scales)
        k0 = ng * G
        if k0 < co:
            wtail = self.const_i8(f"wt{self.uid()}", wt[k0:])
            btail = self.const_i32(f"bt{self.uid()}", bias_plain[k0:])
        x86 = eff.arch == "x86"
        for c0 in range(0, ng, _QTILE_MAX_GROUPS):
            gs = list(range(c0, min(c0 + _QTILE_MAX_GROUPS, ng)))
            w.open("")
            for n in range(kh):
                w(f"const signed char *xr{n} = {src} + {xbase(n)};")
            if eff.unsigned_x:
                w("const __m256i vflip = _mm256_set1_epi8(-128);")
            if eff.name == "avx_ubs":
                w("const __m256i vone16 = _mm256_set1_epi16(1);")
            for g in gs:
                if eff.name == "sse":
                    w(f"__m128i acc{g} = _mm_loadu_si128((const __m128i *)"
                      f"({bname} + {g * G}));")
                elif x86:
                    w(f"__m256i acc{g} = _mm256_loadu_si256("
                      f"(const __m256i *)({bname} + {g * G}));")
                else:
                    w(f"int32x4_t acc{g} = vld1q_s32({bname} + {g * G});")
            if self._epi is not None and not (
                    isinstance(self._epi, AddFuse) and x86 and eff.wide):
                # fused epilogue, lane-loop fallback: the vector requant
                # packs the producer's codes here, the scalar lane loop
                # then runs the consumer arithmetic (bit-exact with the
                # unfused path)
                w(f"signed char qtmp[{G}];")
            for n in range(kh):
                for p in range(P):
                    t0 = p * L
                    real = min(L, row - t0)
                    w.open("")
                    self._tiled_x_block(eff, n, t0, real)
                    for g in gs:
                        off = ((n * P + p) * ng + g) * (G * L)
                        w(self._tiled_acc_line(eff, g, wname, off))
                    w.close()
            for g in gs:
                if x86:
                    pfx = "_mm256" if eff.wide else "_mm"
                    tf_init = f"{pfx}_cvtepi32_ps(acc{g})"
                    mexpr = f"{pfx}_loadu_ps({mname} + {g * G})"
                else:
                    tf_init = f"vcvtq_f32_s32(acc{g})"
                    mexpr = f"vld1q_f32({mname} + {g * G})"
                if self._fuse is not None and x86 and eff.wide:
                    self._vec_requant_fused(eff, tf_init, mexpr, act,
                                            alpha, zp_out,
                                            f"{oidx} + {g * G}", dst)
                elif self._epi is not None:
                    self._vec_requant(eff, tf_init, mexpr, act, alpha,
                                      False, zp_out, "qtmp")
                    self._fused_lane_loop(G, f"{oidx} + {g * G}", dst,
                                          pos=(opos[0], opos[1], g * G))
                else:
                    dstp = (f"out + {oidx} + {g * G}" if is_sink
                            else f"{dst} + {oidx} + {g * G}")
                    self._vec_requant(
                        eff, tf_init, mexpr, act, alpha, is_sink,
                        zp_out, dstp,
                        zp_vec=(f"{zp_tab} + {g * G}"
                                if zp_tab is not None else None))
            w.close()
        if k0 < co:
            use_sse = x86 and row >= 16
            w.open("")
            w("int kk;")
            w.open(f"for (kk = 0; kk < {co - k0}; ++kk)")
            w.open("")
            w(f"int acc = {btail}[kk];")
            w("float t;" if is_sink else self._req_decls)
            if use_sse:
                w("__m128i vacc = _mm_setzero_si128();")
            self.floop("n", kh)
            self._dot_inner(src, wtail, row, use_sse, xbase_var,
                            f"kk * {taps} + n * {row}")
            self.fclose()
            if use_sse:
                self._hsum_sse()
            w(f"t = (float)acc * {mname}[{k0} + kk];")
            self._act_float(act, alpha)
            if is_sink:
                w(f"out[{oidx} + {k0} + kk] = t;")
            else:
                self._q_store(
                    f"{zp_tab}[{k0} + kk]" if zp_tab is not None
                    else zp_out,
                    f"{oidx} + {k0} + kk", dst,
                    pos=(opos[0], opos[1], f"{k0} + kk"))
            w.close()
            w.close()
            w.close()

    # -- weighted layers ------------------------------------------------------

    def emit_qconv(self, layer: Conv2D, in_shape, src: str, dst: str,
                   pad_buf: Optional[str], is_sink: bool) -> None:
        qg, w = self.qg, self.w
        oh, ow, co = layer.out_shape(in_shape)
        sh, sw = layer.strides
        kh, kw_, ci = layer.kh, layer.kw, layer.c_in
        pads = layer.pad_amounts(in_shape)
        zp_in = qg.in_qp(layer).zero_point
        act = layer.activation
        w(f"/* QConv2D {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} act={act} "
          f"int8/int32 */")
        if any(pads):
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy_i8(
                src, in_shape, pads, pad_buf, str(zp_in))
        h, wdt, _ = in_shape
        row = kw_ * ci
        taps = kh * row
        # taps of one output channel contiguous: (co, kh, kw, ci)
        wt = np.transpose(qg.weights[layer.name].w_q,
                          (3, 0, 1, 2)).reshape(co, taps)
        scales = (qg.dequant_scales(layer) if is_sink
                  else qg.requant_scales(layer))
        eff = self._layer_qisa(wt, co, kh, row)
        use_sse = self._x86 and row >= 16
        zp_out = 0 if is_sink else qg.out_qp(layer).zero_point
        cq = None if is_sink else qg.channel_qp(layer.name)
        if eff is not None:
            if eff.name != self.opts.simd:
                w(f"/* {layer.name}: maddubsw saturation unprovable, "
                  f"pair-madd variant */")
            zname = (self.const_i32(f"z{self.uid()}", cq.zero_point)
                     if cq is not None else None)
            self.floop("i", oh)
            self.floop("j", ow)
            self._emit_tiled_layer(
                eff, src=src, dst=dst, co=co, kh=kh, row=row, wt=wt,
                bias_main=qg.effective_bias(
                    layer, 128 if eff.unsigned_x else 0),
                bias_plain=qg.effective_bias(layer), scales=scales,
                act=act, alpha=layer.alpha, is_sink=is_sink,
                zp_out=zp_out,
                xbase=lambda n: (f"((i * {sh} + {n}) * {wdt} + "
                                 f"j * {sw}) * {ci}"),
                xbase_var=f"((i * {sh} + n) * {wdt} + j * {sw}) * {ci}",
                oidx=f"(i * {ow} + j) * {co}", opos=("i", "j"),
                zp_tab=zname)
            self.fclose(2)
            if is_sink and act == "softmax":
                self.emit_softmax((oh, ow, co), "out")
            return
        if taps >= 16:  # tiny-window branch uses literals
            bname = self.const_i32(f"b{self.uid()}",
                                   qg.effective_bias(layer))
            mname = self.const_array(f"m{self.uid()}", scales)
            zname = (self.const_i32(f"z{self.uid()}", cq.zero_point)
                     if cq is not None else None)

        def requant_one(oidx: str, pos) -> None:
            w(f"t = (float)acc * {mname}[k];")
            self._act_float(act, layer.alpha)
            if is_sink:
                w(f"out[{oidx}] = t;")
            else:
                self._q_store(
                    f"{zname}[k]" if cq is not None
                    else qg.out_qp(layer).zero_point,
                    oidx, dst, pos=pos)

        if taps < 16:
            # tiny window (e.g. first conv on a 1-channel image):
            # straight-line taps with the int8 weight codes as literals
            # (P3) — no const arrays, no inner loop overhead
            bias_eff = qg.effective_bias(layer)
            self.floop("i", oh)
            self.floop("j", ow)
            for k in range(co):
                w.open("")
                w(f"int acc = {int(bias_eff[k])};")
                w("float t;" if is_sink else self._req_decls)
                for n in range(kh):
                    for m in range(kw_):
                        for o in range(ci):
                            c_w = int(wt[k, (n * kw_ + m) * ci + o])
                            if c_w == 0:
                                continue
                            w(f"acc += {c_w} * {src}[((i * {sh} + {n}) * "
                              f"{wdt} + (j * {sw} + {m})) * {ci} + {o}];")
                w(f"t = (float)acc * {_flit(scales[k])};")
                self._act_float(act, layer.alpha)
                if is_sink:
                    w(f"out[(i * {ow} + j) * {co} + {k}] = t;")
                else:
                    self._q_store(int(cq.zero_point[k]) if cq is not None
                                  else qg.out_qp(layer).zero_point,
                                  f"(i * {ow} + j) * {co} + {k}", dst,
                                  pos=("i", "j", k))
                w.close()
            self.fclose(2)
        else:
            wname = self.const_i8(f"w{self.uid()}", wt)
            self.floop("i", oh)
            self.floop("j", ow)
            self.floop("k", co)
            w.open("")
            w(f"int acc = {bname}[k];")
            w("float t;" if is_sink else self._req_decls)
            if use_sse:
                w("__m128i vacc = _mm_setzero_si128();")
            self.floop("n", kh)
            self._dot_inner(src, wname, row, use_sse,
                            f"((i * {sh} + n) * {wdt} + j * {sw}) * {ci}",
                            f"k * {taps} + n * {row}")
            self.fclose()
            if use_sse:
                self._hsum_sse()
            requant_one(f"(i * {ow} + j) * {co} + k", ("i", "j", "k"))
            w.close()
            self.fclose(3)
        if is_sink and act == "softmax":
            self.emit_softmax((oh, ow, co), "out")

    def emit_qdepthwise(self, layer: DepthwiseConv2D, in_shape, src: str,
                        dst: str, pad_buf: Optional[str],
                        is_sink: bool) -> None:
        qg, w = self.qg, self.w
        oh, ow, co = layer.out_shape(in_shape)
        sh, sw = layer.strides
        kh, kw_, ci, mult = layer.kh, layer.kw, layer.c_in, layer.multiplier
        pads = layer.pad_amounts(in_shape)
        zp_in = qg.in_qp(layer).zero_point
        act = layer.activation
        w(f"/* QDepthwiseConv2D {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} mult={mult} pad={layer.padding} "
          f"act={act} int8/int32 */")
        if any(pads):
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy_i8(
                src, in_shape, pads, pad_buf, str(zp_in))
        h, wdt, _ = in_shape
        wname = self.const_i8(f"w{self.uid()}",
                              qg.weights[layer.name].w_q)  # HWCM layout
        bname = self.const_i32(f"b{self.uid()}", qg.effective_bias(layer))
        scales = (qg.dequant_scales(layer) if is_sink
                  else qg.requant_scales(layer))
        mname = self.const_array(f"m{self.uid()}", scales)
        cq = None if is_sink else qg.channel_qp(layer.name)
        zname = (self.const_i32(f"z{self.uid()}", cq.zero_point)
                 if cq is not None else None)
        self.floop("i", oh)
        self.floop("j", ow)
        self.floop("c", ci)
        for m_ in range(mult):
            w.open("")
            w(f"int acc = {bname}[c * {mult} + {m_}];")
            w("float t;" if is_sink else self._req_decls)
            w(_cfor("n", kh, _cfor(
                "m", kw_,
                f"acc += {src}[((i * {sh} + n) * {wdt} + "
                f"(j * {sw} + m)) * {ci} + c] * "
                f"{wname}[((n * {kw_} + m) * {ci} + c) * {mult} + {m_}];")))
            oidx = f"(i * {ow} + j) * {co} + c * {mult} + {m_}"
            w(f"t = (float)acc * {mname}[c * {mult} + {m_}];")
            self._act_float(act, layer.alpha)
            if is_sink:
                w(f"out[{oidx}] = t;")
            else:
                self._q_store(
                    f"{zname}[c * {mult} + {m_}]" if cq is not None
                    else qg.out_qp(layer).zero_point,
                    oidx, dst, pos=("i", "j", f"c * {mult} + {m_}"))
            w.close()
        self.fclose(3)
        if is_sink and act == "softmax":
            self.emit_softmax((oh, ow, co), "out")

    def emit_qdense(self, layer: Dense, in_shape, src: str, dst: str,
                    is_sink: bool) -> None:
        qg, w = self.qg, self.w
        d_in, d_out = layer.weights.shape
        act = layer.activation
        w(f"/* QDense {layer.name}: {d_in}->{d_out} int8/int32 */")
        wt = qg.weights[layer.name].w_q.T  # (d_out, d_in)
        scales = (qg.dequant_scales(layer) if is_sink
                  else qg.requant_scales(layer))
        cq = None if is_sink else qg.channel_qp(layer.name)
        eff = self._layer_qisa(wt, d_out, 1, d_in)
        if eff is not None:
            if eff.name != self.opts.simd:
                w(f"/* {layer.name}: maddubsw saturation unprovable, "
                  f"pair-madd variant */")
            zname = (self.const_i32(f"z{self.uid()}", cq.zero_point)
                     if cq is not None else None)
            self._emit_tiled_layer(
                eff, src=src, dst=dst, co=d_out, kh=1, row=d_in, wt=wt,
                bias_main=qg.effective_bias(
                    layer, 128 if eff.unsigned_x else 0),
                bias_plain=qg.effective_bias(layer), scales=scales,
                act=act, alpha=layer.alpha, is_sink=is_sink,
                zp_out=0 if is_sink else qg.out_qp(layer).zero_point,
                xbase=lambda n: "0", xbase_var="0", oidx="0",
                zp_tab=zname)
            if is_sink and act == "softmax":
                self.emit_softmax((1, 1, d_out), "out")
            return
        wname = self.const_i8(f"w{self.uid()}", wt)
        bname = self.const_i32(f"b{self.uid()}", qg.effective_bias(layer))
        mname = self.const_array(f"m{self.uid()}", scales)
        zname = (self.const_i32(f"z{self.uid()}", cq.zero_point)
                 if cq is not None else None)
        use_sse = self._x86 and d_in >= 16
        self.floop("k", d_out)
        w.open("")
        w(f"int acc = {bname}[k];")
        w("float t;" if is_sink else self._req_decls)
        if use_sse:
            w("__m128i vacc = _mm_setzero_si128();")
        self._dot_inner(src, wname, d_in, use_sse, "0", f"k * {d_in}")
        if use_sse:
            self._hsum_sse()
        w(f"t = (float)acc * {mname}[k];")
        self._act_float(act, layer.alpha)
        if is_sink:
            w("out[k] = t;")
        else:
            self._q_store(f"{zname}[k]" if cq is not None
                          else qg.out_qp(layer).zero_point,
                          "k", dst, pos=(0, 0, "k"))
        w.close()
        self.fclose()
        if is_sink and act == "softmax":
            self.emit_softmax((1, 1, d_out), "out")

    # -- pooling / merge / elementwise ---------------------------------------

    def emit_qmaxpool(self, layer: MaxPool, in_shape, src: str, dst: str,
                      pad_buf: Optional[str]) -> None:
        w = self.w
        oh, ow, co = layer.out_shape(in_shape)
        kh, kw_ = layer.size
        sh, sw = layer.strides
        pads = layer.pad_amounts(in_shape)
        w(f"/* QMaxPool {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} (pure int8, "
          f"shared qparams) */")
        if any(pads):
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy_i8(
                src, in_shape, pads, pad_buf, "-128")
        h, wdt, c = in_shape

        def idx(n, m):
            return (f"((i * {sh} + {n}) * {wdt} + (j * {sw} + {m})) "
                    f"* {c} + k")

        def scalar_max(qv: str) -> None:
            w(f"signed char {qv} = {src}[{idx(0, 0)}];")
            for n in range(kh):
                for m in range(kw_):
                    if n == 0 and m == 0:
                        continue
                    w(f"{qv} = {src}[{idx(n, m)}] > {qv} ? "
                      f"{src}[{idx(n, m)}] : {qv};")
            w(f"{dst}[(i * {ow} + j) * {co} + k] = {qv};")

        q = self.qisa
        if q is not None and c >= 16:
            self.floop("i", oh)
            self.floop("j", ow)
            w.open("")
            w("int k;")
            w.open(f"for (k = 0; k + 16 <= {c}; k += 16)")
            w.open("")
            if q.arch == "x86":
                # pmaxsb needs SSE4.1 — xor 0x80 / max_epu8 / xor is
                # the SSE2-safe signed byte max
                w("const __m128i vf = _mm_set1_epi8(-128);")
                w(f"__m128i mx = _mm_xor_si128(_mm_loadu_si128("
                  f"(const __m128i *)({src} + {idx(0, 0)})), vf);")
                for n in range(kh):
                    for m in range(kw_):
                        if n == 0 and m == 0:
                            continue
                        w(f"mx = _mm_max_epu8(mx, _mm_xor_si128("
                          f"_mm_loadu_si128((const __m128i *)"
                          f"({src} + {idx(n, m)})), vf));")
                w(f"_mm_storeu_si128((__m128i *)({dst} + "
                  f"(i * {ow} + j) * {co} + k), _mm_xor_si128(mx, vf));")
            else:
                w(f"int8x16_t mx = vld1q_s8({src} + {idx(0, 0)});")
                for n in range(kh):
                    for m in range(kw_):
                        if n == 0 and m == 0:
                            continue
                        w(f"mx = vmaxq_s8(mx, "
                          f"vld1q_s8({src} + {idx(n, m)}));")
                w(f"vst1q_s8({dst} + (i * {ow} + j) * {co} + k, mx);")
            w.close()
            w.close()
            if c % 16:
                w.open(f"for (; k < {c}; ++k)")
                w.open("")
                scalar_max("qv")
                w.close()
                w.close()
            w.close()
            self.fclose(2)
            return
        self.floop("i", oh)
        self.floop("j", ow)
        self.floop("k", c)
        w.open("")
        scalar_max("q")
        w.close()
        self.fclose(3)

    def emit_qavgpool(self, layer: AvgPool, in_shape, src: str, dst: str,
                      pad_buf: Optional[str]) -> None:
        qg, w = self.qg, self.w
        oh, ow, co = layer.out_shape(in_shape)
        kh, kw_ = layer.size
        sh, sw = layer.strides
        pads = layer.pad_amounts(in_shape)
        zp_in = qg.in_qp(layer).zero_point
        minv = qg.pool_scales(layer, in_shape)  # (oh, ow) float32
        w(f"/* QAvgPool {layer.name}: {in_shape}->{(oh, ow, co)} "
          f"k={kh}x{kw_} s={sh}x{sw} pad={layer.padding} int8/int32 */")
        if any(pads):
            # zp fill: padded taps sum as zp and the fixed kh*kw*zp
            # correction below cancels them exactly
            assert pad_buf is not None, f"{layer.name}: unplanned pad scratch"
            src, in_shape = self.emit_padded_copy_i8(
                src, in_shape, pads, pad_buf, str(zp_in))
        h, wdt, c = in_shape
        if np.unique(minv).size == 1:
            mexpr = _flit(minv.ravel()[0])
        else:
            mname = self.const_array(f"pinv{self.uid()}", minv)
            mexpr = f"{mname}[i * {ow} + j]"
        self.floop("i", oh)
        self.floop("j", ow)
        self.floop("k", c)
        w.open("")
        w("int acc = 0;")
        w(self._REQ_DECLS)
        w(_cfor("n", kh, _cfor(
            "m", kw_,
            f"acc += {src}[((i * {sh} + n) * {wdt} + "
            f"(j * {sw} + m)) * {c} + k];")))
        w(f"t = (float)(acc - {kh * kw_ * zp_in}) * {mexpr};")
        self._round_clamp(qg.out_qp(layer).zero_point,
                          f"{dst}[(i * {ow} + j) * {co} + k]")
        w.close()
        self.fclose(3)

    def emit_qglobal_avgpool(self, layer: GlobalAvgPool, in_shape,
                             src: str, dst: str) -> None:
        qg, w = self.qg, self.w
        h, wdt, c = in_shape
        zp_in = qg.in_qp(layer).zero_point
        minv = qg.pool_scales(layer, in_shape)  # scalar float32
        w(f"/* QGlobalAvgPool {layer.name}: {in_shape}->(1, 1, {c}) */")
        self.floop("k", c)
        w.open("")
        w("int acc = 0;")
        w(self._REQ_DECLS)
        w(_cfor("p", h * wdt, f"acc += {src}[p * {c} + k];"))
        w(f"t = (float)(acc - {h * wdt * zp_in}) * {_flit(minv)};")
        self._round_clamp(qg.out_qp(layer).zero_point, f"{dst}[k]")
        w.close()
        self.fclose()

    def emit_qadd(self, layer: Add, shape, srcs: List[str],
                  dst: str) -> None:
        qg, w = self.qg, self.w
        n = int(np.prod(shape))
        act = layer.activation
        w(f"/* QAdd {layer.name}: {len(srcs)} inputs, {shape}, "
          f"act={act} */")
        q = self.qisa
        zp_out = qg.out_qp(layer).zero_point
        nf = (n // 8) * 8
        if q is not None and q.arch == "x86" and q.wide and nf:
            # widen 8 codes, dequant per input, sum left-associated in
            # source order (same float op order as the scalar loop),
            # then the fused epilogue
            tf = None
            for i, s in enumerate(srcs):
                qp = qg.in_qp(layer, i)
                term = (f"_mm256_mul_ps(_mm256_cvtepi32_ps("
                        f"_mm256_sub_epi32(_mm256_cvtepi8_epi32("
                        f"_mm_loadl_epi64((const __m128i *)({s} + z))), "
                        f"_mm256_set1_epi32({qp.zero_point}))), "
                        f"_mm256_set1_ps({_flit(qg.rescale(layer, i))}))")
                tf = term if tf is None else f"_mm256_add_ps({tf}, {term})"
            w.open("")
            w("int z;")
            w.open(f"for (z = 0; z < {nf}; z += 8)")
            self._vec_requant(q, tf, None, act, layer.alpha, False,
                              zp_out, f"{dst} + z")
            w.close()
            w.open(f"for (z = {nf}; z < {n}; ++z)")
            self._qadd_scalar_body(layer, srcs, dst, act, zp_out)
            w.close()
            w.close()
            return
        self.floop("z", n)
        self._qadd_scalar_body(layer, srcs, dst, act, zp_out)
        self.fclose()

    def _qadd_scalar_body(self, layer: Add, srcs: List[str], dst: str,
                          act: Optional[str], zp_out: int) -> None:
        qg, w = self.qg, self.w
        w.open("")
        w(self._REQ_DECLS)
        for i, s in enumerate(srcs):
            op = "=" if i == 0 else "+="
            qp = qg.in_qp(layer, i)
            w(f"t {op} (float)({s}[z] - {qp.zero_point}) * "
              f"{_flit(qg.rescale(layer, i))};")
        self._act_float(act, layer.alpha)
        self._round_clamp(zp_out, f"{dst}[z]")
        w.close()

    def emit_qconcat(self, layer: Concat, in_shapes, srcs: List[str],
                     dst: str) -> None:
        qg, w = self.qg, self.w
        h, wdt, _ = in_shapes[0]
        co = int(sum(s[2] for s in in_shapes))
        zp_out = qg.out_qp(layer).zero_point
        fused_by_p = self.schedule.fused_by_producer
        fused = [fused_by_p.get(n) == layer.name for n in layer.inputs]
        w(f"/* QConcat {layer.name}: {[tuple(s) for s in in_shapes]} -> "
          f"({h}, {wdt}, {co}) (per-input requant) */")
        if all(fused):
            w("/* all inputs fused into their producers' stores */")
            return
        self.floop("p", h * wdt)
        off = 0
        for i, (s, ish) in enumerate(zip(srcs, in_shapes)):
            ck = int(ish[2])
            if fused[i]:
                off += ck
                continue
            qp = qg.in_qp(layer, i)
            # the multiply and the +0.5f stay separate statements: in
            # one expression an FP_CONTRACT-honoring compiler could
            # fuse them into an FMA (single rounding) and break the
            # bit-exact contract with the int8 reference
            w(_cfor(
                "z", ck,
                f"{{ float t; float u; int q; "
                f"t = (float)({s}[p * {ck} + z] - {qp.zero_point}) * "
                f"{_flit(qg.rescale(layer, i))}; "
                f"u = t + 0.5f; "
                f"q = (int)u; "
                f"q = (q - ((float)q > u)) + {zp_out}; "
                f"{dst}[p * {co} + {off} + z] = (signed char)"
                f"(q < -128 ? -128 : (q > 127 ? 127 : q)); }}"))
            off += ck
        self.fclose()

    def emit_qrelu(self, layer, in_shape, src: str, dst: str,
                   act: str, alpha: float) -> None:
        qg, w = self.qg, self.w
        n = int(np.prod(in_shape))
        qp = qg.in_qp(layer)
        w(f"/* Q{type(layer).__name__} {layer.name}: {in_shape} */")
        self.floop("z", n)
        w.open("")
        w(self._REQ_DECLS)
        w(f"t = (float)({src}[z] - {qp.zero_point}) * "
          f"{_flit(qg.rescale(layer))};")
        self._act_float(act, alpha)
        self._round_clamp(qg.out_qp(layer).zero_point, f"{dst}[z]")
        w.close()
        self.fclose()

    def emit_qsoftmax_sink(self, layer: Softmax, in_shape,
                           src: str) -> None:
        qg, w = self.qg, self.w
        n = int(np.prod(in_shape))
        qp = qg.in_qp(layer)
        w(f"/* QSoftmax {layer.name} (sink): dequantize + float "
          f"softmax */")
        w(_cfor("z", n,
                f"out[z] = (float)({src}[z] - {qp.zero_point}) * "
                f"{_flit(np.float32(qp.scale))};"))
        self.emit_softmax(in_shape, "out")

    # -- driver ---------------------------------------------------------------

    def _emit_fuse_init(self, node: FuseNode, smap) -> None:
        """Int8 fusion prologue: max pooling fills the consumer's codes
        with -128 (the reduction identity — every window sees >= 1
        producer code), average pooling zeroes the int32 window-sum
        scratch the producer stores accumulate into."""
        if isinstance(node, PoolFuse):
            p = node.pool
            self.w(f"/* fused Q{type(p).__name__} {p.name}: producer "
                   f"stores reduce straight into the {node.kind} "
                   f"windows */")
            if node.kind == "max":
                self.w(_cfor("z", node.n, f"{node.dst}[z] = -128;"))
            else:
                self.w(_cfor("z", node.n, f"{node.acc}[z] = 0;"))
        elif isinstance(node, ConcatFuse):
            self.w(f"/* fused QConcat {node.concat.name} edge "
                   f"{node.pos}: producer writes its channel slice at "
                   f"offset {node.c_off} directly */")

    def _emit_fuse_finalize(self, node: FuseNode, smap) -> None:
        """Int8 fusion epilogue: average pooling requantizes the int32
        window sums — the exact :meth:`emit_qavgpool` arithmetic, so
        fused results stay bit-identical."""
        if not (isinstance(node, PoolFuse) and node.kind == "avg"):
            return
        qg, w = self.qg, self.w
        p = node.pool
        kh, kw_ = p.size
        zp_in = qg.in_qp(p).zero_point
        minv = qg.pool_scales(p, smap[p.inputs[0]])
        assert np.unique(minv).size == 1, \
            f"{p.name}: fused avg pool requires a uniform window divisor"
        mexpr = _flit(minv.ravel()[0])
        self.floop("z", node.n)
        w.open("")
        w(self._REQ_DECLS)
        w(f"t = (float)({node.acc}[z] - {kh * kw_ * zp_in}) * {mexpr};")
        self._round_clamp(qg.out_qp(p).zero_point, f"{node.dst}[z]")
        w.close()
        self.fclose()

    def _emit_input_quant(self, xsrc: str) -> None:
        """Input quantization prologue: float ``xsrc`` -> int8 codes in
        the ``xq`` arena value (vectorized when a QISA is active)."""
        g, w = self.g, self.w
        in_qp = self.qg.input_qp
        q = self.qisa
        n_in = int(np.prod(g.input_shape))
        w(f"/* quantize input: q = floor(x * {in_qp.inv_scale} + 0.5) "
          f"+ {in_qp.zero_point} */")
        nf = (n_in // q.group) * q.group if q is not None else 0
        w.open("")
        w("int z;")
        if nf:
            if q.arch == "x86":
                pfx = "_mm256" if q.wide else "_mm"
                tf_init = f"{pfx}_loadu_ps({xsrc} + z)"
                mexpr = f"{pfx}_set1_ps({_flit(in_qp.inv_scale)})"
            else:
                tf_init = f"vld1q_f32({xsrc} + z)"
                mexpr = f"vdupq_n_f32({_flit(in_qp.inv_scale)})"
            w.open(f"for (z = 0; z < {nf}; z += {q.group})")
            self._vec_requant(q, tf_init, mexpr, None, 0.0, False,
                              in_qp.zero_point, f"{_cname('xq')} + z")
            w.close()
        if nf < n_in:
            w.open(f"for (z = {nf}; z < {n_in}; ++z)")
            w.open("")
            w(self._REQ_DECLS)
            w(f"t = {xsrc}[z] * {_flit(in_qp.inv_scale)};")
            self._round_clamp(in_qp.zero_point, f"{_cname('xq')}[z]")
            w.close()
            w.close()
        w.close()

    def _emit_layer(self, layer, smap, val, ref, plan) -> None:
        ishs = [smap[n] for n in layer.inputs]
        srcs = [ref(val[n]) for n in layer.inputs]
        dst = ref(val[layer.name])
        is_sink = layer is self.g.sink
        pad_buf = (_cname(layer.name + "__pad")
                   if layer.name + "__pad" in plan.offsets else None)
        if isinstance(layer, Conv2D):
            self.emit_qconv(layer, ishs[0], srcs[0], dst, pad_buf,
                            is_sink)
        elif isinstance(layer, DepthwiseConv2D):
            self.emit_qdepthwise(layer, ishs[0], srcs[0], dst,
                                 pad_buf, is_sink)
        elif isinstance(layer, Dense):
            self.emit_qdense(layer, ishs[0], srcs[0], dst, is_sink)
        elif isinstance(layer, MaxPool):
            self.emit_qmaxpool(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, AvgPool):
            self.emit_qavgpool(layer, ishs[0], srcs[0], dst, pad_buf)
        elif isinstance(layer, GlobalAvgPool):
            self.emit_qglobal_avgpool(layer, ishs[0], srcs[0], dst)
        elif isinstance(layer, Add):
            self.emit_qadd(layer, smap[layer.name], srcs, dst)
        elif isinstance(layer, Concat):
            self.emit_qconcat(layer, ishs, srcs, dst)
        elif isinstance(layer, ReLU):
            self.emit_qrelu(layer, ishs[0], srcs[0], dst, "relu", 0.0)
        elif isinstance(layer, LeakyReLU):
            self.emit_qrelu(layer, ishs[0], srcs[0], dst, "leaky_relu",
                            layer.alpha)
        elif isinstance(layer, Softmax):
            assert is_sink, "standalone Softmax only supported as sink"
            self.emit_qsoftmax_sink(layer, ishs[0], srcs[0])
        else:
            raise TypeError(
                f"quantized cgen: unhandled layer "
                f"{type(layer).__name__} "
                f"(run passes.optimize before quantizing)")

    def lower(self) -> Program:
        if self._program is not None:
            return self._program
        g, opts, w = self.g, self.opts, self.w
        sched = self.schedule
        smap = g.shape_map()
        plan = self.plan = plan_arena(g, opts, quantized=True,
                                      schedule=sched)
        val = _value_map(g, quantized=True, schedule=sched)
        sink = g.sink
        out_value = val[sink.name]
        assert out_value != "xq", "degenerate identity graph"
        S = sched.nstages
        self.ws_total_elems = plan.total_floats
        q = self.qisa

        def ref(v: str) -> str:
            return "out" if v == out_value else _cname(v)

        if S > 1:
            self._emit_pipeline(smap, val, out_value, plan)

        w.open(f"void {opts.ws_func_name}(const float *NNCG_RESTRICT x, "
               f"float *NNCG_RESTRICT out, "
               f"signed char *NNCG_RESTRICT ws)")
        if S > 1:
            w(f"{opts.pipeline_func_name}(x, out, ws, {S});")
        else:
            for iv in sorted(plan.intervals,
                             key=lambda iv: (iv.offset, iv.value)):
                if iv.value.endswith("__acc"):
                    # int32 window-sum scratch of a fused avg pool:
                    # planned 4-aligned inside the byte arena
                    w(f"int *const {_cname(iv.value)} = "
                      f"(int *)(void *)(ws + {iv.offset}); "
                      f"/* {iv.size} bytes, live layers "
                      f"[{iv.start}, {iv.end}] */")
                    continue
                w(f"signed char *const {_cname(iv.value)} = "
                  f"ws + {iv.offset}; "
                  f"/* {iv.size} bytes, live layers "
                  f"[{iv.start}, {iv.end}] */")
            if not plan.intervals:
                w("(void) ws;")
            self._emit_input_quant("x")
            self._emit_graph_body(g.layers, smap, val, ref, plan)
        w.close()

        arena = f"{opts.func_name}_arena"
        if any(iv.value.endswith("__acc") for iv in plan.intervals):
            # the byte arena hosts int32 scratch: declare it as an int
            # array so the fused avg-pool pointers are aligned
            self.decls(f"static int {arena}_i4"
                       f"[{(max(self.ws_total_elems, 1) + 3) // 4}];")
            arena_arg = f"(signed char *){arena}_i4"
        else:
            self.decls(f"static signed char {arena}"
                       f"[{max(self.ws_total_elems, 1)}];")
            arena_arg = arena
        w("")
        w.open(f"void {opts.func_name}(const float *NNCG_RESTRICT x, "
               f"float *NNCG_RESTRICT out)")
        w(f"{opts.ws_func_name}(x, out, {arena_arg});")
        w.close()
        w("")
        w.open(f"long {opts.ws_bytes_func_name}(void)")
        w(f"return {self.ws_total_elems}L;")
        w.close()

        if opts.emit_batch:
            in_n = int(np.prod(g.input_shape))
            out_n = int(np.prod(smap[sink.name]))
            w("")
            w.open(f"void {opts.batch_ws_func_name}("
                   f"const float *NNCG_RESTRICT x, "
                   f"float *NNCG_RESTRICT out, int n, "
                   f"signed char *NNCG_RESTRICT workspace)")
            w("int b;")
            w(f"for (b = 0; b < n; ++b) "
              f"{opts.ws_func_name}(x + (long)b * {in_n}, "
              f"out + (long)b * {out_n}, workspace);")
            w.close()
            w("")
            w.open(f"void {opts.batch_func_name}("
                   f"const float *NNCG_RESTRICT x, "
                   f"float *NNCG_RESTRICT out, int n)")
            w(f"{opts.batch_ws_func_name}(x, out, n, {arena_arg});")
            w.close()

        hdr = _W()
        hdr("/* Generated by NNCG (PyTorch port; repro of Urbann et al., 2020) — "
            "int8 PTQ build.")
        hdr(f" * net: in {g.input_shape} -> out {smap[sink.name]}, "
            f"{g.param_count()} params, simd={opts.simd},")
        hdr(f" * calibration={getattr(self.qg, 'method', 'minmax')} "
            f"(per-branch activation qparams on multi-input edges),")
        hdr(f" * int8 arena {plan.total_bytes} B "
            f"(float32 intermediates would be ~4x)"
            f"{f', pipeline stages={S}' if S > 1 else ''} */")
        hdr("#include <math.h>")
        if q is not None:
            hdr(f"#include <{q.header}>")
        if q is not None or S > 1:
            hdr("#include <string.h>")  # memcpy: strict-aliasing-safe
                                        # unaligned loads + stage
                                        # pass-through forwarding
        hdr("#if defined(__STDC_VERSION__) && __STDC_VERSION__ >= 199901L")
        hdr("#define NNCG_RESTRICT restrict")
        hdr("#else")
        hdr("#define NNCG_RESTRICT")
        hdr("extern float expf(float);")
        hdr("#endif")
        hdr("")
        return self._finish_program(hdr, plan, "int8")

