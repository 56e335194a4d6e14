"""Typed loop-nest IR between the graph schedule and the C renderer (the
port's copy of the JAX package's ``core/lowering.py``).

``cgen`` used to go straight from a :class:`~repro_torch.core.graph.CNNGraph`
to one flat C string.  This module splits that pipeline into an explicit
intermediate form::

    graph  --schedule-->  emission units  --lowering-->  Program  --render-->  C

A :class:`Program` is the complete lowered translation unit: the header
and declaration line blocks, the ordered body lines, and — the typed
part — one :class:`LoopNest` per emitted layer recording its loop
structure, the :class:`KernelCall` that filled its body span, the
planned :class:`Buffer` set and the **epilogue chain** applied at the
store site.  Epilogue fusion (residual Adds, pooling, Concat) is
literally chain concatenation: the consumer's epilogue ops are appended
to the producer's chain instead of becoming their own nest.

:func:`render` is the single place a ``Program`` becomes C source; it
reproduces the historic ``hdr + decls + "\\n" + body`` byte layout, so
``CGenerator.generate()`` == ``render(CGenerator.lower())`` exactly.

The three ``*Fuse`` dataclasses are the *live* fusion contexts the
emitters consult while a producer's loops are generated; they also know
how a producer-space output position maps into the fused consumer's
buffer (:meth:`PoolFuse.dst_index`, :meth:`ConcatFuse.dst_index`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

Pos = Tuple[Union[int, str], Union[int, str], Union[int, str]]


# ---------------------------------------------------------------------------
# IR node types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Buffer:
    """One planned arena allocation (a tensor value or scratch)."""

    name: str           # value name (layer name, 'xq', '<layer>__pad', ...)
    cname: str          # the C identifier the emitters use
    offset: int         # element offset into the workspace
    size: int           # elements (floats for fp32, bytes for int8)
    elem: str           # C element type ('float' | 'signed char' | 'int')
    start: int          # first live layer step
    end: int            # last live layer step


@dataclass(frozen=True)
class Loop:
    """One counted loop of a nest. ``unrolled`` marks loops the paper's
    P1 specialization turned into straight-line code (no C loop is
    emitted for them)."""

    var: str
    bound: int
    step: int = 1
    unrolled: bool = False


@dataclass(frozen=True)
class KernelCall:
    """The innermost computation of a nest: which kernel family filled
    the body span and with which variant (unroll level, ISA, tiling)."""

    kind: str           # 'conv' | 'dense' | 'maxpool' | 'qconv' | ...
    layer: str
    variant: str        # human-readable variant tag
    span: Tuple[int, int] = (0, 0)  # [start, end) line range in Program.body


@dataclass(frozen=True)
class Epilogue:
    """One store-site epilogue op.  Chains are ordered: the producer's
    own ops first, then any fused consumer's ops."""

    kind: str           # 'act' | 'softmax' | 'requant' | 'add_fuse' |
                        # 'maxpool_fuse' | 'avgpool_fuse' | 'concat_fuse'
    layer: str          # the layer the op belongs to
    detail: str = ""


@dataclass(frozen=True)
class LoopNest:
    """One emitted layer: its loops, kernel and epilogue chain."""

    layer: str
    op: str             # graph layer class name
    out_shape: Tuple[int, ...]
    loops: Tuple[Loop, ...]
    kernel: KernelCall
    epilogue: Tuple[Epilogue, ...] = ()
    stage: int = 0      # pipeline stage hosting this nest


@dataclass
class Program:
    """A lowered translation unit, ready for :func:`render`."""

    func_name: str
    precision: str                      # 'fp32' | 'int8'
    header: List[str] = field(default_factory=list)
    decls: List[str] = field(default_factory=list)
    body: List[str] = field(default_factory=list)
    nests: List[LoopNest] = field(default_factory=list)
    buffers: List[Buffer] = field(default_factory=list)
    arena_elems: int = 0
    elem_bytes: int = 4


def render(program: Program) -> str:
    """The one place a :class:`Program` becomes C source.

    Layout is the historic ``header + decls + blank line + body`` byte
    order, so lowering through the IR is byte-identical to the previous
    direct emission."""
    return ("\n".join(program.header) + "\n"
            + "\n".join(program.decls) + "\n"
            + "\n"
            + "\n".join(program.body) + "\n")


def format_program(program: Program, *, bodies: bool = False) -> str:
    """Pretty-print a :class:`Program` (one line a nest):
    every nest with its loops, kernel variant and epilogue chain, then
    the planned buffers with offsets and live ranges."""
    out: List[str] = []
    out.append(f"Program {program.func_name} [{program.precision}] "
               f"arena={program.arena_elems} elems "
               f"x {program.elem_bytes} B")
    for nest in program.nests:
        loops = " ".join(
            f"{'~' if lp.unrolled else ''}{lp.var}<{lp.bound}"
            + (f":{lp.step}" if lp.step != 1 else "")
            for lp in nest.loops) or "(straight-line)"
        out.append(f"  nest {nest.layer} [{nest.op}] "
                   f"out={nest.out_shape} stage={nest.stage}")
        out.append(f"    loops   {loops}")
        s0, s1 = nest.kernel.span
        out.append(f"    kernel  {nest.kernel.kind} <{nest.kernel.variant}> "
                   f"lines [{s0}, {s1})")
        for ep in nest.epilogue:
            det = f" {ep.detail}" if ep.detail else ""
            out.append(f"    epilog  {ep.kind} @{ep.layer}{det}")
        if bodies:
            for ln in program.body[s0:s1]:
                out.append("      | " + ln)
    for b in program.buffers:
        out.append(f"  buffer {b.name}: {b.elem} x{b.size} @ +{b.offset} "
                   f"live [{b.start}, {b.end}]")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# live fusion contexts (consulted by the emitters at the store site)
# ---------------------------------------------------------------------------


def _as_index(i, j, k, *, div: Tuple[int, int], pitch: int, c: int,
              off: int = 0) -> str:
    """Build ``((i/di) * pitch + j/dj) * c + off + k`` as a C index
    expression, statically folded when every component is an int."""
    di, dj = div
    if isinstance(i, int) and isinstance(j, int):
        base = ((i // di) * pitch + j // dj) * c + off
        return str(base + k) if isinstance(k, int) else f"{base} + {k}"
    ie = f"({i})" if di == 1 else f"({i}) / {di}"
    je = f"({j})" if dj == 1 else f"({j}) / {dj}"
    pre = f"({ie} * {pitch} + {je}) * {c}"
    if isinstance(k, int):
        return f"{pre} + {off + k}"
    return f"{pre} + {k}" if off == 0 else f"{pre} + {off} + {k}"


@dataclass
class AddFuse:
    """Active residual-Add fusion while a producer's loops are emitted:
    the Add folded into the store site, the producer's position in the
    Add's (order-significant) input list, and the resolved source
    expressions of every Add operand."""

    add: object         # the Add layer
    pos: int
    srcs: List[str]


@dataclass
class PoolFuse:
    """Active pooling fusion: the producer's store site feeds the
    MaxPool/AvgPool window reduction directly (stride == window, no
    padding, so every producer element lands in exactly one window)."""

    pool: object        # the MaxPool/AvgPool layer
    kind: str           # 'max' | 'avg'
    pw: int             # pooled output width
    c: int              # channels
    sh: int             # window/stride height
    sw: int             # window/stride width
    dst: str = ""       # the pool output buffer (init/finalize target)
    n: int = 0          # pooled output element count
    inv: str = ""       # float path: 1/(kh*kw) literal for the finalize
    acc: str = ""       # int8 avg: the int32 window-sum scratch cname

    def dst_index(self, pos: Pos) -> str:
        i, j, k = pos
        return _as_index(i, j, k, div=(self.sh, self.sw),
                         pitch=self.pw, c=self.c)


@dataclass
class ConcatFuse:
    """Active Concat fusion: the producer writes its channel slice of
    the Concat output directly (its own tensor never exists)."""

    concat: object      # the Concat layer
    pos: int            # edge index in the Concat input list
    c_off: int          # channel offset of this producer's slice
    c_total: int        # Concat output channels
    ow: int             # producer (== Concat) output width

    def dst_index(self, pos: Pos) -> str:
        i, j, k = pos
        return _as_index(i, j, k, div=(1, 1), pitch=self.ow,
                         c=self.c_total, off=self.c_off)


FuseNode = Union[AddFuse, PoolFuse, ConcatFuse]
