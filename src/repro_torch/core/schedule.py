"""Graph-level schedule: epilogue fusion + pipeline stage assignment (the
port's copy of the JAX package's ``core/schedule.py``).

The paper specializes code *within* one layer loop; this module decides
how layers are scheduled *across* the graph, one level above the
emitters in ``cgen.py``:

* **Epilogue fusion** — a consumer op can be folded into the store site
  of a weighted producer (``Conv2D``/``DepthwiseConv2D``/``Dense``)
  that feeds nothing else, so the producer's output tensor never exists
  and its arena slot disappears.  Three consumer kinds fuse:

  - a residual ``Add`` (the producer is the topologically last input):
    the freshly computed value is summed with the already-computed
    other branches and the Add's activation applied at the store;
  - a ``MaxPool``/``AvgPool`` with window == stride and no padding:
    each producer element lands in exactly one window, so the store
    reduces straight into the pooled output (max via the same ternary
    chain, avg via the same in-order sum plus a finalize divisor pass);
  - a ``Concat`` edge: the producer writes its channel slice of the
    Concat output directly.

  Float fusion is *bitwise identical* to the unfused graph (same float
  op order as the float reference); int8 fusion is bit-exact (the producer's
  accumulator is requantized to its own int8 code first, exactly as the
  unfused kernel would store it, then fed to the consumer's reference
  arithmetic — no double-rounding shortcut).
* **Stage partition** — the topologically ordered emission units are
  split into contiguous stages balanced by static per-layer cost
  estimates (the same MAC counts the autotuner's variant enumeration
  reasons about).  ``cgen`` emits one C function per stage plus a
  ``<func>_pipeline`` driver; ``runtime.PipelineRunner`` overlaps stages
  of consecutive frames across threads for batch-1 stream throughput.

A :class:`Schedule` is a frozen value object so it can key caches
(tuning records, compiled ``.so`` files) the same way
``SessionConfig``/``CodegenOptions`` do.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

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
    MaxPool,
)

# Add activations the fused epilogue can apply (softmax needs the whole
# channel vector after the sum — never fused into a producer store).
_FUSABLE_ADD_ACTS = (None, "relu", "leaky_relu")

# layers that emit no code of their own (cgen aliases their value to the
# producer's buffer) — they are not pipeline units
_ALIAS_LAYERS = (Dropout, Flatten)


@dataclass(frozen=True)
class Schedule:
    """Fusion decisions + pipeline stage assignment for one graph.

    ``fused_adds`` / ``fused_pools`` / ``fused_concats`` hold
    ``(producer_name, consumer_name)`` pairs: the consumer's arithmetic
    runs inside the producer's output loop and the producer's tensor is
    never materialized.  A fused Add or pool disappears as a layer of
    its own (it is *absorbed* into the producer's emission unit); a
    fused Concat still emits — it copies its remaining unfused edges —
    but the fused producers write their channel slices directly.
    ``stages`` lists the emission units (layer names, topological order,
    absorbed consumers folded into their producer's unit) per pipeline
    stage; a single-stage schedule is the ordinary monolithic function.
    """

    fused_adds: Tuple[Tuple[str, str], ...] = ()
    stages: Tuple[Tuple[str, ...], ...] = field(default=((),))
    fused_pools: Tuple[Tuple[str, str], ...] = ()
    fused_concats: Tuple[Tuple[str, str], ...] = ()

    @property
    def nstages(self) -> int:
        return len(self.stages)

    @property
    def fused_by_producer(self) -> Dict[str, str]:
        """producer name -> the consumer fused into its output loop."""
        out = {p: a for p, a in self.fused_adds}
        out.update({p: pl for p, pl in self.fused_pools})
        out.update({p: c for p, c in self.fused_concats})
        return out

    @property
    def fused_by_add(self) -> Dict[str, str]:
        """fused Add name -> its producer."""
        return {a: p for p, a in self.fused_adds}

    @property
    def fused_by_consumer(self) -> Dict[str, str]:
        """absorbed consumer name -> its producer (Adds and pools only;
        a fused Concat still emits its own unit)."""
        out = {a: p for p, a in self.fused_adds}
        out.update({pl: p for p, pl in self.fused_pools})
        return out

    @property
    def absorbed_consumers(self) -> frozenset:
        """Consumers that emit no unit of their own: fused Adds and
        fused pools.  Fused Concats are *not* absorbed — the Concat
        unit survives to copy any unfused edges."""
        return frozenset(a for _, a in self.fused_adds) | frozenset(
            pl for _, pl in self.fused_pools)

    @property
    def has_fusion(self) -> bool:
        return bool(self.fused_adds or self.fused_pools
                    or self.fused_concats)

    def digest(self) -> str:
        """Short stable hash for cache keys (tuning records, .so names)."""
        blob = repr((self.fused_adds, self.fused_pools,
                     self.fused_concats, self.stages)).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def describe(self) -> Dict[str, object]:
        return {
            "fused_adds": [list(p) for p in self.fused_adds],
            "fused_pools": [list(p) for p in self.fused_pools],
            "fused_concats": [list(p) for p in self.fused_concats],
            "nstages": self.nstages,
            "stages": [list(s) for s in self.stages],
            "digest": self.digest(),
        }


def fusable_adds(graph: CNNGraph) -> List[Tuple[str, str]]:
    """All ``(producer, add)`` pairs where the Add can run inside the
    producer's output loop without changing numerics.

    Conditions: the producer is a Conv2D/DepthwiseConv2D/Dense feeding
    *only* this Add (exactly one edge — a doubled ``[p, p]`` input is
    two edges and disqualifies); it is the topologically last of the
    Add's inputs, so every other operand is already in memory when the
    producer's loop runs; its own activation is not softmax (relu /
    leaky_relu are applied to the producer term before the sum, exactly
    as the unfused graph would); the Add's activation is relu-family or
    absent; and the Add is not the graph sink (the quantized sink path
    dequantizes into the float ``out`` buffer — sink Adds take the
    ordinary unfused path so both precisions share one predicate).
    """
    order = {l.name: i for i, l in enumerate(graph.layers)}
    cons = graph.consumers()
    sink = graph.sink.name
    pairs: List[Tuple[str, str]] = []
    for add in graph.layers:
        if not isinstance(add, Add):
            continue
        if add.name == sink:
            continue
        if add.activation not in _FUSABLE_ADD_ACTS:
            continue
        last = max(add.inputs, key=lambda n: order[n])
        p = graph.layer(last)
        if not isinstance(p, (Conv2D, DepthwiseConv2D, Dense)):
            continue
        if p.activation == "softmax":
            continue
        if cons[p.name] != [add]:  # sole consumer, exactly one edge
            continue
        pairs.append((p.name, add.name))
    return pairs


def fusable_pools(graph: CNNGraph) -> List[Tuple[str, str]]:
    """All ``(producer, pool)`` pairs where the MaxPool/AvgPool window
    reduction can run at the producer's store site.

    The mapping from a producer output position to a pool output slot is
    only a pure index transform when window == stride, the pool has no
    padding, and the producer's spatial extent divides evenly by the
    stride (otherwise trailing rows/cols are dropped by the pool and a
    fused store would write out of bounds).  Under those conditions
    every producer element lands in exactly one window, the windows all
    have the full ``kh*kw`` population (so the int8 AvgPool rescale is
    uniform), and the fused reduction applies ops in the same order the
    unfused kernels would — bitwise identical in float, bit-exact in
    int8.  The producer must be a Conv2D/DepthwiseConv2D/Dense feeding
    *only* this pool via a direct edge, non-softmax; the pool must not
    be the graph sink (same sink rule as Add fusion).
    """
    cons = graph.consumers()
    smap = graph.shape_map()
    sink = graph.sink.name
    pairs: List[Tuple[str, str]] = []
    for pool in graph.layers:
        if not isinstance(pool, (MaxPool, AvgPool)):
            continue
        if pool.name == sink:
            continue
        if tuple(pool.size) != tuple(pool.strides):
            continue
        ish = smap[pool.inputs[0]]
        if any(pool.pad_amounts(ish)):
            continue
        h, w, _ = ish
        sh, sw = pool.strides
        if h % sh or w % sw:
            continue
        p = graph.layer(pool.inputs[0])
        if not isinstance(p, (Conv2D, DepthwiseConv2D, Dense)):
            continue
        if p.activation == "softmax":
            continue
        if cons[p.name] != [pool]:  # sole consumer, exactly one edge
            continue
        pairs.append((p.name, pool.name))
    return pairs


def fusable_concats(graph: CNNGraph) -> List[Tuple[str, str]]:
    """All ``(producer, concat)`` pairs where the producer can write its
    channel slice of the Concat output directly.

    Concat fusion is per *edge*: each qualifying producer fuses
    independently and the Concat unit survives to copy whichever edges
    stayed unfused (it disappears entirely only when every edge fused).
    A producer qualifies when it is a Conv2D/DepthwiseConv2D/Dense,
    non-softmax, feeding only this Concat via a direct edge.  A Concat
    with a doubled input (``[p, p]``) is skipped outright: the edge
    position — and hence the channel offset — of ``p`` would be
    ambiguous.  The Concat must not be the graph sink (the quantized
    sink path dequantizes into the float ``out`` buffer).
    """
    cons = graph.consumers()
    sink = graph.sink.name
    pairs: List[Tuple[str, str]] = []
    for cat in graph.layers:
        if not isinstance(cat, Concat):
            continue
        if cat.name == sink:
            continue
        if len(set(cat.inputs)) != len(cat.inputs):
            continue
        for n in cat.inputs:
            p = graph.layer(n)
            if not isinstance(p, (Conv2D, DepthwiseConv2D, Dense)):
                continue
            if p.activation == "softmax":
                continue
            if cons[p.name] != [cat]:  # sole consumer, exactly one edge
                continue
            pairs.append((p.name, cat.name))
    return pairs


def layer_costs(graph: CNNGraph) -> Dict[str, int]:
    """Static per-layer cost estimate (MACs, or element count for
    memory-bound layers) used to balance pipeline stages."""
    smap = graph.shape_map()
    costs: Dict[str, int] = {}
    for l in graph.layers:
        oh, ow, oc = smap[l.name]
        if isinstance(l, Input) or isinstance(l, _ALIAS_LAYERS):
            costs[l.name] = 0
        elif isinstance(l, Conv2D):
            costs[l.name] = oh * ow * oc * l.kh * l.kw * l.c_in
        elif isinstance(l, DepthwiseConv2D):
            costs[l.name] = oh * ow * oc * l.kh * l.kw
        elif isinstance(l, Dense):
            costs[l.name] = int(l.weights.shape[0]) * int(l.weights.shape[1])
        elif isinstance(l, (MaxPool, AvgPool)):
            costs[l.name] = oh * ow * oc * l.size[0] * l.size[1]
        elif isinstance(l, GlobalAvgPool):
            h, w, c = smap[l.inputs[0]]
            costs[l.name] = h * w * c
        elif isinstance(l, (Add, Concat, BatchNorm)):
            costs[l.name] = oh * ow * oc * max(len(l.inputs), 1)
        else:  # activations, softmax, anything elementwise
            costs[l.name] = oh * ow * oc
    return costs


def emission_units(graph: CNNGraph,
                   fused: Tuple[Tuple[str, str], ...],
                   fused_pools: Tuple[Tuple[str, str], ...] = ()) -> List[str]:
    """Topologically ordered unit names: every code-emitting layer,
    with absorbed consumers (fused Adds and pools) folded into their
    producer's unit.  Fused Concats keep their unit — they still copy
    any unfused edges."""
    absorbed = {a for _, a in fused} | {pl for _, pl in fused_pools}
    return [l.name for l in graph.layers
            if not isinstance(l, Input)
            and not isinstance(l, _ALIAS_LAYERS)
            and l.name not in absorbed]


def _partition(costs: List[int], nstages: int) -> List[int]:
    """Contiguous linear partition of ``costs`` into ``nstages`` chunks
    minimizing the maximum chunk sum (classic O(n^2 * S) DP).  Returns
    the chunk *lengths*; every chunk is non-empty."""
    n = len(costs)
    prefix = [0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    dp = [[inf] * (n + 1) for _ in range(nstages + 1)]
    cut = [[0] * (n + 1) for _ in range(nstages + 1)]
    dp[0][0] = 0.0
    for s in range(1, nstages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                cand = max(dp[s - 1][j], prefix[i] - prefix[j])
                if cand < dp[s][i]:
                    dp[s][i] = cand
                    cut[s][i] = j
    lengths: List[int] = []
    i = n
    for s in range(nstages, 0, -1):
        j = cut[s][i]
        lengths.append(i - j)
        i = j
    lengths.reverse()
    return lengths


_FuseSet = Tuple[Tuple[Tuple[str, str], ...],
                 Tuple[Tuple[str, str], ...],
                 Tuple[Tuple[str, str], ...]]


def _prune_arena_regressions(
        graph: CNNGraph,
        fused: Tuple[Tuple[str, str], ...],
        fused_pools: Tuple[Tuple[str, str], ...] = (),
        fused_concats: Tuple[Tuple[str, str], ...] = ()) -> _FuseSet:
    """Drop fused pairs (of any kind) until the packed arena is no
    larger than the unfused plan's.

    Fusing a consumer eliminates its producer's buffer and can only
    shrink the *peak live* set, but the arena packer is first-fit over
    interval interference and first-fit is not monotone: removing a
    buffer moves later buffers to different offsets, which on branchy
    graphs can fragment the packing and *grow* the total.  The int8
    fused AvgPool additionally introduces an aligned ``int32`` window
    scratch interval that can outweigh the eliminated producer buffer.
    Rather than weaken the "fusion never costs memory" contract, fusion
    decisions are made memory-aware here: greedily drop the pair whose
    removal shrinks the plan most until fused <= unfused (the empty set
    gives exact equality, so this always terminates).  The plan depends
    on the emission style — rolled loops add padding-scratch intervals
    that full unroll handles inline — and on the element width, so the
    invariant is enforced across both uniform unroll styles in float
    and int8 (per-layer mixed-unroll builds sit between the two
    extremes and are not individually checked).
    """
    if not (fused or fused_pools or fused_concats):
        return fused, fused_pools, fused_concats
    from . import cgen  # runtime import: cgen imports this module

    plans = [(cgen.CodegenOptions(unroll=u), q)
             for u in (0, None) for q in (False, True)]
    tagged = ([("add", pr) for pr in fused]
              + [("pool", pr) for pr in fused_pools]
              + [("cat", pr) for pr in fused_concats])

    def split(items) -> _FuseSet:
        return (tuple(pr for k, pr in items if k == "add"),
                tuple(pr for k, pr in items if k == "pool"),
                tuple(pr for k, pr in items if k == "cat"))

    def totals(items) -> Tuple[int, ...]:
        fa, fp, fc = split(items)
        sched = Schedule(fused_adds=fa, fused_pools=fp, fused_concats=fc,
                         stages=(tuple(emission_units(graph, fa, fp)),))
        return tuple(
            cgen.plan_arena(graph, opts, quantized=q,
                            schedule=sched).total_floats
            for opts, q in plans)

    base = totals(())
    keep = list(tagged)

    def excess(items) -> int:
        return sum(max(0, t - b) for t, b in zip(totals(items), base))

    while keep and excess(keep) > 0:
        best = min(range(len(keep)),
                   key=lambda i: excess(keep[:i] + keep[i + 1:]))
        keep.pop(best)
    return split(keep)


FUSION_KINDS = ("add", "pool", "concat")


def make_schedule(graph: CNNGraph, *, nstages: int = 1,
                  fusion: bool = True,
                  kinds: Sequence[str] = FUSION_KINDS) -> Schedule:
    """Build a :class:`Schedule` for ``graph``.

    ``fusion=True`` fuses every eligible Add/pool/Concat epilogue whose
    fusion does not grow the packed arena (output is bitwise identical
    either way; see :func:`_prune_arena_regressions` for why packing
    can regress).  ``kinds`` restricts which consumer kinds are
    considered — the int8 autotuner times kind subsets as code
    variants (see ``engine.autotune.fusion_schedule_candidates``).
    ``nstages`` > 1 partitions the units into that many
    balanced pipeline stages (clamped to the unit count); pipelined
    builds drop Concat fusion up front — stage-interface forwarding
    assumes every value is defined by a single stage, and a Concat
    assembled piecemeal by producers in different stages would violate
    that (Add/pool fusions are immune: producer and absorbed consumer
    always share a unit, hence a stage).
    """
    unknown = set(kinds) - set(FUSION_KINDS)
    if unknown:
        raise ValueError(f"unknown fusion kinds: {sorted(unknown)}")
    if fusion:
        cand_adds = (tuple(fusable_adds(graph))
                     if "add" in kinds else ())
        cand_pools = (tuple(fusable_pools(graph))
                      if "pool" in kinds else ())
        cand_cats = (tuple(fusable_concats(graph))
                     if "concat" in kinds and int(nstages) <= 1 else ())
        fused, fused_pools, fused_concats = _prune_arena_regressions(
            graph, cand_adds, cand_pools, cand_cats)
    else:
        fused = fused_pools = fused_concats = ()
    units = emission_units(graph, fused, fused_pools)
    if not units:
        return Schedule(fused_adds=fused, stages=((),),
                        fused_pools=fused_pools,
                        fused_concats=fused_concats)
    costs = layer_costs(graph)
    fused_by_p = {p: a for p, a in fused}
    fused_by_p.update({p: pl for p, pl in fused_pools})
    unit_costs = [costs[u] + costs.get(fused_by_p.get(u, ""), 0)
                  for u in units]
    s = max(1, min(int(nstages), len(units)))
    if s == 1:
        return Schedule(fused_adds=fused, stages=(tuple(units),),
                        fused_pools=fused_pools,
                        fused_concats=fused_concats)
    lengths = _partition(unit_costs, s)
    stages: List[Tuple[str, ...]] = []
    i = 0
    for ln in lengths:
        stages.append(tuple(units[i:i + ln]))
        i += ln
    return Schedule(fused_adds=fused, stages=tuple(stages),
                    fused_pools=fused_pools,
                    fused_concats=fused_concats)
