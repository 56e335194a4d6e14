"""Graph rewrite passes (the NNCG optimization pipeline), PyTorch port.

The port's own copy of the JAX package's ``core/passes.py``; the passes
are pure numpy and rewrite a :class:`repro_torch.core.graph.CNNGraph`
exactly as the reference rewrites its own graph.

These are the paper's compile-time rewrites, applied before code
generation.  All of them walk the DAG **edges** (``layer.inputs`` /
consumer maps), never list adjacency, so branching graphs (residual
Adds, Concats) are rewritten correctly:

* ``fold_batchnorm``  — paper §II-B.4: bn(conv(x)) = Σ x·(w/σ) − μ/σ,
  generalized to learnable γ/β.
* ``remove_dropout``  — dropout is identity at inference.
* ``fuse_activations`` — standalone ReLU/LeakyReLU/Softmax layers are
  folded into the sole producing Conv2D/DepthwiseConv2D/Dense/Add so one
  loop nest computes both (enables the P2 ternary emission in the same
  code line).
* ``reorder_for_fusion`` — emission-order canonicalization: a
  sole-consumer Conv/DW/Dense feeding a residual Add is moved to just
  before the Add so the C schedule's ``fusable_adds`` can fold the Add into its
  output loop (pure permutation — numerics unchanged).  Pool/Concat
  fusion needs no such help: those consumers read only their producer,
  so eligibility is position-independent.
* ``align_channels`` — paper P4: pad conv output channels to a SIMD
  multiple (4 for SSSE3, 128 for TPU lanes) with zero filters; downstream
  layers are widened consistently so numerics are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .graph import (
    Add,
    AvgPool,
    BatchNorm,
    CNNGraph,
    Conv2D,
    Dense,
    DepthwiseConv2D,
    Dropout,
    Layer,
    LeakyReLU,
    MaxPool,
    ReLU,
    Softmax,
)


def _copy_layers(graph: CNNGraph) -> List[Layer]:
    return [dataclasses.replace(l, inputs=list(l.inputs))
            for l in graph.layers]


def _consumer_map(layers: List[Layer]) -> Dict[str, List[Layer]]:
    out: Dict[str, List[Layer]] = {l.name: [] for l in layers}
    for l in layers:
        for src in l.inputs:
            out[src].append(l)
    return out


def _splice_out(layers: List[Layer], victim: Layer) -> List[Layer]:
    """Remove a single-input layer; its consumers read its producer."""
    (src,) = victim.inputs
    kept = []
    for l in layers:
        if l is victim:
            continue
        l.inputs = [src if n == victim.name else n for n in l.inputs]
        kept.append(l)
    return kept


def remove_dropout(graph: CNNGraph) -> CNNGraph:
    layers = _copy_layers(graph)
    for victim in [l for l in layers if isinstance(l, Dropout)]:
        layers = _splice_out(layers, victim)
    return graph.replace(layers)


def fold_batchnorm(graph: CNNGraph) -> CNNGraph:
    """Fold each BatchNorm into its producing Conv2D.

    The fold is applied when the BN's sole producer is a Conv2D with no
    fused activation **and** that conv feeds nothing but the BN — if the
    conv output also rode a skip edge, folding would silently rescale the
    other branch.  A BN with no foldable conv is kept (the executors
    handle it directly).
    """
    layers = _copy_layers(graph)
    for bn in [l for l in layers if isinstance(l, BatchNorm)]:
        (src,) = bn.inputs
        conv = next(l for l in layers if l.name == src)
        cons = _consumer_map(layers)
        if not (isinstance(conv, Conv2D) and conv.activation is None
                and cons[conv.name] == [bn]):
            continue
        scale, shift = bn.scale_shift()
        conv.weights = (conv.weights * scale[None, None, None, :]).astype(np.float32)
        conv.bias = (conv.bias * scale + shift).astype(np.float32)
        layers = _splice_out(layers, bn)
    return graph.replace(layers)


def fuse_activations(graph: CNNGraph) -> CNNGraph:
    """Fold standalone activations into their sole producer.

    Requires the producer to feed *only* the activation layer: on a
    branching graph, fusing a ReLU into a conv whose raw output also
    feeds a skip connection would change the skip branch."""
    layers = _copy_layers(graph)
    for act in [l for l in layers
                if isinstance(l, (ReLU, LeakyReLU, Softmax))]:
        (src,) = act.inputs
        prev = next(l for l in layers if l.name == src)
        cons = _consumer_map(layers)
        fusible = (isinstance(prev, (Conv2D, DepthwiseConv2D, Dense, Add))
                   and prev.activation is None
                   and cons[prev.name] == [act])
        if isinstance(prev, Add) and isinstance(act, Softmax):
            fusible = False  # Add carries relu-family fusions only
        if not fusible:
            continue
        if isinstance(act, ReLU):
            prev.activation = "relu"
        elif isinstance(act, LeakyReLU):
            prev.activation = "leaky_relu"
            prev.alpha = act.alpha
        else:
            prev.activation = "softmax"
        layers = _splice_out(layers, act)
    return graph.replace(layers)


# Add activations the fused epilogue supports (must match
# the C code generator's schedule predicate — softmax needs the whole channel
# vector after the sum)
_FUSABLE_EPILOGUE_ACTS = (None, "relu", "leaky_relu")


def reorder_for_fusion(graph: CNNGraph) -> CNNGraph:
    """Emission-order canonicalization for epilogue fusion.

    the C schedule's ``fusable_adds`` folds an Add into a producer only when
    that producer is the *topologically last* of the Add's inputs
    (every other operand must already be in memory when the producer's
    loop runs).  When an Add's last input isn't fusable but another
    input is a sole-consumer Conv2D/DepthwiseConv2D/Dense, moving that
    producer's emission to just before the Add makes it last — a pure
    reorder: edges, weights and numerics are untouched (the float
    left-associated sum follows the Add's *input list* order, not
    emission order), only the layer list is permuted.  Moving is safe
    because the producer's sole consumer is the Add itself, so nothing
    between its old and new position reads it.

    The other fused consumer kinds need no reordering: a fusable
    MaxPool/AvgPool or Concat edge reads *only* its producer, so the
    producer's emission position is irrelevant — ``fusable_pools`` /
    ``fusable_concats`` qualify on sole-consumership alone and this
    pass never has to move anything for them."""
    layers = _copy_layers(graph)
    sink = graph.sink.name
    for add in [l for l in layers if isinstance(l, Add)]:
        if add.name == sink or add.activation not in _FUSABLE_EPILOGUE_ACTS:
            continue
        order = {l.name: i for i, l in enumerate(layers)}
        cons = _consumer_map(layers)

        def fusable(l: Layer) -> bool:
            return (isinstance(l, (Conv2D, DepthwiseConv2D, Dense))
                    and l.activation != "softmax"
                    and cons[l.name] == [add])

        last = layers[order[max(add.inputs, key=lambda n: order[n])]]
        if fusable(last):
            continue  # already in fusable position
        cands = [layers[order[n]] for n in set(add.inputs)
                 if fusable(layers[order[n]])]
        if not cands:
            continue
        # the heaviest candidate: its materialized buffer is the most
        # expensive round-trip to eliminate (any choice is numerically
        # equivalent)
        mv = max(cands, key=lambda l: int(np.prod(np.shape(l.weights))))
        layers.remove(mv)
        layers.insert(layers.index(add), mv)
    return graph.replace(layers)


_CHANNEL_PRESERVING = (ReLU, LeakyReLU, MaxPool, AvgPool, BatchNorm, Dropout)


def _pad_chain(layers: List[Layer], cons: Dict[str, List[Layer]],
               conv: Conv2D):
    """Follow the single-consumer chain of channel-preserving layers from
    ``conv`` to the next Conv2D. Returns (chain, next_conv) or None when
    anything on the way (a branch, a merge, Dense/Softmax/output, a
    depthwise conv whose channel count is semantic) blocks padding."""
    chain: List[Layer] = []
    cur: Layer = conv
    while True:
        nxt_list = cons[cur.name]
        if len(nxt_list) != 1:
            return None
        nxt = nxt_list[0]
        if isinstance(nxt, Conv2D):
            return chain, nxt
        if isinstance(nxt, _CHANNEL_PRESERVING):
            chain.append(nxt)
            cur = nxt
            continue
        return None


def align_channels(graph: CNNGraph, multiple: int = 4) -> CNNGraph:
    """Pad a Conv2D's ``c_out`` to a multiple when the widening is provably
    invisible: zero filters produce zero channels; ReLU/LeakyReLU/pooling
    map zero to zero; the next conv's weights gain zero-weight input
    channels.  Softmax is *not* scale-free and Add/Concat change meaning
    with channel count, so any chain reaching one of those (or the graph
    output) is left alone."""
    layers = _copy_layers(graph)
    for conv in [l for l in layers if isinstance(l, Conv2D)]:
        pad = (-conv.c_out) % multiple
        if pad == 0:
            continue
        hit = _pad_chain(layers, _consumer_map(layers), conv)
        if hit is None:
            continue
        chain, nxt_conv = hit
        conv.weights = np.pad(conv.weights, ((0, 0),) * 3 + ((0, pad),)).astype(np.float32)
        conv.bias = np.pad(conv.bias, (0, pad)).astype(np.float32)
        for bn in chain:
            if isinstance(bn, BatchNorm):
                bn.mean = np.pad(bn.mean, (0, pad))
                bn.var = np.pad(bn.var, (0, pad), constant_values=1.0)
                bn.gamma = np.pad(bn.gamma, (0, pad))
                bn.beta = np.pad(bn.beta, (0, pad))
        nxt_conv.weights = np.pad(
            nxt_conv.weights, ((0, 0), (0, 0), (0, pad), (0, 0))
        ).astype(np.float32)
    return graph.replace(layers)


def optimize(graph: CNNGraph, simd_multiple: int = 4) -> CNNGraph:
    """The full NNCG pipeline in paper order."""
    g = remove_dropout(graph)
    g = fold_batchnorm(g)
    g = fuse_activations(g)
    g = reorder_for_fusion(g)
    if simd_multiple > 1:
        g = align_channels(g, simd_multiple)
    return g
