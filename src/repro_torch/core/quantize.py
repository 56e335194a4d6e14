"""Post-training int8 quantization: calibration and qparam annotation
(the port's copy of the JAX package's ``core/quantize.py``).

The numpy parts are copied unchanged: the qparam types and rules, the
streaming :class:`Observer` with its four range methods (``"minmax"``,
``"percentile"``, ``"mse"``, ``"entropy"``), :class:`QuantizedGraph` and
its derived constants, and the weight quantization.  Two functions run
the float executor and so are ported over
:mod:`repro_torch.core.torch_exec`:

* :func:`calibrate` streams the calibration batch through
  ``torch_exec._apply`` in chunks on the caller's device (the card
  unless the caller names another), with the same consumer-refcount
  eviction, per-branch Concat union and per-channel min/max; each
  observed tensor comes to the host once a chunk for
  :meth:`Observer.update`;
* :func:`quantization_error` holds ``torch_exec.forward_quantized``
  to ``torch_exec.forward``.

The quantized execution scheme (``torch_exec.forward_quantized``):

* int8 codes for every intermediate tensor, exact integer accumulation;
* requantization by a float32 multiplier ``M[k] = s_in*s_w[k]/s_out``
  applied as ``floor(acc * M + 0.5)`` (round-half-up), each a separate
  IEEE-754 single-precision op, so the result is the JAX reference's
  bit for bit on the integer path;
* fused ReLU / LeakyReLU applied to the float requant value;
* the sink layer dequantizes its int32 accumulator straight to float
  (softmax, when present, runs in float32).

Multi-input layers (Add, Concat) are **per-branch**: every input edge
keeps the qparams of its own producer and is requantized with its own
``rescale(layer, idx)``.  The Concat *output* range is the union of its
inputs' *calibrated* ranges.

**Per-channel requant zero points** (opt-in, ``per_channel=True``):
an eligible weighted layer's activation gets per-output-channel
``(scale[k], zero_point[k])``; every consumer folds the producer's
per-channel scales into its own weight quantization and the zero
points into its int32 effective bias (:func:`per_channel_eligible`).

Every scale is computed **here** and cast to float32 once, so every
executor closes over the same values.

:func:`from_reference_qgraph` carries a JAX-side quantized graph across
field by field, values unchanged, so both packages can run one qgraph.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from . import torch_exec
from .graph import (
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
    Softmax,
    from_reference_graph,
    pool_window_counts,
)
from .numerics import round_half_up
from .torch_exec import extract_params, resolve_device, use_fp32_convolutions

QMIN, QMAX = -128, 127

# layers whose int8 output reuses the producer's qparams unchanged:
# identity layers alias the buffer; MaxPool commutes with any monotone
# quantization, so sharing qparams makes it a pure int8 max (no requant)
_SHARE_INPUT_QPARAMS = (Dropout, Flatten, MaxPool)

# weighted layers that get per-output-channel symmetric weight scales
_WEIGHTED = (Conv2D, DepthwiseConv2D, Dense)


@dataclass(frozen=True)
class QParams:
    """Asymmetric per-tensor int8 affine quantization:
    ``real = scale * (q - zero_point)``."""

    scale: float  # stored as the exact float32 value
    zero_point: int

    @property
    def inv_scale(self) -> np.float32:
        """The float32 multiplier the input-quantization step uses —
        computed once here so C literal and jax constant agree."""
        return np.float32(1.0 / float(self.scale))

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """Reference quantizer: float -> int8 codes (round half up) —
        the same ``floor(x*inv + 0.5) + zp`` the C and jax paths use."""
        t = np.asarray(x, np.float32) * self.inv_scale
        q = round_half_up(t).astype(np.int64) + self.zero_point
        return np.clip(q, QMIN, QMAX).astype(np.int8)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        return ((np.asarray(q, np.int32) - self.zero_point)
                * np.float32(self.scale)).astype(np.float32)


@dataclass(frozen=True)
class ChannelQParams:
    """Per-channel asymmetric int8 affine quantization of one
    activation tensor: ``real[..., k] = scale[k] * (q[..., k] -
    zero_point[k])`` over the channel (last) axis."""

    scale: np.ndarray       # (C,) float32
    zero_point: np.ndarray  # (C,) int32

    @property
    def inv_scale(self) -> np.ndarray:
        """(C,) float32 multipliers — same construction rule as
        :meth:`QParams.inv_scale`, per channel."""
        return np.float32(1.0 / self.scale.astype(np.float64))

    def quantize(self, x: np.ndarray) -> np.ndarray:
        t = np.asarray(x, np.float32) * self.inv_scale
        q = round_half_up(t).astype(np.int64) \
            + self.zero_point.astype(np.int64)
        return np.clip(q, QMIN, QMAX).astype(np.int8)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        return ((np.asarray(q, np.int32) - self.zero_point)
                * self.scale).astype(np.float32)


def qparams_from_range(mn: float, mx: float) -> QParams:
    """Derive (scale, zero_point) from an observed float range.

    The range is widened to include zero so that 0.0 is exactly
    representable (``q == zero_point``) — required for exact ReLU
    clamps and for padding int8 feature maps with the zero code.
    The zero point rounds half **up** (``floor(x + 0.5)``), the same
    scheme every quantization step in the C build and the jax
    reference uses — not Python's banker's ``round``."""
    mn = min(float(mn), 0.0)
    mx = max(float(mx), 0.0)
    scale = (mx - mn) / float(QMAX - QMIN)
    if scale == 0.0:  # constant-zero tensor
        scale = 1.0
    scale = float(np.float32(scale))
    zp = int(np.clip(round_half_up(QMIN - mn / scale), QMIN, QMAX))
    return QParams(scale=scale, zero_point=zp)


def channel_qparams_from_range(mn: np.ndarray,
                               mx: np.ndarray) -> ChannelQParams:
    """Vectorized :func:`qparams_from_range` over the channel axis —
    the same zero-widening, float32 scale cast, and half-up zero-point
    rule, applied elementwise."""
    mn = np.minimum(np.asarray(mn, np.float64), 0.0)
    mx = np.maximum(np.asarray(mx, np.float64), 0.0)
    scale = (mx - mn) / float(QMAX - QMIN)
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    zp = np.clip(round_half_up(QMIN - mn / scale.astype(np.float64)),
                 QMIN, QMAX).astype(np.int32)
    return ChannelQParams(scale=scale, zero_point=zp)


def per_channel_eligible(graph: CNNGraph) -> list:
    """Layer names whose *activation* may quantize per channel.

    The scheme keeps integer inner loops unchanged by moving all
    per-channel bookkeeping to constants: the producer's requant
    epilogue indexes zero-point/multiplier tables it already has the
    loop structure for, and each consumer folds ``s_x[ci]`` into its
    weight quantization and ``zp_x[ci]`` into its effective bias.
    That fold only exists for weighted consumers, so eligibility is:
    weighted, not the sink (the sink dequantizes to float), activation
    not softmax, and every consumer a Conv2D/DepthwiseConv2D/Dense
    reading the producer directly with zero padding (a padded consumer
    fills with the producer's zero code — a scalar, which a per-channel
    zero point no longer is)."""
    smap = graph.shape_map()
    cons = graph.consumers()
    sink = graph.sink.name
    out = []
    for p in graph.layers:
        if not isinstance(p, _WEIGHTED) or p.name == sink:
            continue
        if p.activation == "softmax":
            continue
        cs = cons[p.name]
        if not cs:
            continue
        ok = True
        for c in cs:
            if not isinstance(c, _WEIGHTED) or c.inputs[0] != p.name:
                ok = False
                break
            if isinstance(c, (Conv2D, DepthwiseConv2D)) \
                    and any(c.pad_amounts(smap[p.name])):
                ok = False
                break
        if ok:
            out.append(p.name)
    return out


# ---------------------------------------------------------------------------
# calibration observers (streaming histograms + range selection)
# ---------------------------------------------------------------------------

CALIBRATION_METHODS = ("minmax", "percentile", "mse", "entropy")


class Observer:
    """Streaming per-tensor range observer.

    Accumulates an exact running min/max plus a fixed-bin histogram
    over chunked calibration batches — one chunk's activations at a
    time, so calibration memory is bounded by the chunk, not the whole
    calibration set.  When a later chunk falls outside the current
    histogram span, the span grows to the union and the existing
    counts are redistributed onto the new uniform grid by linear
    interpolation of the cumulative mass (the standard piecewise-
    uniform merge); the min/max themselves always stay exact, so the
    ``minmax`` method reproduces the historical single-pass behavior
    bit-for-bit.
    """

    def __init__(self, nbins: int = 2048):
        assert nbins >= 16, "need a usable histogram resolution"
        self.nbins = int(nbins)
        self.mn = np.inf
        self.mx = -np.inf
        self.counts: Optional[np.ndarray] = None
        self.edges: Optional[np.ndarray] = None

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32).ravel()
        if x.size == 0:
            return
        cmn, cmx = float(x.min()), float(x.max())
        self.mn = min(self.mn, cmn)
        self.mx = max(self.mx, cmx)
        if self.counts is None:
            counts, edges = np.histogram(
                x, bins=self.nbins, range=(cmn, cmx))
            self.counts = counts.astype(np.int64)
            self.edges = edges
            return
        lo, hi = float(self.edges[0]), float(self.edges[-1])
        if cmn < lo or cmx > hi:
            new_lo, new_hi = min(lo, cmn), max(hi, cmx)
            new_edges = np.linspace(new_lo, new_hi, self.nbins + 1)
            cum = np.concatenate([[0.0], np.cumsum(self.counts)])
            remapped = np.diff(np.interp(new_edges, self.edges, cum,
                                         left=0.0, right=cum[-1]))
            self.counts = remapped  # float mass from here on
            self.edges = new_edges
            lo, hi = new_lo, new_hi
        counts, _ = np.histogram(x, bins=self.nbins, range=(lo, hi))
        self.counts = self.counts + counts

    # -- range selection -----------------------------------------------------

    def range_minmax(self) -> Tuple[float, float]:
        assert np.isfinite(self.mn), "Observer.update never called"
        return float(self.mn), float(self.mx)

    def range_percentile(self, percentile: float) -> Tuple[float, float]:
        """Clip each tail to ``(100 - percentile)/2`` % of the observed
        mass (two-sided, asymmetric-friendly); the selected edges come
        from the histogram grid, min/max-clamped."""
        assert 50.0 < percentile <= 100.0, percentile
        assert self.counts is not None, "Observer.update never called"
        total = float(self.counts.sum())
        if total == 0.0:
            return self.range_minmax()
        tail = total * (100.0 - percentile) / 100.0 / 2.0
        cum = np.cumsum(self.counts)
        lo_bin = int(np.searchsorted(cum, tail, side="right"))
        hi_bin = int(np.searchsorted(cum, total - tail, side="left"))
        lo_bin = min(lo_bin, self.nbins - 1)
        hi_bin = max(min(hi_bin, self.nbins - 1), lo_bin)
        lo = max(float(self.edges[lo_bin]), self.mn)
        hi = min(float(self.edges[hi_bin + 1]), self.mx)
        return min(lo, hi), max(lo, hi)

    def range_mse(self, grid: int = 24) -> Tuple[float, float]:
        """Coordinate search over clipped ranges for the one minimizing
        the int8 quantization MSE of the histogram mass (bin centers
        weighted by counts, clipped values saturate — exactly what the
        int8 path does to them).  The full min/max range is always a
        candidate, so ``mse`` can never select something worse than
        ``minmax`` *on the calibration distribution itself*."""
        mn, mx = self.range_minmax()
        if mn == mx:
            return mn, mx
        centers = ((self.edges[:-1] + self.edges[1:]) * 0.5)
        weights = np.asarray(self.counts, np.float64)

        def err(lo: float, hi: float) -> float:
            lo2, hi2 = min(lo, 0.0), max(hi, 0.0)
            scale = (hi2 - lo2) / float(QMAX - QMIN)
            if scale <= 0.0:
                return np.inf
            zp = round_half_up(QMIN - lo2 / scale)
            q = np.clip(round_half_up(centers / scale) + zp, QMIN, QMAX)
            deq = (q - zp) * scale
            return float(((centers - deq) ** 2 * weights).sum())

        los = mn * np.linspace(1.0, 1.0 / grid, grid) if mn < 0 else [mn]
        his = mx * np.linspace(1.0, 1.0 / grid, grid) if mx > 0 else [mx]
        best = (err(mn, mx), mn, mx)
        lo = mn
        for _ in range(2):  # alternate the two ends (coordinate descent)
            for h in his:
                e = err(lo, float(h))
                if e < best[0]:
                    best = (e, lo, float(h))
            hi = best[2]
            for l_ in los:
                e = err(float(l_), hi)
                if e < best[0]:
                    best = (e, float(l_), hi)
            lo = best[1]
        return best[1], best[2]

    def range_entropy(self, grid: int = 24) -> Tuple[float, float]:
        """Coordinate search over clipped ranges for the one minimizing
        the KL divergence ``KL(P || Q)`` between the observed histogram
        mass ``P`` and its int8 reconstruction ``Q`` (``P`` collapsed
        onto the 256 codes, then spread back uniformly over each code's
        bins) — the information-loss criterion.  Saturating a bin that
        holds observed mass relocates its reconstruction out of the bin
        entirely (``Q = 0`` where ``P > 0``), so such candidates score
        ``KL = inf``: entropy only ever trims *empty* outlier gaps of
        the histogram, trading them for a finer in-range step.  Same
        ``los``/``his`` candidate grid and alternating two-end descent
        as :meth:`range_mse`, and the full min/max range is always a
        candidate — on the calibration distribution itself the choice
        can never represent less mass than ``minmax`` does."""
        mn, mx = self.range_minmax()
        if mn == mx:
            return mn, mx
        centers = ((self.edges[:-1] + self.edges[1:]) * 0.5)
        weights = np.asarray(self.counts, np.float64)
        total = float(weights.sum())
        if total == 0.0:
            return mn, mx
        P = weights / total

        def err(lo: float, hi: float) -> float:
            lo2, hi2 = min(lo, 0.0), max(hi, 0.0)
            scale = (hi2 - lo2) / float(QMAX - QMIN)
            if scale <= 0.0:
                return np.inf
            zp = round_half_up(QMIN - lo2 / scale)
            q = round_half_up(centers / scale) + zp
            keep = (q >= QMIN) & (q <= QMAX)
            if float(P[~keep].sum()) > 0.0:
                return np.inf  # saturates observed mass: not entropy's trade
            codes = q[keep].astype(np.int64) - QMIN
            code_mass = np.bincount(codes, weights=P[keep], minlength=256)
            code_bins = np.bincount(codes, minlength=256)
            Q = code_mass[codes] / code_bins[codes]
            Pk = P[keep]
            nz = Pk > 0.0
            return float((Pk[nz] * np.log(Pk[nz] / Q[nz])).sum())

        los = mn * np.linspace(1.0, 1.0 / grid, grid) if mn < 0 else [mn]
        his = mx * np.linspace(1.0, 1.0 / grid, grid) if mx > 0 else [mx]
        best = (err(mn, mx), mn, mx)
        lo = mn
        for _ in range(2):  # alternate the two ends (coordinate descent)
            for h in his:
                e = err(lo, float(h))
                if e < best[0]:
                    best = (e, lo, float(h))
            hi = best[2]
            for l_ in los:
                e = err(float(l_), hi)
                if e < best[0]:
                    best = (e, float(l_), hi)
            lo = best[1]
        return best[1], best[2]

    def select_range(self, method: str,
                     percentile: float = 99.99) -> Tuple[float, float]:
        if method == "minmax":
            return self.range_minmax()
        if method == "percentile":
            return self.range_percentile(percentile)
        if method == "mse":
            return self.range_mse()
        if method == "entropy":
            return self.range_entropy()
        raise ValueError(
            f"unknown calibration method {method!r}; "
            f"expected one of {CALIBRATION_METHODS}")


@dataclass
class LayerQuant:
    """Quantized parameters of one weighted layer (weights keep their
    graph layout: HWIO / HWCM / ``(d_in, d_out)``)."""

    w_scale: np.ndarray  # (c_out,) float32, symmetric per-channel
    w_q: np.ndarray      # int8
    b_q: np.ndarray      # int32 at scale s_in * s_w[k]
    # True when the producer's per-channel input scales were folded
    # into the weights before quantization: ``w_scale`` then already
    # carries the input-scale dimension, so every derived constant
    # drops its ``s_in`` factor (bias scale, requant, dequant).
    in_folded: bool = False


@dataclass
class QuantizedGraph:
    """A trained graph annotated with calibration-derived qparams."""

    graph: CNNGraph
    acts: Dict[str, QParams]          # layer name -> output qparams
    weights: Dict[str, LayerQuant] = field(default_factory=dict)
    # how the activation ranges were selected (threads through session
    # info, autotune cache keys, and benchmark records)
    method: str = "minmax"
    percentile: float = 99.99
    # the selected (lo, hi) float range per observed tensor — what the
    # method actually chose, before the zero-widening in
    # qparams_from_range (debug/info; Concat entries are the union of
    # their branches' calibrated ranges)
    ranges: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    # per-channel activation qparams for the layers
    # :func:`per_channel_eligible` admitted (opt-in; empty by default).
    # A name present here overrides its scalar ``acts`` entry for the
    # int8 execution path; the scalar entry is kept for info/digest.
    channel_acts: Dict[str, ChannelQParams] = field(default_factory=dict)

    # -- qparam lookups ------------------------------------------------------

    def out_qp(self, layer) -> QParams:
        return self.acts[layer.name]

    def in_qp(self, layer, idx: int = 0) -> QParams:
        return self.acts[layer.inputs[idx]]

    def channel_qp(self, name: str) -> Optional[ChannelQParams]:
        """Per-channel qparams of ``name``'s output, or None."""
        return self.channel_acts.get(name)

    def in_channel_qp(self, layer, idx: int = 0) \
            -> Optional[ChannelQParams]:
        return self.channel_acts.get(layer.inputs[idx])

    @property
    def input_qp(self) -> QParams:
        return self.acts[self.graph.layers[0].name]

    # -- derived constants (single source for cgen AND the jax ref) ----------

    def requant_scales(self, layer) -> np.ndarray:
        """(c_out,) float32: ``s_in * s_w[k] / s_out``.

        Per-channel variants fold into the same shape: an ``in_folded``
        layer's ``w_scale`` already carries ``s_in``, and a per-channel
        *output* divides by the per-channel ``s_out[k]`` vector — the
        epilogue still reads one multiplier per output channel."""
        lq = self.weights[layer.name]
        if lq.in_folded:
            num = lq.w_scale.astype(np.float64)
        else:
            s_in = float(self.in_qp(layer).scale)
            num = s_in * lq.w_scale.astype(np.float64)
        cq = self.channel_qp(layer.name)
        if cq is not None:
            return np.float32(num / cq.scale.astype(np.float64))
        return np.float32(num / float(self.out_qp(layer).scale))

    def dequant_scales(self, layer) -> np.ndarray:
        """(c_out,) float32: ``s_in * s_w[k]`` — sink dequantization."""
        lq = self.weights[layer.name]
        if lq.in_folded:
            return np.float32(lq.w_scale.astype(np.float64))
        s_in = float(self.in_qp(layer).scale)
        return np.float32(s_in * lq.w_scale.astype(np.float64))

    def rescale(self, layer, idx: int = 0) -> np.float32:
        """float32 ``s_in_idx / s_out`` for Add/Concat/ReLU requant."""
        return np.float32(float(self.in_qp(layer, idx).scale)
                          / float(self.out_qp(layer).scale))

    def pool_scales(self, layer, in_shape) -> np.ndarray:
        """AvgPool/GlobalAvgPool requant multipliers.

        AvgPool: ``(oh, ow)`` float32 ``s_in / (s_out * count[i,j])``
        with the edge-correct per-window valid-tap count.
        GlobalAvgPool: scalar float32 ``s_in / (s_out * h*w)``."""
        s_in = float(self.in_qp(layer).scale)
        s_out = float(self.out_qp(layer).scale)
        if isinstance(layer, GlobalAvgPool):
            return np.float32(s_in / (s_out * in_shape[0] * in_shape[1]))
        counts = pool_window_counts(in_shape, layer.size, layer.strides,
                                    layer.pad_amounts(in_shape))
        return np.float32(s_in / (s_out * counts.astype(np.float64)))

    def effective_bias(self, layer, x_offset: int = 0) -> np.ndarray:
        """(c_out,) int32: bias with the input zero-point correction
        folded in (``b_q[k] - zp_in * sum_taps w_q[...,k]``), so the C
        inner loop is a plain raw-code dot product — padding an int8
        feature map with the zero code then cancels exactly.

        ``x_offset=128`` is the u8·s8 kernel variant's view
        (``vpmaddubsw``/``vpdpbusd`` take *unsigned* activations): the
        emitter re-biases every int8 code by +128 (one XOR of the sign
        bit), and this fold subtracts the matching ``128 * sum(w)`` —
        the int32 accumulator is bit-identical to the signed kernels'."""
        lq = self.weights[layer.name]
        w = lq.w_q.astype(np.int64)
        cin = self.in_channel_qp(layer)
        if cin is not None:
            # per-channel input zero points: the correction is a per-
            # input-channel weighted sum instead of zp * sum(w)
            zpv = cin.zero_point.astype(np.int64) + x_offset
            if isinstance(layer, Conv2D):
                zsum = np.einsum("hwck,c->k", w, zpv)
            elif isinstance(layer, DepthwiseConv2D):
                zsum = (w.sum(axis=(0, 1))
                        * zpv[:, None]).reshape(-1)  # (ci*mult,)
            else:  # Dense: flattened NHWC input, channel fastest
                zfull = np.tile(zpv, w.shape[0] // zpv.size)
                zsum = (w * zfull[:, None]).sum(axis=0)
            return (lq.b_q.astype(np.int64) - zsum).astype(np.int32)
        zp = self.in_qp(layer).zero_point + x_offset
        if isinstance(layer, Conv2D):
            wsum = w.sum(axis=(0, 1, 2))
        elif isinstance(layer, DepthwiseConv2D):
            wsum = w.sum(axis=(0, 1)).reshape(-1)  # (ci*mult,) group-major
        else:  # Dense
            wsum = w.sum(axis=0)
        return (lq.b_q.astype(np.int64) - zp * wsum).astype(np.int32)


def check_quantizable(graph: CNNGraph) -> None:
    """The int8 path supports the *optimized* layer set; anything the
    NNCG passes should have removed is rejected with a pointer."""
    sink = graph.sink
    for layer in graph.layers:
        if isinstance(layer, BatchNorm):
            raise ValueError(
                f"{layer.name}: BatchNorm is not quantizable — run "
                "passes.optimize first (folds BN into the conv)")
        if isinstance(layer, Softmax) and layer is not sink:
            raise ValueError(
                f"{layer.name}: standalone Softmax is only supported as "
                "the graph output in int8 mode")
        if getattr(layer, "activation", None) == "softmax" \
                and layer is not sink:
            raise ValueError(
                f"{layer.name}: fused softmax is only supported on the "
                "graph output in int8 mode")
    if not isinstance(sink, _WEIGHTED + (Softmax,)):
        raise ValueError(
            f"sink {sink.name} ({type(sink).__name__}): int8 mode "
            "requires a Conv2D/DepthwiseConv2D/Dense (or Softmax) output "
            "layer to dequantize into")


def calibrate(graph: CNNGraph, xs: np.ndarray, *,
              method: str = "minmax",
              percentile: float = 99.99,
              nbins: int = 2048,
              chunk_size: int = 8,
              ranges_out: Optional[Dict[str, Tuple[float, float]]] = None,
              channel_names: Tuple[str, ...] = (),
              channel_out: Optional[Dict[str, ChannelQParams]] = None,
              device=None) -> Dict[str, QParams]:
    """Stream the calibration batch through the float executor in chunks
    on ``device`` (the card unless the caller names another) and derive
    per-tensor (post-activation) qparams.

    Each chunk runs layer by layer through ``torch_exec._apply``; every
    observed tensor comes to the host once and updates its
    :class:`Observer` (exact min/max + fixed-bin histogram), and is
    dropped as soon as its last in-chunk consumer has run — peak
    calibration memory is one chunk's live set.  ``method`` selects the
    range per tensor (see :data:`CALIBRATION_METHODS`).  On a CUDA device
    the convolutions run in full fp32, not TF32
    (:func:`~repro_torch.core.torch_exec.use_fp32_convolutions`): TF32
    would move every range by about 1e-3.

    Per-branch rule for multi-input layers: qparams are selected on
    each *producer* tensor independently, and a Concat output takes the
    **union of its branches' calibrated ranges**.

    ``channel_names`` requests additional per-output-channel exact
    min/max tracking for those layers (the per-channel path always uses
    minmax); results land in ``channel_out`` as :class:`ChannelQParams`.
    """
    if method not in CALIBRATION_METHODS:
        raise ValueError(
            f"unknown calibration method {method!r}; "
            f"expected one of {CALIBRATION_METHODS}")
    xs = np.asarray(xs, np.float32)
    if xs.ndim == 3:
        xs = xs[None]
    assert xs.ndim == 4 and xs.shape[1:] == tuple(graph.input_shape), (
        f"calibration batch must be (N,)+{tuple(graph.input_shape)}, "
        f"got {xs.shape}")
    dev = resolve_device(device)
    use_fp32_convolutions(dev)
    params = extract_params(graph, dev)

    # layers whose qparams are derived, not observed: identity/MaxPool
    # share their producer's; Concat takes the union of its branches
    derived = {l.name for l in graph.layers
               if isinstance(l, _SHARE_INPUT_QPARAMS + (Concat,))}
    # refcounts for in-chunk eviction (a value dies after its last use;
    # the sink is kept through its own step only)
    n_consumers: Dict[str, int] = {l.name: 0 for l in graph.layers}
    for layer in graph.layers:
        for src in layer.inputs:
            n_consumers[src] += 1

    observers: Dict[str, Observer] = {
        l.name: Observer(nbins) for l in graph.layers
        if l.name not in derived}
    ch_set = frozenset(channel_names)
    ch_mn: Dict[str, np.ndarray] = {}
    ch_mx: Dict[str, np.ndarray] = {}

    chunk_size = max(1, int(chunk_size))
    with torch.inference_mode():
        for c0 in range(0, len(xs), chunk_size):
            x = torch.from_numpy(xs[c0:c0 + chunk_size]).to(dev)
            vals: Dict[str, torch.Tensor] = {}
            pending: Dict[str, int] = dict(n_consumers)
            for layer in graph.layers:
                name = layer.name
                if isinstance(layer, Input):
                    vals[name] = x
                else:
                    vals[name] = torch_exec._apply(
                        layer, [vals[n] for n in layer.inputs],
                        params.get(name))
                if name in observers or name in ch_set:
                    host = vals[name].cpu().numpy()  # once a chunk
                    if name in observers:
                        observers[name].update(host)
                    if name in ch_set:
                        v = host.reshape(-1, host.shape[-1])
                        cmn, cmx = v.min(axis=0), v.max(axis=0)
                        if name in ch_mn:
                            ch_mn[name] = np.minimum(ch_mn[name], cmn)
                            ch_mx[name] = np.maximum(ch_mx[name], cmx)
                        else:
                            ch_mn[name] = cmn
                            ch_mx[name] = cmx
                for src in layer.inputs:
                    pending[src] -= 1
                    if pending[src] == 0:
                        del vals[src]  # streaming: chunk-local liveness
                if pending[name] == 0:
                    del vals[name]

    ranges: Dict[str, Tuple[float, float]] = {}
    acts: Dict[str, QParams] = {}
    for layer in graph.layers:
        name = layer.name
        if isinstance(layer, _SHARE_INPUT_QPARAMS):
            acts[name] = acts[layer.inputs[0]]
            ranges[name] = ranges[layer.inputs[0]]
            continue
        if isinstance(layer, Concat):
            # per-branch: union of the branches' calibrated ranges
            branch = [ranges[n] for n in layer.inputs]
            lo = min(b[0] for b in branch)
            hi = max(b[1] for b in branch)
            ranges[name] = (lo, hi)
        else:
            ranges[name] = observers[name].select_range(method, percentile)
        acts[name] = qparams_from_range(*ranges[name])
    if ranges_out is not None:
        ranges_out.update(ranges)
    if channel_out is not None:
        for name in ch_set:
            channel_out[name] = channel_qparams_from_range(
                ch_mn[name], ch_mx[name])
    return acts


def quantize_weights(layer,
                     in_scales: Optional[np.ndarray] = None) -> LayerQuant:
    """Symmetric per-output-channel int8 weights + int32 bias.

    ``in_scales`` (producer per-channel activation scales, one per
    input channel) folds into the weights before quantization:
    ``w_eff[.., ci, k] = w[.., ci, k] * s_x[ci]``, so the consumer's
    raw-code dot product implicitly rescales each input channel —
    the integer inner loop is unchanged."""
    w = np.asarray(layer.weights, np.float64)
    if in_scales is not None:
        s = np.asarray(in_scales, np.float64)
        if isinstance(layer, (Conv2D, DepthwiseConv2D)):
            w = w * s[None, None, :, None]        # HWIO / HWCM ci axis
        else:  # Dense: flattened NHWC input, channel fastest
            w = w * np.tile(s, w.shape[0] // s.size)[:, None]
    if isinstance(layer, Conv2D):
        absmax = np.abs(w).max(axis=(0, 1, 2))          # (c_out,)
    elif isinstance(layer, DepthwiseConv2D):
        absmax = np.abs(w).max(axis=(0, 1)).reshape(-1)  # (ci*mult,)
    elif isinstance(layer, Dense):
        absmax = np.abs(w).max(axis=0)                   # (d_out,)
    else:  # pragma: no cover
        raise TypeError(f"{layer.name}: not a weighted layer")
    scale = np.where(absmax > 0, absmax / QMAX, 1.0)
    scale = scale.astype(np.float32)

    if isinstance(layer, DepthwiseConv2D):
        per_tap = scale.reshape(w.shape[2], w.shape[3])[None, None]
    else:
        per_tap = scale
    w_q = np.clip(np.round(w / per_tap.astype(np.float64)),
                  -QMAX, QMAX).astype(np.int8)
    return LayerQuant(w_scale=scale, w_q=w_q,
                      b_q=np.zeros(scale.shape, np.int32),
                      in_folded=in_scales is not None)


def quantize_graph(graph: CNNGraph,
                   acts: Dict[str, QParams],
                   channel_acts: Optional[Dict[str, ChannelQParams]] = None,
                   ) -> QuantizedGraph:
    """Annotate a calibrated graph with quantized weights and biases."""
    check_quantizable(graph)
    channel_acts = dict(channel_acts or {})
    qg = QuantizedGraph(graph=graph, acts=dict(acts),
                        channel_acts=channel_acts)
    for layer in graph.layers:
        if not isinstance(layer, _WEIGHTED):
            continue
        cin = channel_acts.get(layer.inputs[0])
        lq = quantize_weights(
            layer, in_scales=None if cin is None else cin.scale)
        if cin is None:
            s_in = float(acts[layer.inputs[0]].scale)
            bias_scale = s_in * lq.w_scale.astype(np.float64)
        else:  # s_in folded into w_scale already
            bias_scale = lq.w_scale.astype(np.float64)
        lq.b_q = np.round(
            np.asarray(layer.bias, np.float64) / bias_scale
        ).astype(np.int32)
        qg.weights[layer.name] = lq
    return qg


def quantize(graph: CNNGraph, calibration: np.ndarray, *,
             method: str = "minmax",
             percentile: float = 99.99,
             nbins: int = 2048,
             chunk_size: int = 8,
             per_channel: bool = False,
             device=None) -> QuantizedGraph:
    """The two-step pipeline: calibrate on samples on ``device``
    (streaming histogram observers, range selection per ``method``),
    annotate the graph.

    ``per_channel=True`` additionally gives every
    :func:`per_channel_eligible` layer per-output-channel activation
    qparams (exact min/max per channel), folding the scales into the
    consumers' weight quantization — see the module docstring."""
    ranges: Dict[str, Tuple[float, float]] = {}
    ch_names = tuple(per_channel_eligible(graph)) if per_channel else ()
    channel_out: Dict[str, ChannelQParams] = {}
    acts = calibrate(graph, calibration, method=method,
                     percentile=percentile, nbins=nbins,
                     chunk_size=chunk_size, ranges_out=ranges,
                     channel_names=ch_names, channel_out=channel_out,
                     device=device)
    qg = quantize_graph(graph, acts, channel_acts=channel_out)
    qg.method = method
    qg.percentile = percentile
    qg.ranges = ranges
    return qg


def quantize_from_qparams(graph: CNNGraph,
                          qparams: Dict[str, object]) -> QuantizedGraph:
    """Annotate a graph with *externally-determined* activation qparams
    — e.g. exported from a QAT run — skipping the calibration pass
    entirely (:class:`repro_torch.engine.CalibrationConfig` ``qparams=...``).

    ``qparams`` maps layer name -> :class:`QParams`, ``(scale,
    zero_point)`` pair, or ``{"scale": ..., "zero_point": ...}`` dict.
    Identity/MaxPool layers (:data:`_SHARE_INPUT_QPARAMS`) may be
    omitted — they inherit their producer's entry, the same sharing
    rule :func:`calibrate` applies.  Every other layer must be present.

    Feeding back the ``acts`` dict of a calibrated
    :class:`QuantizedGraph` reproduces that build bit-for-bit: the
    weight/bias quantization depends only on the activation qparams.
    """
    acts: Dict[str, QParams] = {}
    for name, qp in qparams.items():
        if isinstance(qp, QParams):
            pass
        elif isinstance(qp, dict):
            qp = QParams(scale=float(qp["scale"]),
                         zero_point=int(qp["zero_point"]))
        elif isinstance(qp, (tuple, list)) and len(qp) == 2:
            qp = QParams(scale=float(qp[0]), zero_point=int(qp[1]))
        else:
            raise TypeError(
                f"qparams[{name!r}]: expected QParams, (scale, "
                f"zero_point), or a dict with those keys; got {qp!r}")
        if not (qp.scale > 0.0):
            raise ValueError(f"qparams[{name!r}]: scale must be > 0, "
                             f"got {qp.scale!r}")
        acts[name] = qp

    known = {l.name for l in graph.layers}
    unknown = sorted(set(acts) - known)
    if unknown:
        raise ValueError(f"qparams name {unknown[0]!r} is not a layer "
                         "of this graph")
    for layer in graph.layers:
        if layer.name in acts:
            continue
        if isinstance(layer, _SHARE_INPUT_QPARAMS):
            acts[layer.name] = acts[layer.inputs[0]]  # producer first in
            continue                                  # topological order
        raise ValueError(
            f"qparams missing for layer {layer.name!r} "
            f"({type(layer).__name__}); only identity/MaxPool layers "
            "may be omitted")

    qg = quantize_graph(graph, acts)
    qg.method = "provided"
    qg.ranges = {n: (float(qp.scale * (QMIN - qp.zero_point)),
                     float(qp.scale * (QMAX - qp.zero_point)))
                 for n, qp in qg.acts.items()}
    return qg


def qparams_digest(qg: QuantizedGraph) -> str:
    """Content hash of the calibration outcome (method + every
    activation qparam).  Two sessions whose calibration differs —
    different data, method, or percentile — must not share autotune
    cache entries for the int8 build, because the generated C embeds
    the qparams."""
    h = hashlib.sha256()
    h.update(f"{qg.method}:{qg.percentile!r};".encode())
    for name in sorted(qg.acts):
        qp = qg.acts[name]
        h.update(f"{name}={np.float32(qp.scale).tobytes().hex()}"
                 f",{qp.zero_point};".encode())
    for name in sorted(qg.channel_acts):
        cq = qg.channel_acts[name]
        h.update(f"ch:{name}="
                 f"{cq.scale.astype(np.float32).tobytes().hex()},"
                 f"{cq.zero_point.astype(np.int32).tobytes().hex()};"
                 .encode())
    return h.hexdigest()[:16]


def quantization_error(qg: QuantizedGraph,
                       xs: np.ndarray,
                       ref: Optional[np.ndarray] = None,
                       device=None) -> dict:
    """Accuracy probe: int8 vs float executor on a batch on ``device``
    (the card unless the caller names another) — max |Δ| and top-1
    agreement over the channel axis (the calibration-set gate).

    For a 4-D (N, h, w, c) output the argmax is taken over the channel
    axis at **every spatial position** (a spatial sink like the robot
    detector head is h*w independent classifications, not one flat
    h*w*c argmax); flat outputs argmax over everything but the batch."""
    dev = resolve_device(device)
    use_fp32_convolutions(dev)
    xs = np.asarray(xs, np.float32)
    x = torch.from_numpy(xs).to(dev)
    with torch.inference_mode():
        if ref is None:
            ref = torch_exec.forward(qg.graph, x, extract_params(
                qg.graph, dev)).cpu().numpy()
        got = torch_exec.forward_quantized(qg, x).cpu().numpy()
    ref = np.asarray(ref).reshape(got.shape)
    if got.ndim == 4:  # per-position channel argmax
        agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    else:
        agree = (got.reshape(got.shape[0], -1).argmax(-1)
                 == ref.reshape(ref.shape[0], -1).argmax(-1)).mean()
    return {
        "max_abs_err": float(np.abs(got - ref).max()),
        "top1_agreement": float(agree),
    }


def from_reference_qgraph(qg) -> QuantizedGraph:
    """Rebuild any quantized-graph-like object (anything with the fields
    of :class:`QuantizedGraph`) as a port :class:`QuantizedGraph`, the
    counterpart of :func:`~repro_torch.core.graph.from_reference_graph`.

    Reads attributes only: ``graph`` (through ``from_reference_graph``),
    ``acts`` and ``channel_acts`` (scale / zero_point), ``weights``
    (``w_scale``, ``w_q``, ``b_q``, ``in_folded``), ``method``,
    ``percentile`` and ``ranges``.  Arrays are copied with their values
    unchanged, so both packages then run the same qgraph."""
    return QuantizedGraph(
        graph=from_reference_graph(qg.graph),
        acts={name: QParams(scale=float(qp.scale),
                            zero_point=int(qp.zero_point))
              for name, qp in qg.acts.items()},
        weights={name: LayerQuant(w_scale=np.array(lq.w_scale),
                                  w_q=np.array(lq.w_q),
                                  b_q=np.array(lq.b_q),
                                  in_folded=bool(lq.in_folded))
                 for name, lq in qg.weights.items()},
        method=str(qg.method),
        percentile=float(qg.percentile),
        ranges={name: (float(lo), float(hi))
                for name, (lo, hi) in qg.ranges.items()},
        channel_acts={name: ChannelQParams(scale=np.array(cq.scale),
                                           zero_point=np.array(cq.zero_point))
                      for name, cq in qg.channel_acts.items()})
