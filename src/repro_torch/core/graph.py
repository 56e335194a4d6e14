"""Layer-graph IR for trained CNNs (the NNCG front-end), PyTorch port.

The port's own copy of the JAX package's ``core/graph.py``: the same
layer dataclasses, the same DAG validation and shape inference, with
weights held as float32 numpy arrays.  The executors in
:mod:`repro_torch.core.torch_exec` move them to a device.

:func:`from_reference_graph` carries a graph built by the JAX package
across — it rebuilds every layer by class name and dataclass fields, so
the port never imports that package.

Layout is channels-last (NHWC / HWIO) throughout, as in the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Shape3 = Tuple[int, int, int]  # (h, w, c)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


def _conv_pads(in_shape: Shape3, kh: int, kw: int, strides: Tuple[int, int],
               padding: str) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) zero padding (paper Eq. 1)."""
    if padding == "valid":
        return (0, 0, 0, 0)
    h, w, _ = in_shape
    sh, sw = strides
    out_h = -(-h // sh)  # ceil
    out_w = -(-w // sw)
    pad_h = max((out_h - 1) * sh + kh - h, 0)
    pad_w = max((out_w - 1) * sw + kw - w, 0)
    return (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)


@dataclass
class Layer:
    """Base class.

    ``inputs`` holds the names of producer layers (DAG edges). ``None``
    means "wire me to the previous layer in the list" — resolved by
    :class:`CNNGraph` so sequential model definitions stay terse.
    """

    name: str = field(default="", kw_only=True)
    inputs: Optional[List[str]] = field(default=None, kw_only=True)

    def out_shape(self, in_shape: Shape3) -> Shape3:  # pragma: no cover
        raise NotImplementedError

    def infer_shape(self, in_shapes: Sequence[Shape3]) -> Shape3:
        """Output shape from the (ordered) producer shapes. Single-input
        layers delegate to :meth:`out_shape`; multi-input layers override."""
        return self.out_shape(in_shapes[0] if in_shapes else None)

    def param_count(self) -> int:
        return 0


@dataclass
class Input(Layer):
    shape: Shape3 = (1, 1, 1)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return tuple(int(s) for s in self.shape)


@dataclass
class Conv2D(Layer):
    """2-D convolution, weights HWIO ``(kh, kw, c_in, c_out)``.

    ``activation`` holds a fused activation (None | 'relu' | 'leaky_relu'
    | 'softmax') — the fusion pass moves standalone activation layers in
    here so the code generator emits a single fused loop nest (paper
    §II-B.1).
    """

    weights: np.ndarray = None
    bias: np.ndarray = None
    strides: Tuple[int, int] = (1, 1)
    padding: str = "valid"  # 'same' | 'valid'
    activation: Optional[str] = None
    alpha: float = 0.1  # leaky-ReLU slope

    def __post_init__(self):
        self.strides = _pair(self.strides)
        self.weights = np.asarray(self.weights, dtype=np.float32)
        if self.bias is None:
            self.bias = np.zeros(self.weights.shape[-1], dtype=np.float32)
        self.bias = np.asarray(self.bias, dtype=np.float32)
        assert self.weights.ndim == 4, "Conv2D weights must be HWIO"
        assert self.padding in ("same", "valid")

    @property
    def kh(self) -> int:
        return self.weights.shape[0]

    @property
    def kw(self) -> int:
        return self.weights.shape[1]

    @property
    def c_in(self) -> int:
        return self.weights.shape[2]

    @property
    def c_out(self) -> int:
        return self.weights.shape[3]

    def pad_amounts(self, in_shape: Shape3) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right) zero padding (paper Eq. 1)."""
        return _conv_pads(in_shape, self.kh, self.kw, self.strides,
                          self.padding)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        h, w, c = in_shape
        assert c == self.c_in, f"{self.name}: c_in {self.c_in} != input {c}"
        sh, sw = self.strides
        pt, pb, pl, pr = self.pad_amounts(in_shape)
        oh = (h + pt + pb - self.kh) // sh + 1
        ow = (w + pl + pr - self.kw) // sw + 1
        return (oh, ow, self.c_out)

    def param_count(self) -> int:
        return int(self.weights.size + self.bias.size)


@dataclass
class DepthwiseConv2D(Layer):
    """Depthwise convolution, weights HWCM ``(kh, kw, c_in, multiplier)``.

    Each input channel is convolved with its own ``multiplier`` filters;
    output channel ``c * multiplier + m`` comes from input channel ``c``
    (group-major, matching XLA's grouped-conv channel ordering)."""

    weights: np.ndarray = None
    bias: np.ndarray = None
    strides: Tuple[int, int] = (1, 1)
    padding: str = "valid"
    activation: Optional[str] = None
    alpha: float = 0.1

    def __post_init__(self):
        self.strides = _pair(self.strides)
        self.weights = np.asarray(self.weights, dtype=np.float32)
        assert self.weights.ndim == 4, "DepthwiseConv2D weights must be HWCM"
        if self.bias is None:
            self.bias = np.zeros(self.c_in * self.multiplier, dtype=np.float32)
        self.bias = np.asarray(self.bias, dtype=np.float32)
        assert self.padding in ("same", "valid")

    @property
    def kh(self) -> int:
        return self.weights.shape[0]

    @property
    def kw(self) -> int:
        return self.weights.shape[1]

    @property
    def c_in(self) -> int:
        return self.weights.shape[2]

    @property
    def multiplier(self) -> int:
        return self.weights.shape[3]

    @property
    def c_out(self) -> int:
        return self.c_in * self.multiplier

    def pad_amounts(self, in_shape: Shape3) -> Tuple[int, int, int, int]:
        return _conv_pads(in_shape, self.kh, self.kw, self.strides,
                          self.padding)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        h, w, c = in_shape
        assert c == self.c_in, f"{self.name}: c_in {self.c_in} != input {c}"
        sh, sw = self.strides
        pt, pb, pl, pr = self.pad_amounts(in_shape)
        oh = (h + pt + pb - self.kh) // sh + 1
        ow = (w + pl + pr - self.kw) // sw + 1
        return (oh, ow, self.c_out)

    def param_count(self) -> int:
        return int(self.weights.size + self.bias.size)


@dataclass
class Dense(Layer):
    """Fully connected: weights ``(d_in, d_out)``; input is flattened."""

    weights: np.ndarray = None
    bias: np.ndarray = None
    activation: Optional[str] = None
    alpha: float = 0.1

    def __post_init__(self):
        self.weights = np.asarray(self.weights, dtype=np.float32)
        if self.bias is None:
            self.bias = np.zeros(self.weights.shape[-1], dtype=np.float32)
        self.bias = np.asarray(self.bias, dtype=np.float32)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        d_in = int(np.prod(in_shape))
        assert d_in == self.weights.shape[0]
        return (1, 1, int(self.weights.shape[1]))

    def param_count(self) -> int:
        return int(self.weights.size + self.bias.size)


def pool_window_counts(in_shape: Shape3, size, strides, pads) -> np.ndarray:
    """Per-output-window count of *valid* (non-padding) taps, shape
    ``(oh, ow)``.  Factorizes as rows(i) * cols(j); edge windows of a
    ``same``-padded pool cover fewer valid elements, so AvgPool must
    divide by this, not by the fixed ``kh*kw``."""
    h, w, _ = in_shape
    kh, kw = size
    sh, sw = strides
    pt, pb, pl, pr = pads
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    rows = np.array([min(i * sh - pt + kh, h) - max(i * sh - pt, 0)
                     for i in range(oh)], dtype=np.int64)
    cols = np.array([min(j * sw - pl + kw, w) - max(j * sw - pl, 0)
                     for j in range(ow)], dtype=np.int64)
    return rows[:, None] * cols[None, :]


@dataclass
class _Pool(Layer):
    """Shared window semantics for spatial pooling.

    ``padding='same'`` uses the conv padding arithmetic (paper Eq. 1);
    padded taps never contribute to the result — MaxPool ignores them,
    AvgPool divides by the per-window count of *valid* elements."""

    size: Tuple[int, int] = (2, 2)
    strides: Optional[Tuple[int, int]] = None  # default = size
    padding: str = "valid"  # 'same' | 'valid'

    def __post_init__(self):
        self.size = _pair(self.size)
        self.strides = _pair(self.strides) if self.strides is not None else self.size
        assert self.padding in ("same", "valid")

    def pad_amounts(self, in_shape: Shape3) -> Tuple[int, int, int, int]:
        return _conv_pads(in_shape, self.size[0], self.size[1],
                          self.strides, self.padding)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        h, w, c = in_shape
        kh, kw = self.size
        sh, sw = self.strides
        pt, pb, pl, pr = self.pad_amounts(in_shape)
        return ((h + pt + pb - kh) // sh + 1,
                (w + pl + pr - kw) // sw + 1, c)


@dataclass
class MaxPool(_Pool):
    pass


@dataclass
class AvgPool(_Pool):
    """Average pooling, same window semantics as :class:`MaxPool`."""


@dataclass
class GlobalAvgPool(Layer):
    """Spatial mean over (h, w): ``(h, w, c) -> (1, 1, c)``."""

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return (1, 1, int(in_shape[2]))


@dataclass
class Add(Layer):
    """Elementwise sum of ≥2 same-shape inputs (residual connection).

    ``activation`` (None | 'relu' | 'leaky_relu') lets the fusion pass
    fold the post-merge activation into the same loop."""

    activation: Optional[str] = None
    alpha: float = 0.1

    def infer_shape(self, in_shapes: Sequence[Shape3]) -> Shape3:
        assert len(in_shapes) >= 2, f"{self.name}: Add needs >=2 inputs"
        first = tuple(in_shapes[0])
        for s in in_shapes[1:]:
            assert tuple(s) == first, (
                f"{self.name}: Add shape mismatch {in_shapes}")
        return first

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class Concat(Layer):
    """Channel-axis concatenation of ≥2 inputs with equal (h, w)."""

    def infer_shape(self, in_shapes: Sequence[Shape3]) -> Shape3:
        assert len(in_shapes) >= 2, f"{self.name}: Concat needs >=2 inputs"
        h, w, _ = in_shapes[0]
        for s in in_shapes[1:]:
            assert tuple(s[:2]) == (h, w), (
                f"{self.name}: Concat spatial mismatch {in_shapes}")
        return (h, w, int(sum(s[2] for s in in_shapes)))

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class ReLU(Layer):
    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class LeakyReLU(Layer):
    alpha: float = 0.1

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class Softmax(Layer):
    """Softmax over the channel dimension."""

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class BatchNorm(Layer):
    """Inference-mode batch normalization over channels (paper §II-B.4)."""

    mean: np.ndarray = None
    var: np.ndarray = None
    gamma: np.ndarray = None
    beta: np.ndarray = None
    eps: float = 1e-3

    def __post_init__(self):
        self.mean = np.asarray(self.mean, dtype=np.float32)
        self.var = np.asarray(self.var, dtype=np.float32)
        if self.gamma is None:
            self.gamma = np.ones_like(self.mean)
        if self.beta is None:
            self.beta = np.zeros_like(self.mean)
        self.gamma = np.asarray(self.gamma, dtype=np.float32)
        self.beta = np.asarray(self.beta, dtype=np.float32)

    def scale_shift(self) -> Tuple[np.ndarray, np.ndarray]:
        """y = scale * x + shift."""
        inv = self.gamma / np.sqrt(self.var + self.eps)
        return inv.astype(np.float32), (self.beta - self.mean * inv).astype(np.float32)

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape

    def param_count(self) -> int:
        return int(self.mean.size * 4)


@dataclass
class Dropout(Layer):
    rate: float = 0.5

    def out_shape(self, in_shape: Shape3) -> Shape3:
        return in_shape


@dataclass
class Flatten(Layer):
    def out_shape(self, in_shape: Shape3) -> Shape3:
        return (1, 1, int(np.prod(in_shape)))


@dataclass
class CNNGraph:
    """A DAG of layers; ``layers[0]`` must be :class:`Input` and the list
    must be topologically ordered (validated).  Layers with ``inputs=None``
    are auto-wired to their list predecessor, so a plain sequential list
    is still a valid graph."""

    layers: List[Layer]

    def __post_init__(self):
        assert self.layers and isinstance(self.layers[0], Input)
        for i, l in enumerate(self.layers):
            if not l.name:
                l.name = f"{type(l).__name__.lower()}_{i}"
        names = [l.name for l in self.layers]
        assert len(set(names)) == len(names), f"duplicate layer names: {names}"
        seen: set = set()
        for i, l in enumerate(self.layers):
            if isinstance(l, Input):
                assert not l.inputs, f"{l.name}: Input takes no inputs"
                l.inputs = []
            elif l.inputs is None:  # list→DAG adapter: chain to predecessor
                l.inputs = [self.layers[i - 1].name]
            for src in l.inputs:
                assert src in seen, (
                    f"{l.name}: input {src!r} must precede it (topo order)")
            seen.add(l.name)

    # -- structure -----------------------------------------------------------

    def layer(self, name: str) -> Layer:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def consumers(self) -> Dict[str, List[Layer]]:
        """Map producer name -> consuming layers, in topo order."""
        out: Dict[str, List[Layer]] = {l.name: [] for l in self.layers}
        for l in self.layers:
            for src in l.inputs:
                out[src].append(l)
        return out

    @property
    def sink(self) -> Layer:
        """The unique output layer (consumed by nobody)."""
        cons = self.consumers()
        sinks = [l for l in self.layers if not cons[l.name]]
        assert len(sinks) == 1, (
            f"graph must have exactly one output, got "
            f"{[s.name for s in sinks]}")
        return sinks[0]

    @property
    def input_shape(self) -> Shape3:
        return self.layers[0].shape

    def shape_map(self) -> Dict[str, Shape3]:
        """Output shape of every layer, keyed by name (topo evaluation)."""
        smap: Dict[str, Shape3] = {}
        for l in self.layers:
            smap[l.name] = l.infer_shape([smap[n] for n in l.inputs])
        return smap

    def in_shapes(self, layer: Layer,
                  smap: Optional[Dict[str, Shape3]] = None) -> List[Shape3]:
        smap = smap if smap is not None else self.shape_map()
        return [smap[n] for n in layer.inputs]

    def shapes(self) -> List[Shape3]:
        """Per-layer output shapes in list order (``shapes[i]`` = output
        of ``layers[i]``)."""
        smap = self.shape_map()
        return [smap[l.name] for l in self.layers]

    @property
    def output_shape(self) -> Shape3:
        return self.shape_map()[self.sink.name]

    def param_count(self) -> int:
        return sum(l.param_count() for l in self.layers)

    def replace(self, layers: Sequence[Layer]) -> "CNNGraph":
        return CNNGraph(list(layers))

    def copy(self) -> "CNNGraph":
        return CNNGraph([
            dataclasses.replace(l, inputs=list(l.inputs))
            for l in self.layers
        ])


_LAYER_TYPES = {cls.__name__: cls for cls in (
    Input, Conv2D, DepthwiseConv2D, Dense, MaxPool, AvgPool, GlobalAvgPool,
    Add, Concat, ReLU, LeakyReLU, Softmax, BatchNorm, Dropout, Flatten)}


def from_reference_graph(graph) -> CNNGraph:
    """Rebuild any graph-like object (anything with ``.layers`` of
    dataclass layers) as a port :class:`CNNGraph`.

    Layers are matched by class name and copied field by field; numpy
    arrays are copied with their values unchanged, so weights carried
    across are bit-identical to the source's."""
    layers = []
    for l in graph.layers:
        cls = _LAYER_TYPES.get(type(l).__name__)
        if cls is None:
            raise TypeError(f"no port layer for {type(l).__name__}")
        kw = {}
        for f in dataclasses.fields(l):
            v = getattr(l, f.name)
            if isinstance(v, np.ndarray):
                v = v.copy()
            elif isinstance(v, list):
                v = list(v)
            kw[f.name] = v
        layers.append(cls(**kw))
    return CNNGraph(layers)
