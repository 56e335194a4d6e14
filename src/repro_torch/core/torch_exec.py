"""PyTorch executor for :class:`repro_torch.core.graph.CNNGraph`.

Counterpart of the JAX package's ``core/jax_exec.py`` float executor:

* :func:`forward` — the plain eager reference (the ``"torch"`` backend,
  counterpart of ``jax_exec.forward`` behind ``"xla"``);
* :func:`forward_kernels` — the deployment path through the hand-written
  conv2d and maxpool2d kernels (the ``"cuda"`` backend, counterpart of
  ``jax_exec.forward_pallas`` behind ``"pallas"``), with the same
  dispatch rules.
* :func:`forward_quantized` — the int8 reference (the ``"torch"``
  backend at ``precision="int8"``, counterpart of
  ``jax_exec.forward_quantized`` behind ``"xla-int8"``), bit for bit on
  the integer path; :class:`QuantizedCNNModule` holds its constants on
  one device.

Evaluation is a topological walk keyed by layer name, so branching DAGs
(residual Adds, Concats) run through the same code as sequential nets.
Tensors are NHWC at every layer boundary, as in the reference; only the
plain convolution and pooling calls permute internally.  Weights come
from the graph's numpy arrays, or from a ``params`` dict of tensors
already on the device (:func:`extract_params`, :class:`CNNModule`).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops, ref
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

Params = Dict[str, Dict[str, torch.Tensor]]
_WEIGHTED = (Conv2D, DepthwiseConv2D, Dense)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card (``cuda:0``) unless the
    caller names another.  Asking for the card without one raises; it
    never carries on on the CPU."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run on the CPU")
    return dev


def use_fp32_convolutions(device: torch.device) -> None:
    """Make the plain executor's convolutions on ``device`` full fp32.

    cuDNN runs fp32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits and misses the reference's 1e-4.  On a CUDA device
    this sets the switch to False for the whole process, once, and never
    restores it: a scheme that flipped it around each call would race
    between server workers convolving at the same time.  Every other
    cuDNN convolution of the process then runs in fp32 too."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False


def _activation(x: torch.Tensor, kind: Optional[str],
                alpha: float) -> torch.Tensor:
    if kind == "softmax":
        return torch.softmax(x, dim=-1)
    return ref.activation(x, kind, alpha)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, strides,
          pads, groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO convolution plus bias with explicit ``(top, bottom,
    left, right)`` zero padding (asymmetric allowed), through
    ``F.conv2d``: the reference executor's counterpart of ``lax.conv``.
    NHWC is kept at the API; the permute happens only around the call."""
    pt, pb, pl, pr = pads
    xc = x.permute(0, 3, 1, 2)
    if any(pads):
        xc = F.pad(xc, (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=tuple(strides),
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _pool(x: torch.Tensor, size, strides, pads, op: str) -> torch.Tensor:
    """Window max (``op="max"``, padded taps never win) or window sum
    (``op="sum"``, padded taps add 0) with explicit asymmetric pads."""
    pt, pb, pl, pr = pads
    xc = x.permute(0, 3, 1, 2)
    if op == "max":
        if any(pads):
            xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
        y = F.max_pool2d(xc, tuple(size), tuple(strides))
    else:
        if any(pads):
            xc = F.pad(xc, (pl, pr, pt, pb))
        y = F.avg_pool2d(xc, tuple(size), tuple(strides), divisor_override=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _window_plain(layer, x: torch.Tensor,
                  p: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The window layers no kernel covers on the kernel path (a
    DepthwiseConv2D, a ``same``-padded MaxPool, an AvgPool), tap by tap
    with tensor ops, so that path runs no library convolution or pooling.
    The same function as :func:`_apply`'s, summed in another order."""
    pads = layer.pad_amounts(tuple(x.shape[1:]))
    if isinstance(layer, DepthwiseConv2D):
        w, b = _weights(layer, x, p)
        y = sum(xs[..., None] * w[i, j] for i, j, xs in ref.window_taps(
            x, (layer.kh, layer.kw), layer.strides, pads))
        # (N, OH, OW, C, M) -> group-major output channels c * M + m
        y = y.reshape(y.shape[:3] + (layer.c_out,)) + b
        return _activation(y, layer.activation, layer.alpha)
    if isinstance(layer, MaxPool):  # a padded tap never wins
        return functools.reduce(torch.maximum, (xs for _, _, xs in (
            ref.window_taps(x, layer.size, layer.strides, pads,
                            float("-inf")))))
    s = sum(xs for _, _, xs in ref.window_taps(x, layer.size, layer.strides,
                                                pads))
    counts = pool_window_counts(tuple(x.shape[1:]), layer.size,
                                layer.strides, pads)
    return s / _tensor(counts[None, :, :, None], x)


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _weights(layer, x: torch.Tensor, p: Optional[Dict[str, torch.Tensor]]):
    if p is not None:
        return p["w"], p["b"]
    return _tensor(layer.weights, x), _tensor(layer.bias, x)


def _apply(layer, ins: Sequence[torch.Tensor],
           p: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """One batched-NHWC layer application; ``ins`` are the producer
    outputs in edge order, ``p`` the layer's weight tensors (if given)."""
    x = ins[0] if ins else None
    if isinstance(layer, Conv2D):
        w, b = _weights(layer, x, p)
        y = _conv(x, w, b, layer.strides,
                  layer.pad_amounts(tuple(x.shape[1:])))
        return _activation(y, layer.activation, layer.alpha)
    if isinstance(layer, DepthwiseConv2D):
        w, b = _weights(layer, x, p)
        # HWCM -> HWIO with I=1, O=c*mult: group-major output channels
        w = w.reshape(layer.kh, layer.kw, 1, layer.c_out)
        y = _conv(x, w, b, layer.strides,
                  layer.pad_amounts(tuple(x.shape[1:])), groups=layer.c_in)
        return _activation(y, layer.activation, layer.alpha)
    if isinstance(layer, Dense):
        w, b = _weights(layer, x, p)
        y = x.reshape(x.shape[0], -1) @ w + b  # NHWC flatten order
        y = _activation(y, layer.activation, layer.alpha)
        return y.reshape(y.shape[0], 1, 1, -1)
    if isinstance(layer, MaxPool):
        pads = layer.pad_amounts(tuple(x.shape[1:]))
        return _pool(x, layer.size, layer.strides, pads, "max")
    if isinstance(layer, AvgPool):
        pads = layer.pad_amounts(tuple(x.shape[1:]))
        s = _pool(x, layer.size, layer.strides, pads, "sum")
        counts = pool_window_counts(tuple(x.shape[1:]), layer.size,
                                    layer.strides, pads)
        return s / _tensor(counts[None, :, :, None], x)
    if isinstance(layer, GlobalAvgPool):
        return x.mean(dim=(1, 2), keepdim=True)
    if isinstance(layer, Add):
        y = ins[0]
        for other in ins[1:]:
            y = y + other
        return _activation(y, layer.activation, layer.alpha)
    if isinstance(layer, Concat):
        return torch.cat(list(ins), dim=-1)
    if isinstance(layer, ReLU):
        return _activation(x, "relu", 0.0)
    if isinstance(layer, LeakyReLU):
        return _activation(x, "leaky_relu", layer.alpha)
    if isinstance(layer, Softmax):
        return torch.softmax(x, dim=-1)
    if isinstance(layer, BatchNorm):
        scale, shift = layer.scale_shift()
        return x * _tensor(scale, x) + _tensor(shift, x)
    if isinstance(layer, Dropout):
        return x  # identity at inference
    if isinstance(layer, Flatten):
        return x.reshape(x.shape[0], 1, 1, -1)
    raise TypeError(f"unhandled layer {type(layer).__name__}")


def _check_input(graph: CNNGraph, x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC batch, got {tuple(x.shape)}")
    if tuple(x.shape[1:]) != tuple(graph.input_shape):
        raise ValueError(
            f"input shape {tuple(x.shape[1:])} != {graph.input_shape}")


def forward(graph: CNNGraph, x: torch.Tensor,
            params: Optional[Params] = None) -> torch.Tensor:
    """Run the graph on a batched NHWC input ``x`` (topo-order walk) with
    plain PyTorch ops, on ``x``'s device."""
    _check_input(graph, x)
    params = params or {}
    vals: Dict[str, torch.Tensor] = {}
    for layer in graph.layers:
        if isinstance(layer, Input):
            vals[layer.name] = x
        else:
            vals[layer.name] = _apply(
                layer, [vals[n] for n in layer.inputs],
                params.get(layer.name))
    return vals[graph.sink.name]


def forward_kernels(graph: CNNGraph, x: torch.Tensor,
                    params: Optional[Params] = None) -> torch.Tensor:
    """Run the CNN through the port's kernels: every Conv2D (bias and
    relu / leaky_relu fused; a fused softmax runs after it) and every
    valid-padded MaxPool.  On a CUDA tensor these are the hand-written
    Hopper kernels; on a CPU tensor their plain versions.  Expects an
    optimized graph (BN folded, activations fused); DAG merges and the
    other layers run as plain PyTorch ops, as in the reference, and the
    window layers no kernel covers tap by tap (:func:`_window_plain`)."""
    _check_input(graph, x)
    params = params or {}
    vals: Dict[str, torch.Tensor] = {}
    for layer in graph.layers:
        if isinstance(layer, Input):
            vals[layer.name] = x
            continue
        ins = [vals[n] for n in layer.inputs]
        xi = ins[0]
        p = params.get(layer.name)
        if isinstance(layer, Conv2D):
            act = layer.activation if layer.activation != "softmax" else None
            w, b = _weights(layer, xi, p)
            y = ops.conv2d(xi.contiguous(), w, b, strides=layer.strides,
                           padding=layer.padding, act=act, alpha=layer.alpha)
            if layer.activation == "softmax":
                y = torch.softmax(y, dim=-1)
        elif isinstance(layer, MaxPool) and layer.padding == "valid":
            y = ops.maxpool2d(xi.contiguous(), size=layer.size,
                              strides=layer.strides)
        elif isinstance(layer, (Dropout, BatchNorm, Dense, Flatten)):
            raise NotImplementedError(
                f"run passes.optimize first ({type(layer).__name__})")
        elif isinstance(layer, (DepthwiseConv2D, MaxPool, AvgPool)):
            y = _window_plain(layer, xi, p)
        else:
            y = _apply(layer, ins, p)
        vals[layer.name] = y
    return vals[graph.sink.name]


def extract_params(graph: CNNGraph, device="cpu") -> Params:
    """Weights of every Conv2D / DepthwiseConv2D / Dense as contiguous
    float32 tensors on ``device``, keyed by layer name."""
    dev = torch.device(device)
    return {
        layer.name: {
            "w": torch.as_tensor(layer.weights, dtype=torch.float32,
                                 device=dev).contiguous(),
            "b": torch.as_tensor(layer.bias, dtype=torch.float32,
                                 device=dev).contiguous(),
        }
        for layer in graph.layers if isinstance(layer, _WEIGHTED)}


def insert_params(graph: CNNGraph, params: Params) -> CNNGraph:
    """Write weights back into a copy of the graph as numpy arrays."""
    g = graph.copy()
    for layer in g.layers:
        if layer.name in params:
            p = params[layer.name]
            layer.weights = p["w"].detach().cpu().numpy().astype(np.float32)
            layer.bias = p["b"].detach().cpu().numpy().astype(np.float32)
    return g


def forward_with_params(graph: CNNGraph, params: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """Differentiable forward: weights come from ``params`` (autograd
    flows into them), the rest from the graph."""
    return forward(graph, x, params)


def predict(graph: CNNGraph, x: np.ndarray, device=None) -> np.ndarray:
    """numpy in, numpy out, through :func:`forward` on ``device`` (the
    card unless the caller names another)."""
    dev = resolve_device(device)
    use_fp32_convolutions(dev)
    squeeze = x.ndim == 3
    xb = np.asarray(x[None] if squeeze else x, dtype=np.float32)
    with torch.inference_mode():
        y = forward(graph, torch.from_numpy(xb).to(dev),
                    extract_params(graph, dev)).cpu().numpy()
    return y[0] if squeeze else y


class CNNModule(nn.Module):
    """A graph with its weights held as buffers on one device.

    ``kernels=True`` runs :func:`forward_kernels`, else :func:`forward`.
    The graph is fixed at construction; the buffers are what ``.to()``
    and ``state_dict()`` see."""

    def __init__(self, graph: CNNGraph, *, device, kernels: bool = False):
        super().__init__()
        self.graph = graph
        self.kernels = kernels
        self._slots: Dict[str, int] = {}
        for i, (name, p) in enumerate(extract_params(graph, device).items()):
            self.register_buffer(f"w{i}", p["w"])
            self.register_buffer(f"b{i}", p["b"])
            self._slots[name] = i

    def params(self) -> Params:
        return {name: {"w": getattr(self, f"w{i}"),
                       "b": getattr(self, f"b{i}")}
                for name, i in self._slots.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = forward_kernels if self.kernels else forward
        return fn(self.graph, x, self.params())


# ------------------------------------------------------------- int8 ----

def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _zp(qp, device) -> torch.Tensor:
    """A zero point (per-tensor, or per channel on the last axis) as
    float32: the int8 path holds its codes in float32, which represents
    every code, and every difference of codes, exactly."""
    return _f32(qp.zero_point, device)


def quantized_constants(qg, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per layer, the constants :func:`forward_quantized` reads, as
    tensors on ``device``: multipliers and scales in float32 exactly as
    ``qg`` derives them, zero points as float32, weights as float64
    (exact for int8 codes), biases as int32.  ``qg`` is a
    :class:`repro_torch.core.quantize.QuantizedGraph`."""
    g = qg.graph
    sink = g.sink
    smap = g.shape_map()
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer in g.layers:
        k: Dict[str, torch.Tensor] = {}
        if isinstance(layer, Input):
            qp = qg.acts[layer.name]
            k = {"inv": _f32(qp.inv_scale, device), "zp": _zp(qp, device)}
        elif isinstance(layer, _WEIGHTED):
            lq = qg.weights[layer.name]
            w = lq.w_q.astype(np.float64)
            if isinstance(layer, DepthwiseConv2D):  # HWCM -> HWIO, I=1
                w = w.reshape(layer.kh, layer.kw, 1, layer.c_out)
            cin = qg.in_channel_qp(layer)
            k = {"w": torch.as_tensor(w, device=device),
                 "b": torch.as_tensor(lq.b_q.astype(np.int32), device=device),
                 "zp_in": _zp(cin if cin is not None else qg.in_qp(layer),
                              device),
                 "alpha": _f32(getattr(layer, "alpha", 0.0), device)}
            if layer is sink:
                k["m"] = _f32(qg.dequant_scales(layer), device)
            else:
                cq = qg.channel_qp(layer.name)
                k["m"] = _f32(qg.requant_scales(layer), device)
                k["zp"] = _zp(cq if cq is not None else qg.out_qp(layer),
                              device)
        elif isinstance(layer, (AvgPool, GlobalAvgPool)):
            m = qg.pool_scales(layer, smap[layer.inputs[0]])
            if isinstance(layer, AvgPool):
                m = m[None, :, :, None]
            k = {"zp_in": _zp(qg.in_qp(layer), device),
                 "m": _f32(m, device), "zp": _zp(qg.out_qp(layer), device)}
        elif isinstance(layer, (Add, Concat, ReLU, LeakyReLU)):
            k = {"zp": _zp(qg.out_qp(layer), device),
                 "alpha": _f32(getattr(layer, "alpha", 0.0), device)}
            for i in range(len(layer.inputs)):
                k[f"zp_in{i}"] = _zp(qg.in_qp(layer, i), device)
                k[f"r{i}"] = _f32(qg.rescale(layer, i), device)
        elif isinstance(layer, Softmax):
            qp = qg.in_qp(layer)
            k = {"zp_in": _zp(qp, device), "s": _f32(qp.scale, device)}
        if k:
            out[layer.name] = k
    return out


def _codes(t: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """float32 value in output-scale units -> int8 codes, held as
    float32: ``clip(floor(t + 0.5) + zp, -128, 127)``, one op at a
    time.  Equal to the reference's int32 sequence wherever that one is
    defined: below 2**24 the float sum is exact, above it both clip."""
    return torch.clamp(torch.floor(t + 0.5) + zp, -128.0, 127.0)


def _int_acc(acc: torch.Tensor) -> torch.Tensor:
    """A float64 sum of int8-code products -> the exact int32
    accumulator.  Every product is an integer of at most 255 * 127 and
    every partial sum stays far below 2**53, so the float64 sum is exact
    in any order, or off by far less than 0.5 where cuDNN picks a
    Winograd or FFT algorithm; rounding gives the integer."""
    return torch.round(acc).to(torch.int32)


def _q_act(t: torch.Tensor, kind: Optional[str],
           alpha: torch.Tensor) -> torch.Tensor:
    if kind == "relu":
        return torch.where(t > 0, t, 0.0)
    if kind == "leaky_relu":
        return torch.where(t > 0, t, alpha * t)
    return t


def _affine_out(layer, acc: torch.Tensor, k, is_sink: bool):
    """Requantize a weighted layer's int32 accumulator (or dequantize it,
    on the sink) through its float32 multipliers, one op at a time."""
    t = _q_act(acc.to(torch.float32) * k["m"], layer.activation, k["alpha"])
    if is_sink:
        return torch.softmax(t, dim=-1) if layer.activation == "softmax" \
            else t
    return _codes(t, k["zp"])


def forward_quantized(qg, x: torch.Tensor,
                      consts: Optional[Dict[str, Dict[str, torch.Tensor]]]
                      = None) -> torch.Tensor:
    """Int8 reference forward of a
    :class:`repro_torch.core.quantize.QuantizedGraph` on ``x``'s device:
    float32 NHWC in, the dequantized float32 sink out (softmax, when on
    the sink, in float32).  ``consts`` are
    :func:`quantized_constants` on that device (built here if omitted).

    The JAX reference's op order, one op at a time, so nothing contracts
    into an FMA: the input is ``floor(x * inv_scale + 0.5) + zp``
    clipped; a weighted layer's accumulator is exact, computed in
    float64 on ``q - zp`` (``F.conv2d``, ``groups=c_in`` for depthwise;
    ``@`` for Dense, NHWC flattened channel fastest), rounded, cast to
    int32 and added to ``b_q``; then ``float32(acc) * M``, the
    activation, ``floor(t + 0.5) + zp``, clip.  MaxPool is a pure max on
    codes; AvgPool and GlobalAvgPool sum ``q - zp`` and multiply by
    ``pool_scales``; Add, Concat, ReLU and LeakyReLU rescale each input
    edge by ``rescale(layer, idx)``.  The card has no integer
    convolution, so the codes are held in float32 (exact) and the sums
    in float64 (exact) on either device: one code path."""
    g = qg.graph
    _check_input(g, x)
    c = quantized_constants(qg, x.device) if consts is None else consts
    sink = g.sink
    smap = g.shape_map()
    vals: Dict[str, torch.Tensor] = {}
    for layer in g.layers:
        name = layer.name
        k = c.get(name)
        if isinstance(layer, Input):
            vals[name] = _codes(x.to(torch.float32) * k["inv"], k["zp"])
            continue
        ins = [vals[n] for n in layer.inputs]
        q = ins[0]
        in_shape = smap[layer.inputs[0]]
        if isinstance(layer, (Conv2D, DepthwiseConv2D)):
            groups = (layer.c_in if isinstance(layer, DepthwiseConv2D)
                      else 1)
            acc = _conv((q - k["zp_in"]).to(torch.float64), k["w"], None,
                        layer.strides, layer.pad_amounts(in_shape), groups)
            vals[name] = _affine_out(layer, _int_acc(acc) + k["b"], k,
                                     layer is sink)
        elif isinstance(layer, Dense):
            # subtract over channels first, then flatten
            flat = (q - k["zp_in"]).to(torch.float64).reshape(q.shape[0], -1)
            acc = _int_acc(flat @ k["w"]) + k["b"]
            vals[name] = _affine_out(layer, acc.reshape(acc.shape[0], 1, 1,
                                                        -1), k, layer is sink)
        elif isinstance(layer, MaxPool):
            # the same qparams in and out: a pure max on codes; a padded
            # tap never wins (every window holds a valid one)
            vals[name] = _pool(q, layer.size, layer.strides,
                               layer.pad_amounts(in_shape), "max")
        elif isinstance(layer, AvgPool):
            acc = _pool((q - k["zp_in"]).to(torch.float64), layer.size,
                        layer.strides, layer.pad_amounts(in_shape), "sum")
            vals[name] = _codes(acc.to(torch.float32) * k["m"], k["zp"])
        elif isinstance(layer, GlobalAvgPool):
            acc = (q - k["zp_in"]).to(torch.float64).sum(dim=(1, 2),
                                                         keepdim=True)
            vals[name] = _codes(acc.to(torch.float32) * k["m"], k["zp"])
        elif isinstance(layer, Concat):
            vals[name] = torch.cat(
                [_codes((qi - k[f"zp_in{i}"]) * k[f"r{i}"], k["zp"])
                 for i, qi in enumerate(ins)], dim=-1)
        elif isinstance(layer, (Add, ReLU, LeakyReLU)):
            t = (q - k["zp_in0"]) * k["r0"]
            for i in range(1, len(ins)):
                t = t + (ins[i] - k[f"zp_in{i}"]) * k[f"r{i}"]
            kind = ("relu" if isinstance(layer, ReLU) else "leaky_relu"
                    if isinstance(layer, LeakyReLU) else layer.activation)
            vals[name] = _codes(_q_act(t, kind, k["alpha"]), k["zp"])
        elif isinstance(layer, Softmax):
            if layer is not sink:
                raise ValueError("standalone Softmax only supported as sink")
            vals[name] = torch.softmax((q - k["zp_in"]) * k["s"], dim=-1)
        elif isinstance(layer, Dropout):
            vals[name] = q
        elif isinstance(layer, Flatten):
            vals[name] = q.reshape(q.shape[0], 1, 1, -1)
        else:
            raise TypeError(
                f"forward_quantized: unhandled layer {type(layer).__name__}")
    return vals[sink.name]


class QuantizedCNNModule(nn.Module):
    """A quantized graph with its :func:`quantized_constants` held as
    buffers on one device; ``forward`` is :func:`forward_quantized`."""

    def __init__(self, qgraph, *, device):
        super().__init__()
        self.qgraph = qgraph
        self.graph = qgraph.graph
        self._slots: Dict[str, Dict[str, str]] = {}
        for name, k in quantized_constants(qgraph, device).items():
            self._slots[name] = {}
            for key, t in k.items():
                buf = f"q{len(self._buffers)}"
                self.register_buffer(buf, t)
                self._slots[name][key] = buf

    def constants(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: {key: getattr(self, buf) for key, buf in k.items()}
                for name, k in self._slots.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_quantized(self.qgraph, x, self.constants())
