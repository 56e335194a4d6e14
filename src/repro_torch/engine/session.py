"""The port's inference entry point: one session over a registered
backend (the JAX package's ``engine/session.py`` without the C code
generator's pipeline).

    sess = InferenceSession(graph, config=SessionConfig(backend="cuda"))
    probs = sess.predict(batch)          # (N, *out_shape), on cuda:0

Post-training int8 is one more config field, on the ``"torch"`` backend:

    sess = InferenceSession(graph, config=SessionConfig(
        backend="torch", precision="int8",
        calibration=CalibrationConfig(data=sample_batch)))

The session runs the NNCG passes, calibrates and quantizes at int8,
builds the backend on its device and executes batches.  The C code
generator's pipeline (ISA selection, autotuning, codegen) is the paper's
CPU artifact and has no counterpart here, so fp32 channel alignment uses
a fixed multiple of 4 (padding channels with zero filters does not
change the numbers); int8 aligns to 1, as the JAX session does, so the
graph and its quantization equal the JAX session's.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..core import passes
from ..core import quantize as quantize_mod
from ..core.graph import CNNGraph
from ..core.torch_exec import resolve_device
from ..data.pipeline import camera_frame_batch
from .backends import Backend, QuantizedTorchBackend, get_backend
from .config import SessionConfig

SIMD_MULTIPLE = 4


class InferenceSession:
    """Build once, predict many — over any registered backend.

    ``graph`` is a trained port :class:`CNNGraph` (raw; the passes run
    here unless ``config.optimize=False``).  ``config`` is a
    :class:`SessionConfig` or a dict of its fields; ``None`` is the
    default config (``backend="cuda"`` on ``cuda:0``).
    """

    def __init__(self, graph: CNNGraph, *,
                 config: Union[SessionConfig, dict, None] = None):
        if config is None:
            config = SessionConfig()
        elif isinstance(config, dict):
            config = SessionConfig(**config)
        if config.lm is not None:
            raise TypeError(
                "SessionConfig.lm is an LM workload: construct "
                "repro_torch.engine.LMSession(config=cfg) instead of "
                "InferenceSession (which serves CNN graphs)")
        self.config = config
        self.backend_name = config.backend
        self.precision = config.precision
        self.device = resolve_device(config.device)
        # int8 quantizes whole channels: alignment would only add dead ones
        self.simd_multiple = (1 if config.precision == "int8"
                              else SIMD_MULTIPLE)
        self.graph = (passes.optimize(graph, simd_multiple=self.simd_multiple)
                      if config.optimize else graph)
        self.qgraph = None
        if config.precision == "int8":
            self._init_int8()
        else:
            self._backend: Backend = get_backend(config.backend)(
                self.graph, self.device)

    def _init_int8(self) -> None:
        """Calibrate (on this session's device) or take the provided
        qparams, quantize, and build the int8 backend: the int8 reference
        on the ``"torch"`` backend.  The kernel path has no int8 kernels,
        so any other backend raises, as the JAX session refuses
        ``"pallas"``."""
        cfg = self.config
        if cfg.backend != "torch":
            raise ValueError(
                f"precision='int8' supports backend 'torch', "
                f"not {cfg.backend!r}")
        cal = cfg.calibration
        if cal.qparams is not None:
            # externally-determined (e.g. QAT-exported) scales and
            # zero-points: no calibration pass at all
            self.qgraph = quantize_mod.quantize_from_qparams(
                self.graph, cal.qparams)
        else:
            data = cal.data
            method = cal.resolved_method(data_provided=data is not None)
            if data is None:
                data = self._default_calibration()
            self.qgraph = quantize_mod.quantize(
                self.graph, data, method=method, percentile=cal.percentile,
                per_channel=cal.per_channel, device=self.device)
        self._backend = QuantizedTorchBackend(self.qgraph, self.device)

    def _default_calibration(self) -> np.ndarray:
        """Representative frames for int8 calibration when the caller
        supplies none: camera-like frames for image inputs (ranges
        calibrated on unbounded noise cost the robot net its top-1
        agreement), bounded uniform noise otherwise."""
        in_shape = tuple(self.graph.input_shape)
        n = self.config.calibration.samples
        if len(in_shape) == 3:
            return camera_frame_batch(n, in_shape, seed=0)
        return np.random.default_rng(0).uniform(
            -1.0, 1.0, size=(n,) + in_shape).astype(np.float32)

    @property
    def input_shape(self):
        return self.graph.input_shape

    @property
    def output_shape(self):
        return self.graph.output_shape

    @property
    def backend(self) -> Backend:
        """The live :class:`Backend` this session serves through."""
        return self._backend

    def close(self) -> None:
        self._backend.close()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Single image ``(*in_shape)`` -> ``(*out_shape)``, or batch
        ``(N, *in_shape)`` -> ``(N, *out_shape)``."""
        x = np.asarray(x, dtype=np.float32)
        in_shape = tuple(self.input_shape)
        if x.shape == in_shape:
            return self._backend.predict_batch(x[None])[0]
        if x.shape[1:] == in_shape:
            return self._backend.predict_batch(x)
        raise ValueError(
            f"predict: expected {in_shape} or (N,)+{in_shape}, "
            f"got {x.shape}")

    def benchmark(self, x: Optional[np.ndarray] = None, *,
                  iters: int = 500, warmup: int = 20) -> float:
        """Single-image latency of this session's backend in µs/call; a
        batch is sliced to its first image."""
        if x is None:
            x = np.random.default_rng(0).normal(
                size=self.input_shape).astype(np.float32)
        x = np.asarray(x, np.float32)
        in_shape = tuple(self.input_shape)
        if x.shape != in_shape:
            if x.ndim == len(in_shape) + 1 and x.shape[1:] == in_shape:
                x = x[0]
            else:
                raise ValueError(
                    f"benchmark times one image of {in_shape}, "
                    f"got {x.shape}")
        return self._backend.time_per_call_us(x, iters=iters, warmup=warmup)

    @property
    def info(self) -> dict:
        d = dict(
            backend=self.backend_name, precision=self.precision,
            device=str(self.device), simd_multiple=self.simd_multiple,
            input_shape=tuple(self.input_shape),
            output_shape=tuple(self.output_shape),
            config=self.config.to_dict())
        if self.qgraph is not None:
            d["quantized_layers"] = sorted(self.qgraph.weights)
            d["input_qparams"] = (self.qgraph.input_qp.scale,
                                  self.qgraph.input_qp.zero_point)
            d["calibration_method"] = self.qgraph.method
            if self.qgraph.method == "percentile":
                d["calibration_percentile"] = self.qgraph.percentile
        return d
