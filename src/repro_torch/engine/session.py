"""The port's inference entry point: one session over a registered
backend (the fp32 part of the JAX package's ``engine/session.py``).

    sess = InferenceSession(graph, config=SessionConfig(backend="cuda"))
    probs = sess.predict(batch)          # (N, *out_shape), on cuda:0

The session runs the NNCG passes, builds the backend on its device and
executes batches.  The C code generator's pipeline (ISA selection,
autotuning, codegen) is the paper's CPU artifact and has no counterpart
here, so channel alignment uses a fixed multiple of 4; padding channels
with zero filters does not change the numbers.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..core import passes
from ..core.graph import CNNGraph
from ..core.torch_exec import resolve_device
from .backends import Backend, get_backend
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
        self.graph = (passes.optimize(graph, simd_multiple=SIMD_MULTIPLE)
                      if config.optimize else graph)
        self._backend: Backend = get_backend(config.backend)(
            self.graph, self.device)

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
        return dict(
            backend=self.backend_name, precision=self.precision,
            device=str(self.device), simd_multiple=SIMD_MULTIPLE,
            input_shape=tuple(self.input_shape),
            output_shape=tuple(self.output_shape),
            config=self.config.to_dict())
