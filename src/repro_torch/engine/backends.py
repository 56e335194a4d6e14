"""Backend registry of the port's inference engine.

One optimized :class:`~repro_torch.core.graph.CNNGraph`, two execution
substrates, counterparts of the JAX package's ``engine/backends.py``:

* ``"torch"`` — plain eager PyTorch (:func:`torch_exec.forward`), the
  counterpart of ``"xla"``;
* ``"cuda"``  — the hand-written Hopper conv2d and maxpool2d kernels
  (:func:`torch_exec.forward_kernels`), the counterpart of ``"pallas"``.

Both hold the graph's weights as buffers of a :class:`CNNModule` on one
device.  ``worker()`` hands each server worker a handle with its own
``torch.cuda.Stream`` over the same weights, so workers' batches can
overlap on the card.
"""
from __future__ import annotations

import abc
import contextlib
import copy
import time
from typing import Dict, List, Type

import numpy as np
import torch

from ..core.graph import CNNGraph
from ..core.torch_exec import CNNModule, resolve_device

_REGISTRY: Dict[str, Type["Backend"]] = {}


def register_backend(name: str):
    """Class decorator: make a backend constructible by name."""

    def deco(cls: Type["Backend"]) -> Type["Backend"]:
        if not (isinstance(cls, type) and issubclass(cls, Backend)):
            raise TypeError(
                f"register_backend({name!r}): {cls!r} must subclass Backend")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str) -> Type["Backend"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


class Backend(abc.ABC):
    """One execution substrate — the engine's serving interface.

    Required: :meth:`predict_batch` maps ``(N, *in_shape)`` float32 to
    ``(N, *out_shape)`` float32 numpy arrays.  Optional overrides:
    :meth:`close`, :meth:`worker`.
    """

    name = "?"

    def __init__(self, graph: CNNGraph):
        self.graph = graph
        self.out_shape = tuple(graph.output_shape)

    @abc.abstractmethod
    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        """``(N, *in_shape)`` float32 -> ``(N, *out_shape)`` float32."""

    def close(self) -> None:
        """Release backend resources. Idempotent; default no-op."""

    def worker(self) -> "Backend":
        """A handle a server worker thread may use concurrently with
        other workers' handles (default: ``self``)."""
        return self


class _ModuleBackend(Backend):
    """A :class:`CNNModule` on one device, run under ``inference_mode``
    on this handle's stream (``None``: the device's current stream)."""

    kernels = False

    def __init__(self, graph: CNNGraph, device=None):
        super().__init__(graph)
        self.device = resolve_device(device)
        self.module = CNNModule(graph, device=self.device,
                                kernels=self.kernels)
        self.stream = None
        self._sync()  # weights are on the card before any worker stream

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def worker(self) -> "_ModuleBackend":
        """A handle over the same weights with its own CUDA stream."""
        handle = copy.copy(self)
        if self.device.type == "cuda":
            handle.stream = torch.cuda.Stream(self.device)
        return handle

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        with torch.inference_mode(), self._on_stream():
            y = self.module(torch.from_numpy(x).to(self.device))
            out = y.cpu().numpy()  # waits for this stream's work
        return out.reshape((x.shape[0],) + self.out_shape)

    def time_per_call_us(self, x: np.ndarray, iters: int = 500,
                         warmup: int = 20) -> float:
        """Single-image device time per forward, in µs: the input is on
        the device before the clock starts, and the clock stops after a
        synchronize."""
        with torch.inference_mode(), self._on_stream():
            xb = torch.from_numpy(
                np.ascontiguousarray(x[None], dtype=np.float32)
            ).to(self.device)
            for _ in range(warmup):
                self.module(xb)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                self.module(xb)
            self._sync()
            return (time.perf_counter() - t0) / iters * 1e6


@register_backend("torch")
class TorchBackend(_ModuleBackend):
    """Plain eager PyTorch: the reference the kernels are held to."""


@register_backend("cuda")
class CudaBackend(_ModuleBackend):
    """The deployment path through the hand-written Hopper kernels.
    Requires an optimized graph — BN folded, activations fused, no
    Dense/Flatten."""

    kernels = True
