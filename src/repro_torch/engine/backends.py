"""Backend registry of the port's inference engine, counterparts of the
JAX package's ``engine/backends.py``.

One optimized :class:`~repro_torch.core.graph.CNNGraph`, three execution
substrates:

* ``"c"``     — the paper's artifact: NNCG-generated ANSI C
  (:mod:`repro_torch.core.codegen`), compiled with the host ``cc`` and
  loaded through ctypes (:mod:`repro_torch.core.runtime`); it runs on the
  host and launches nothing on the card;
* ``"torch"`` — plain eager PyTorch (:func:`torch_exec.forward`), the
  counterpart of ``"xla"``;
* ``"cuda"``  — the hand-written Hopper conv2d and maxpool2d kernels
  (:func:`torch_exec.forward_kernels`), the counterpart of ``"pallas"``.

The last two hold the graph's weights as buffers of a :class:`CNNModule`
on one device.  At ``precision="int8"`` the session builds
:class:`QuantizedTorchBackend` (``"torch-int8"``, the counterpart of
``"xla-int8"``; not in the registry, since it needs the calibrated
quantized graph): the int8 reference
(:func:`torch_exec.forward_quantized`) over a
:class:`QuantizedCNNModule`; ``"c"`` builds int8 C from the same
quantized graph.  ``worker()`` hands each server worker a handle with its
own ``torch.cuda.Stream`` over the same weights, so workers' batches can
overlap on the card; on ``"c"``, a handle with its own C arena.

And the LM workload: ``"cuda-lm"`` (:class:`CudaLMBackend`, the
counterpart of ``"pallas-lm"``) runs the LM stack of
:mod:`repro_torch.models` with prefill through the hand-written
flash-attention and linear-scan kernels, behind the
:class:`LMBackend` contract (prefill / decode / generate /
predict_batch / describe over a :class:`KVCacheHandle`).  On the card
its decode step is captured once per handle as a CUDA graph and
replayed, where the JAX backend runs its jitted step.
"""
from __future__ import annotations

import abc
import contextlib
import copy
import ctypes
import threading
import time
from dataclasses import replace
from typing import Dict, List, Optional, Type

import numpy as np
import torch

from ..core import cgen, runtime
from ..core.graph import CNNGraph
from ..models import lm as lm_mod
from ..models.kernel_policy import DEFAULT_KERNELS, KernelPolicy
from ..models.stack import init_params
from ..core.torch_exec import (CNNModule, QuantizedCNNModule,
                               resolve_device, use_fp32_convolutions)

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
    :meth:`describe`, :meth:`close`, :meth:`worker`.  A backend is a
    context manager that closes itself on exit.
    """

    name = "?"
    precision = "fp32"
    workload = "cnn"

    def __init__(self, graph: CNNGraph):
        self.graph = graph
        self.out_shape = tuple(graph.output_shape)

    @abc.abstractmethod
    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        """``(N, *in_shape)`` float32 -> ``(N, *out_shape)`` float32."""

    def describe(self) -> dict:
        """Stable facts about this backend (extended by subclasses)."""
        return {
            "name": self.name,
            "precision": self.precision,
            "input_shape": tuple(self.graph.input_shape),
            "output_shape": tuple(self.out_shape),
        }

    def close(self) -> None:
        """Release backend resources. Idempotent; default no-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def worker(self) -> "Backend":
        """A handle a server worker thread may use concurrently with
        other workers' handles (default: ``self``)."""
        return self


class _CArenaWorker(Backend):
    """A per-thread handle on a compiled net: one warm liveness-planned
    workspace, driven through the reentrant ``<func>_ws`` entry.  Many
    of these can run concurrently against the same ``.so`` — ctypes
    releases the GIL during the call."""

    name = "c-worker"

    def __init__(self, parent: "CBackend"):
        super().__init__(parent.graph)
        self.name = parent.name + "-worker"
        self.precision = parent.precision
        self._net = parent.net
        self._ws = self._net._alloc_workspace()
        self._wp = self._ws.ctypes.data_as(
            ctypes.POINTER(self._net._ws_ctype))

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        net = self._net
        x = np.ascontiguousarray(x, dtype=np.float32)
        n = x.size // net.in_size
        if net._stage_fns and n > 1:
            # layer-pipelined build: stream the batch stage-overlapped
            # (the runner allocates its own buffers — reentrant across
            # concurrent server workers)
            return net.predict_batch(x).reshape((n,) + self.out_shape)
        out = np.empty(n * net.out_size, dtype=np.float32)
        FLOATP = ctypes.POINTER(ctypes.c_float)
        if net._batch_ws_fn is not None:
            # the whole batch in one GIL-releasing foreign call
            net._batch_ws_fn(x.ctypes.data_as(FLOATP),
                             out.ctypes.data_as(FLOATP),
                             ctypes.c_int(n), self._wp)
            return out.reshape((n,) + self.out_shape)
        xf = x.reshape(-1)
        for b in range(n):
            xi = xf[b * net.in_size:(b + 1) * net.in_size]
            oi = out[b * net.out_size:(b + 1) * net.out_size]
            net._ws_fn(xi.ctypes.data_as(FLOATP),
                       oi.ctypes.data_as(FLOATP), self._wp)
        return out.reshape((n,) + self.out_shape)


@register_backend("c")
class CBackend(Backend):
    """NNCG: graph -> C -> cc -> ctypes. Batches run through the
    generated ``<func>_batch`` loop wrapper, or — with ``threads>1`` —
    thread-parallel over the reentrant ``<func>_ws`` workspace entry
    (each thread owns one liveness-planned arena).

    Passing ``qgraph`` (a calibrated
    :class:`repro_torch.core.quantize.QuantizedGraph`) selects the int8
    codegen path: int8 weights/intermediates, int32 accumulators, a
    byte-planned arena, float32 in/out — same serving interface."""

    def __init__(self, graph: CNNGraph, *, simd: str = "sse",
                 unroll=0, func_name: str = "nncg_net",
                 term_budget: Optional[int] = None,
                 threads: Optional[int] = None,
                 qgraph=None, schedule=None):
        super().__init__(graph)
        kw = {} if term_budget is None else {"term_budget": term_budget}
        self.opts = cgen.CodegenOptions(simd=simd, unroll=unroll,
                                        func_name=func_name, **kw)
        self.threads = threads
        self.qgraph = qgraph
        self.schedule = schedule
        if qgraph is not None:
            self.precision = "int8"
            self.net = runtime.build_quantized(qgraph, self.opts,
                                               schedule=schedule)
        else:
            self.net = runtime.build(graph, self.opts, schedule=schedule)
        if self.net.simd != self.opts.simd:
            # the runtime CPU-feature guard demoted the requested
            # variant; report what actually runs
            self.opts = replace(self.opts, simd=self.net.simd)

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        out = self.net.predict_batch(x, threads=self.threads)
        return out.reshape((n,) + self.out_shape)

    def describe(self) -> dict:
        d = super().describe()
        d.update(simd=self.opts.simd, threads=self.threads,
                 so_path=self.net.so_path,
                 c_source_bytes=self.net.c_source_bytes,
                 arena_bytes=self.net.arena_bytes,
                 arena_buffer_sum_bytes=self.net.arena_buffer_sum_bytes,
                 per_layer_live_bytes=dict(
                     self.net.per_layer_live_bytes or {}),
                 pipeline_stages=self.net.nstages,
                 schedule_digest=self.net.schedule_digest)
        return d

    def worker(self) -> Backend:
        if self.net._ws_fn is None:  # pre-arena .so: not reentrant
            return self
        return _CArenaWorker(self)

    def time_per_call_us(self, x: np.ndarray, iters: int = 500,
                         warmup: int = 20) -> float:
        # ctypes-level loop: excludes Python dispatch, like the paper's
        # in-process measurement. One image only — a batch here would
        # silently time just its first image.
        assert x.size == self.net.in_size, (
            f"time_per_call_us expects one image of {self.graph.input_shape}, "
            f"got {x.shape}")
        return self.net.time_per_call_us(x, iters=iters, warmup=warmup)


class _ModuleBackend(Backend):
    """A :class:`CNNModule` on one device, run under ``inference_mode``
    on this handle's stream (``None``: the device's current stream)."""

    kernels = False

    def __init__(self, graph: CNNGraph, device=None):
        super().__init__(graph)
        self.device = resolve_device(device)
        self.module = self._make_module()
        self.stream = None
        self._sync()  # weights are on the card before any worker stream

    def _make_module(self) -> torch.nn.Module:
        return CNNModule(self.graph, device=self.device, kernels=self.kernels)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def describe(self) -> dict:
        return {**super().describe(), "device": str(self.device),
                "kernels": self.kernels}

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
    """Plain eager PyTorch: the reference the kernels are held to.

    On a CUDA device it computes its convolutions in full fp32: building
    it sets ``torch.backends.cudnn.allow_tf32 = False`` for the whole
    process (:func:`~repro_torch.core.torch_exec.use_fp32_convolutions`),
    since cuDNN's default runs fp32 convolutions in TF32."""

    def __init__(self, graph: CNNGraph, device=None):
        use_fp32_convolutions(resolve_device(device))
        super().__init__(graph, device)


@register_backend("cuda")
class CudaBackend(_ModuleBackend):
    """The deployment path through the hand-written Hopper kernels.
    Requires an optimized graph — BN folded, activations fused, no
    Dense/Flatten."""

    kernels = True


class QuantizedTorchBackend(_ModuleBackend):
    """The int8 reference (:func:`torch_exec.forward_quantized`) on one
    device, the counterpart of the JAX package's ``QuantizedXLABackend``.
    Constructed by the session at ``precision="int8"`` (not in the
    registry: it needs the calibrated quantized graph, not just a
    graph).  Launches none of the hand-written kernels: the accumulators
    are float64 library products, exact for int8 codes.

    Building it on a CUDA device switches cuDNN's TF32 off for the
    process, as :class:`TorchBackend` does: every float convolution of
    the process, a later calibration's included, then runs in fp32."""

    name = "torch-int8"
    precision = "int8"

    def __init__(self, qgraph, device=None):
        self.qgraph = qgraph
        use_fp32_convolutions(resolve_device(device))
        super().__init__(qgraph.graph, device)

    def _make_module(self) -> torch.nn.Module:
        return QuantizedCNNModule(self.qgraph, device=self.device)


# =========================================================== LM workload ====

class KVCacheHandle:
    """An opaque decode-state handle: the per-layer KV/recurrence caches
    plus the next write position.  Returned by :meth:`LMBackend.prefill`,
    advanced in place by :meth:`LMBackend.decode`.

    On the card a :class:`CudaLMBackend` handle also owns its decode
    step's CUDA graph (``graph``) and the graph's static buffers
    (``static``: the tokens, the device position, the logits); ``pos``
    stays the host's count."""

    __slots__ = ("caches", "pos", "batch", "graph", "static")

    def __init__(self, caches, pos: int, batch: int):
        self.caches = caches
        self.pos = pos
        self.batch = batch
        self.graph = None
        self.static = None

    def __repr__(self):
        return f"KVCacheHandle(batch={self.batch}, pos={self.pos})"


class LMBackend(Backend):
    """The LM execution contract: explicit prefill/decode steps over a
    :class:`KVCacheHandle`, a greedy :meth:`generate` loop, and
    ``predict_batch`` mapping int32 token ids ``(N, T)`` to full-sequence
    float32 logits ``(N, T, V)``.  An LM backend has no CNN graph."""

    workload = "lm"
    graph = None

    def __init__(self):  # no graph: Backend.__init__ reads its shapes
        pass

    @abc.abstractmethod
    def prefill(self, tokens: np.ndarray):
        """``(B, T)`` int32 prompts -> ``(last_logits (B, V),
        KVCacheHandle)``."""

    @abc.abstractmethod
    def decode(self, handle: KVCacheHandle, tokens: np.ndarray) -> np.ndarray:
        """One step: ``(B,)`` int32 tokens against ``handle`` ->
        ``(B, V)`` logits.  Advances the handle in place."""

    @abc.abstractmethod
    def describe(self) -> dict:
        """A JSON-safe dict of what this backend is."""

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Greedy decode: ``(B, T)`` int32 -> ``(B, max_new)`` int32."""
        prompts = np.asarray(prompts, np.int32)
        if max_new < 1:
            return np.zeros((prompts.shape[0], 0), np.int32)
        logits, handle = self.prefill(prompts)
        tok = np.argmax(logits, axis=-1).astype(np.int32)
        out = [tok]
        for _ in range(max_new - 1):
            logits = self.decode(handle, tok)
            tok = np.argmax(logits, axis=-1).astype(np.int32)
            out.append(tok)
        return np.stack(out, axis=1)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree if tree.device == torch.device(device) else tree.to(device)


@register_backend("cuda-lm")
class CudaLMBackend(LMBackend):
    """The LM stack (:mod:`repro_torch.models`) on one device, prefill
    through the :class:`~repro_torch.models.kernel_policy.KernelPolicy`'s
    attention and scan (by default the hand-written flash-attention and
    linear-scan kernels), decode through plain torch, under
    ``inference_mode``; constructed by
    :class:`repro_torch.engine.LMSession`.

    On a CUDA device every call runs on the backend's own stream, one
    call at a time (a lock: a capture on that stream must see no other
    thread's work), and decode is a CUDA graph, one per handle.  A
    handle's first decode runs eagerly on its static buffers: the
    warm-up, and the real step.  The second captures the step (with the
    device position) into the handle's graph from the backend's one
    memory pool, then replays it; every later step copies the tokens in
    and replays.  The graph reads and writes the handle's caches in
    place and advances the device position; the logits reach the host
    before the next replay.  A capture that fails raises: there is no
    eager fallback.  On the CPU decode stays eager.

    With ``par`` (a :class:`~repro_torch.launch.sharding.MeshPar`) the
    weights are DTensors placed by its rule tables and every step runs
    through it: each rank computes the split dense layers on its blocks
    and holds its block of the caches.  On the card its collectives are
    NCCL's, issued on the backend's stream, the communicators' first ones
    eagerly here, before any capture, so a captured decode step holds its
    collectives (an all-reduce over ``model`` a split block)."""

    def __init__(self, model_cfg, *, params=None, max_context: int = 128,
                 decode_batch: int = 1, policy=None, seed: int = 0,
                 device=None, par=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.max_context = int(max_context)
        self.decode_batch = int(decode_batch)
        self.policy = KernelPolicy(*(policy or DEFAULT_KERNELS)).validate()
        if params is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            params = init_params(model_cfg, gen, self.device)
        self.par = par
        self.params = _tree_to(params, self.device)
        if par is not None:
            self.params = par.place_params(self.params)
        self._prefill_fn = lm_mod.make_prefill_step(
            model_cfg, max_len=self.max_context, kernels=self.policy, par=par)
        self._decode_fn = (None if model_cfg.is_encoder
                           else lm_mod.make_decode_step(model_cfg, self.policy,
                                                        par=par))
        self._lock = threading.Lock()
        self._stream = self._pool = self._pool_keeper = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            # a one-node graph in the pool for the backend's lifetime: a
            # pool whose graphs have all been freed (every handle gone)
            # takes no further capture
            self._pool_keeper = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                self._capture(self._pool_keeper, lambda: torch.zeros(
                    (), device=self.device))
                if par is not None:  # each axis's communicator, eagerly
                    par.warm_up(self.device)
            torch.cuda.synchronize(self.device)

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)

    @contextlib.contextmanager
    def _running(self):
        """One call at a time, under ``inference_mode``, on the backend's
        stream (after the work the caller's stream holds, such as the
        weights' initialization)."""
        with self._lock, torch.inference_mode():
            if self._stream is None:
                yield
                return
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                yield

    def _capture(self, graph, fn):
        """Capture ``fn()`` into ``graph`` from the backend's pool on the
        current stream (the backend's): ``capture_begin`` without
        ``torch.cuda.graph``'s device-wide synchronize, ``gc.collect``
        and ``empty_cache``, which every new handle would pay; thread-
        local, since server workers launch from other threads."""
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        try:
            return fn()
        finally:
            graph.capture_end()

    def _graph_step(self, handle: KVCacheHandle) -> torch.Tensor:
        """The decode step on the handle's static tokens and device
        position, which it advances; returns the logits."""
        st = handle.static
        logits, _, nxt = self._decode_fn(self.params, handle.caches,
                                         st["tokens"], st["pos"])
        st["pos"].copy_(nxt)
        return logits

    def _decode_graphed(self, handle: KVCacheHandle,
                        tokens: np.ndarray) -> torch.Tensor:
        st = handle.static
        if st is None:  # the first step, eager: the warm-up
            handle.static = {"tokens": self._tokens(tokens),
                             "pos": torch.full((), handle.pos,
                                               dtype=torch.int64,
                                               device=self.device)}
            return self._graph_step(handle)
        st["tokens"].copy_(torch.from_numpy(np.asarray(tokens, np.int64)))
        if handle.graph is None:  # the second: capture once, then replay
            graph = torch.cuda.CUDAGraph()
            st["logits"] = self._capture(graph,
                                         lambda: self._graph_step(handle))
            handle.graph = graph
        handle.graph.replay()
        return st["logits"]

    # ----------------------------------------------------- LM contract --
    def prefill(self, tokens: np.ndarray):
        tokens = np.asarray(tokens, np.int32)
        b, t = tokens.shape
        if t > self.max_context:
            raise ValueError(
                f"prompt length {t} > max_context {self.max_context}")
        with self._running():
            logits, caches, pos = self._prefill_fn(
                self.params, {"tokens": self._tokens(tokens)})
            out = logits.cpu().numpy()
        return out, KVCacheHandle(caches, pos, batch=b)

    def decode(self, handle: KVCacheHandle, tokens: np.ndarray) -> np.ndarray:
        if self._decode_fn is None:
            raise ValueError(
                f"{self.model_cfg.name} is encoder-only: no decode step")
        if handle.pos >= self.max_context:
            raise ValueError(
                f"position {handle.pos} is past max_context "
                f"{self.max_context}")
        tokens = np.asarray(tokens, np.int32).reshape(handle.batch, 1)
        with self._running():
            if self._stream is None:
                logits, handle.caches, handle.pos = self._decode_fn(
                    self.params, handle.caches, self._tokens(tokens),
                    handle.pos)
                return logits.cpu().numpy()
            out = self._decode_graphed(handle, tokens).cpu().numpy()
            handle.pos += 1
            return out

    # ------------------------------------------------- shared contract --
    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        with self._running():
            tokens = self._tokens(x)
            if self.par is None:
                return lm_mod.forward(self.params, self.model_cfg,
                                      {"tokens": tokens},
                                      self.policy).cpu().numpy()
            logits = lm_mod.forward(self.params, self.model_cfg,
                                    self.par.local_batch({"tokens": tokens}),
                                    self.policy, par=self.par)
            return self.par.gather_batch(logits, tokens.shape[0]
                                         ).cpu().numpy()

    def describe(self) -> dict:
        return {
            "name": self.name,
            "workload": self.workload,
            "arch": self.model_cfg.name,
            "dtype": self.model_cfg.dtype,
            "device": str(self.device),
            "vocab_size": self.model_cfg.vocab_size,
            "max_context": self.max_context,
            "decode_batch": self.decode_batch,
            "kernel_policy": dict(self.policy._asdict()),
            "decode": "cuda_graph" if self._stream is not None else "eager",
            "n_params": lm_mod.param_count(self.model_cfg),
            "mesh": None if self.par is None else self.par.describe()["mesh"],
        }
