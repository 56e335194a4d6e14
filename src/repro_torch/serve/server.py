"""Continuous-batching inference server over an :class:`InferenceSession`
(the port's copy of the JAX package's ``serve/server.py``).

The engine predicts; this module *serves*.  Architecture::

    submit(frame) ──► bounded queue ──► worker 0 ─┐
                      (backpressure)   worker 1 ─┼─► Backend.worker()
                                       ...       │   handles (one CUDA
                                                 ┘   stream or C arena
                                                     each)

* **Bounded request queue** — ``submit()`` on a full queue raises
  :class:`ServerOverloaded` immediately (backpressure, never a hang);
  after :meth:`InferenceServer.close` it raises :class:`ServerClosed`.
* **Dynamic batch aggregation** — a worker takes the oldest request,
  then keeps gathering until the batch hits ``max_batch`` *or* the
  oldest request's age reaches the ``batch_deadline_ms`` latency SLO,
  whichever comes first.  Workers batch independently: request A can
  be executing while request B is still aggregating (continuous
  batching, no global barrier).
* **Worker pool** — each worker thread asks the session's backend for
  a :meth:`~repro_torch.engine.backends.Backend.worker` handle: the same
  weights on the card with a CUDA stream of its own, so one worker's
  batch can run on the card while another gathers or copies; on the
  ``"c"`` backend the same ``.so`` with a C arena of its own, driven
  through the reentrant ``<func>_batch_ws`` entry (ctypes releases the
  GIL, so workers run on separate cores).
* **Per-request timeout** — a request that waited longer than
  ``request_timeout_ms`` in the queue fails with
  :class:`RequestTimeout` instead of wasting a batch slot.
* **Graceful shutdown** — ``close(drain=True)`` stops intake, lets the
  workers drain every queued request, then joins them; ``drain=False``
  fails queued requests with :class:`ServerClosed`.
* **Observability** — per-request stage timestamps on the returned
  :class:`InferenceResult`, and rolling p50/p99 latency, queue depth,
  batch occupancy, QPS and rejection counters via :meth:`stats`.  For
  where an LM batch's time goes, turn on the span recorder,
  :mod:`repro_torch.spans` (``spans.enable()``, serve,
  ``spans.disable()``, ``spans.drain()``): on the worker thread, each
  batch's ``lm.generate``, and under it the ``"cuda-lm"`` backend's
  prefill, decode steps (eager, capture or replay), graph launches,
  logits copies and MoE layers.  It is off by default.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np

from ..engine.backends import Backend, LMBackend
from ..engine.lm import LMSession
from ..engine.session import InferenceSession

from .stats import ServerStats


class ServeError(RuntimeError):
    """Base class for serving failures."""


class ServerOverloaded(ServeError):
    """Bounded queue is full — backpressure; retry later or shed load."""


class ServerClosed(ServeError):
    """The server is shutting down (or closed) and rejects new work."""


class RequestTimeout(ServeError):
    """The request exceeded ``request_timeout_ms`` before execution."""


@dataclass(frozen=True)
class ServerConfig:
    """Serving knobs (the session's build knobs live in
    :class:`repro_torch.engine.SessionConfig`).

    ``batch_deadline_ms`` is the aggregation SLO: a batch closes when
    its *oldest* request has waited this long, even at occupancy 1 —
    the knob trades batch efficiency against queueing latency.
    ``request_timeout_ms=None`` disables the per-request timeout.
    """

    workers: int = 2
    max_batch: int = 8
    max_queue: int = 256
    batch_deadline_ms: float = 2.0
    request_timeout_ms: Optional[float] = 1000.0
    stats_window: int = 2048
    warmup: bool = True

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers {self.workers} < 1")
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} < 1")
        if self.max_queue < 1:
            raise ValueError(f"max_queue {self.max_queue} < 1")
        if self.batch_deadline_ms < 0:
            raise ValueError(
                f"batch_deadline_ms {self.batch_deadline_ms} < 0")


class InferenceResult:
    """Future for one submitted frame.

    ``result()`` blocks for the output (re-raising the server-side
    failure, e.g. :class:`RequestTimeout`); ``timestamps`` carries the
    per-stage ``perf_counter`` stamps (``submit``, ``dequeue``,
    ``exec_start``, ``done``) once complete, plus the batch size the
    request rode in — the raw material for any latency breakdown.

    Completion signalling rides one server-wide condition variable
    (a per-request ``threading.Event`` costs ~3µs to allocate and a
    wakeup to set — at tens of kQPS that is real throughput; one
    ``notify_all`` per *batch* is ~free)."""

    __slots__ = ("x", "_cond", "_done", "_value", "_error", "timestamps",
                 "batch_size")

    def __init__(self, x: np.ndarray, cond: threading.Condition):
        self.x = x
        self._cond = cond
        self._done = False
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.timestamps: Dict[str, float] = {"submit": time.perf_counter()}
        self.batch_size: Optional[int] = None

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done:
            with self._cond:
                if not self._cond.wait_for(lambda: self._done, timeout):
                    raise TimeoutError(
                        "result() timed out waiting for the server")
        if self._error is not None:
            raise self._error
        return self._value

    # server side: set the payload, then publish under the condition —
    # callers go through InferenceServer._finish/_finish_many
    def _set(self, value: Optional[np.ndarray],
             error: Optional[BaseException] = None,
             done_at: Optional[float] = None) -> None:
        self._value = value
        self._error = error
        self.timestamps["done"] = (time.perf_counter()
                                   if done_at is None else done_at)


class InferenceServer:
    """Continuous-batching server over a session (or bare backend).

    >>> sess = InferenceSession(graph, config=SessionConfig(backend="cuda"))
    >>> with InferenceServer(sess, config=ServerConfig(workers=4)) as srv:
    ...     y = srv.predict(frame)            # sync convenience
    ...     handle = srv.submit(frame)        # async
    ...     y2 = handle.result(timeout=1.0)
    ...     print(srv.stats()["latency_p99_us"])
    """

    def __init__(self, session: Union[InferenceSession, Backend], *,
                 config: Optional[ServerConfig] = None, **kw):
        if config is None:
            config = ServerConfig(**kw)
        elif kw:
            raise TypeError(
                "InferenceServer: pass either config= or kwargs, not both")
        self.config = config
        self._backend = (session.backend
                         if isinstance(session, InferenceSession)
                         else session)
        self.session = (session if isinstance(session, InferenceSession)
                        else None)
        graph = self._backend.graph
        self.in_shape = (tuple(graph.input_shape) if graph is not None
                         else None)  # LM backends: token-level, no frame
        self._queue: "queue.Queue[InferenceResult]" = queue.Queue(
            maxsize=config.max_queue)
        self.stats_ = ServerStats(window=config.stats_window)
        self._cond = threading.Condition()   # completion signalling
        self._closing = threading.Event()
        self._drain = True
        self._workers = [
            threading.Thread(target=self._worker_loop, name=f"serve-w{i}",
                             daemon=True)
            for i in range(config.workers)]
        for t in self._workers:
            t.start()

    # -- client side ---------------------------------------------------------

    def submit(self, x: np.ndarray) -> InferenceResult:
        """Enqueue one frame ``(*in_shape)``; returns a future.

        Raises :class:`ServerClosed` after shutdown began and
        :class:`ServerOverloaded` when the bounded queue is full — both
        immediately, never blocking the caller.
        """
        if self._closing.is_set():
            self.stats_.on_reject(closed=True)
            raise ServerClosed("server is shut down")
        x = np.ascontiguousarray(x, dtype=np.float32)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(
                f"submit expects one frame of {self.in_shape}, "
                f"got {x.shape}")
        return self._enqueue(InferenceResult(x, self._cond))

    def _enqueue(self, req: InferenceResult) -> InferenceResult:
        """Bounded-queue admission shared by every request flavor."""
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.stats_.on_reject(closed=False)
            raise ServerOverloaded(
                f"request queue full ({self.config.max_queue}); "
                f"retry later") from None
        self.stats_.on_submit()
        return req

    def predict(self, x: np.ndarray,
                timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous submit + wait."""
        return self.submit(x).result(timeout)

    def stats(self) -> Dict[str, float]:
        """Rolling counters/percentiles; see :class:`ServerStats`."""
        d = self.stats_.snapshot()
        d["queue_depth"] = self._queue.qsize()
        d["workers"] = self.config.workers
        d["max_batch"] = self.config.max_batch
        if d["batches"]:
            d["batch_occupancy"] = (d["batch_size_mean"]
                                    / self.config.max_batch)
        return d

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop intake; with ``drain`` finish queued work, else fail it
        with :class:`ServerClosed`.  Idempotent."""
        self._drain = drain
        self._closing.set()
        if not drain:
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._finish(req, None, ServerClosed("server closed"))
        for t in self._workers:
            t.join(timeout)
        self._backend.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- completion plumbing -------------------------------------------------

    def _finish(self, req: InferenceResult, value,
                error: Optional[BaseException] = None) -> None:
        req._set(value, error)
        with self._cond:
            req._done = True
            self._cond.notify_all()

    def _finish_many(self, reqs) -> None:
        """Publish a batch of already-``_set`` requests under one
        condition acquisition + one wakeup."""
        with self._cond:
            for r in reqs:
                r._done = True
            self._cond.notify_all()

    # -- worker side ---------------------------------------------------------

    def _warmup(self, handle: Backend) -> None:
        """One frame off the latency path of the first real request (the
        first kernel call builds and loads the library)."""
        handle.predict_batch(
            np.zeros((1,) + self.in_shape, dtype=np.float32))

    def _execute(self, handle: Backend, live) -> list:
        """Run one aggregated batch; returns per-request outputs in
        order.  Frames stack into one ``predict_batch`` call; the token
        workload overrides this."""
        return list(handle.predict_batch(np.stack([r.x for r in live])))

    def _worker_loop(self) -> None:
        handle = self._backend.worker()
        if self.config.warmup:
            self._warmup(handle)
        deadline_s = self.config.batch_deadline_ms / 1e3
        try:
            while True:
                try:
                    first = self._queue.get(timeout=0.02)
                except queue.Empty:
                    if self._closing.is_set():
                        return
                    continue
                batch = [first]
                close_at = first.timestamps["submit"] + deadline_s
                while len(batch) < self.config.max_batch:
                    rest = close_at - time.perf_counter()
                    if rest <= 0:
                        # past the SLO deadline: take whatever is
                        # already queued (a backlog wants the biggest
                        # batch it can get) but never *wait* for more
                        try:
                            batch.append(self._queue.get_nowait())
                        except queue.Empty:
                            break
                    else:
                        try:
                            batch.append(self._queue.get(timeout=rest))
                        except queue.Empty:
                            break
                self._run_batch(handle, batch)
        finally:
            if handle is not self._backend:
                handle.close()

    def _run_batch(self, handle: Backend, batch) -> None:
        t_deq = time.perf_counter()
        live = []
        tmo = self.config.request_timeout_ms
        for req in batch:
            req.timestamps["dequeue"] = t_deq
            if (tmo is not None
                    and (t_deq - req.timestamps["submit"]) * 1e3 > tmo):
                self.stats_.on_timeout()
                self._finish(req, None, RequestTimeout(
                    f"spent >{tmo}ms queued (server overloaded?)"))
                continue
            if not self._drain and self._closing.is_set():
                self._finish(req, None, ServerClosed("server closed"))
                continue
            live.append(req)
        if not live:
            return
        self.stats_.on_batch(len(live))
        t_exec = time.perf_counter()
        try:
            out = self._execute(handle, live)
        except BaseException as e:  # surface to every waiter
            for req in live:
                self.stats_.on_failure()
                self._finish(req, None, e)
            return
        t_done = time.perf_counter()
        exec_us = (t_done - t_exec) * 1e6
        nlive = len(live)
        totals, qwaits = [], []
        for i, req in enumerate(live):
            req.timestamps["exec_start"] = t_exec
            req.batch_size = nlive
            req._set(out[i], done_at=t_done)
            t_sub = req.timestamps["submit"]
            totals.append((t_done - t_sub) * 1e6)
            qwaits.append((t_deq - t_sub) * 1e6)
        self._finish_many(live)
        self.stats_.on_complete_batch(totals, qwaits, exec_us, now=t_done)


class LMTokenServer(InferenceServer):
    """Token-level requests through the same bounded queue / worker pool
    / aggregation / stats machinery the frame server uses.

    >>> sess = LMSession(config=SessionConfig(backend="cuda-lm",
    ...                                       lm=LMConfig(...)))
    >>> with LMTokenServer(sess, workers=1) as srv:
    ...     toks = srv.generate(prompt_ids, max_new=16)

    A request is a 1-D int prompt plus ``max_new``; the result is the
    ``(max_new,)`` greedy continuation.  Aggregated batches are grouped
    by ``(prompt_len, max_new)``: compatible requests ride one
    :meth:`~repro_torch.engine.backends.LMBackend.generate` call (one
    prefill, shared decode steps), incompatible ones still execute in
    the same dequeue round.
    """

    def __init__(self, session, *, config: Optional[ServerConfig] = None,
                 **kw):
        self.lm_session = session if isinstance(session, LMSession) else None
        backend = (session.backend if self.lm_session is not None
                   else session)
        if not isinstance(backend, LMBackend):
            raise TypeError(
                f"LMTokenServer needs an LMSession or LMBackend, got "
                f"{type(session).__name__}")
        super().__init__(backend, config=config, **kw)

    # -- client side ---------------------------------------------------------

    def submit(self, tokens: np.ndarray,
               max_new: int = 16) -> InferenceResult:
        """Enqueue one 1-D int prompt; the future resolves to the
        ``(max_new,)`` int32 greedy continuation."""
        if self._closing.is_set():
            self.stats_.on_reject(closed=True)
            raise ServerClosed("server is shut down")
        toks = np.asarray(tokens)
        if toks.ndim != 1 or not np.issubdtype(toks.dtype, np.integer):
            raise ValueError(
                f"submit expects a 1-D int token prompt, got shape "
                f"{toks.shape} dtype {toks.dtype}")
        if max_new < 1:
            raise ValueError(f"max_new {max_new} < 1")
        return self._enqueue(InferenceResult(
            (np.ascontiguousarray(toks, np.int32), int(max_new)), self._cond))

    def generate(self, tokens: np.ndarray, max_new: int = 16,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous submit + wait."""
        return self.submit(tokens, max_new).result(timeout)

    def predict(self, x, timeout: Optional[float] = None):
        raise TypeError("LMTokenServer serves tokens: use generate()")

    # -- worker side ---------------------------------------------------------

    def _warmup(self, handle) -> None:
        # no frame shape to warm up with: the first request builds the
        # kernel library if the session has not already
        pass

    def _execute(self, handle, live) -> list:
        outs: list = [None] * len(live)
        groups: Dict[tuple, list] = {}
        for i, req in enumerate(live):
            toks, max_new = req.x
            groups.setdefault((toks.shape[0], max_new), []).append(i)
        for (_, max_new), idxs in groups.items():
            gen = handle.generate(np.stack([live[i].x[0] for i in idxs]),
                                  max_new)
            for j, i in enumerate(idxs):
                outs[i] = gen[j]
        return outs
