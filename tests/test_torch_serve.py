"""The port's continuous-batching server on the CPU: the cases of
``tests/test_serve.py`` on the port's ``InferenceServer``, plus the
surface the port shares with the JAX package's ``serve/`` and
``engine/`` (``InferenceResult.done``, ``ServerStats.on_complete``,
servers built from keywords, ``describe``/``close`` and context-manager
use of the CNN backends) and a backend that raises a ``BaseException``
inside a batch.

Where ``tests/test_serve.py`` drives the C backend, these drive the
``"torch"`` backend with ``device="cpu"``.  PyTorch's CPU convolution
sums in an order that depends on the batch a frame rides in, so served
frames are held to ``session.predict`` at rtol 1e-5 / atol 1e-6 rather
than bit for bit (on the card the kernels are batch-invariant, and
``chip_smoke.py`` holds served frames to that tolerance too).
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import PAPER_CNNS
from repro_torch.engine import (Backend, InferenceSession, LMConfig,
                                LMSession, SessionConfig)
from repro_torch.serve import (InferenceServer, LMTokenServer,
                               RequestTimeout, ServerClosed, ServerConfig,
                               ServerOverloaded, ServerStats)

IN_SHAPE = (4,)
SERVED_RTOL, SERVED_ATOL = 1e-5, 1e-6


class StubBackend(Backend):
    """Pure-python substrate: output row i = input row i + 1 (so routing
    mistakes are visible), optional per-call delay, optional gate the
    test holds closed to pin the worker mid-batch, and a log of every
    executed batch size."""

    name = "stub"

    def __init__(self, delay: float = 0.0, gated: bool = False):
        super().__init__(SimpleNamespace(input_shape=IN_SHAPE,
                                         output_shape=IN_SHAPE))
        self.delay = delay
        self.gate = threading.Event()
        if not gated:
            self.gate.set()
        self.batch_sizes = []
        self.closed = False

    def predict_batch(self, x):
        self.gate.wait(timeout=10)
        if self.delay:
            time.sleep(self.delay)
        self.batch_sizes.append(x.shape[0])
        return x + 1.0

    def close(self):
        self.closed = True


def _frames(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n,) + IN_SHAPE).astype(np.float32)


# -- batch aggregation ------------------------------------------------------

def test_batch_closes_on_size_trigger():
    # deadline is effectively infinite: only the size trigger can close
    # the batch, so completion within the test timeout proves it fired
    be = StubBackend(gated=True)
    with InferenceServer(be, config=ServerConfig(
            workers=1, max_batch=4, batch_deadline_ms=60_000,
            warmup=False)) as srv:
        xs = _frames(4)
        handles = [srv.submit(x) for x in xs]
        be.gate.set()
        outs = np.stack([h.result(timeout=5) for h in handles])
        np.testing.assert_array_equal(outs, xs + 1.0)
    assert 4 in be.batch_sizes


def test_batch_closes_on_deadline_trigger():
    # fewer requests than max_batch: only the SLO deadline can close
    # the batch
    be = StubBackend()
    with InferenceServer(be, config=ServerConfig(
            workers=1, max_batch=64, batch_deadline_ms=30,
            warmup=False)) as srv:
        t0 = time.perf_counter()
        h1 = srv.submit(_frames(1)[0])
        h2 = srv.submit(_frames(1, seed=1)[0])
        h1.result(timeout=5), h2.result(timeout=5)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
    # closed at the ~30ms deadline, nowhere near a size-triggered wait
    assert elapsed_ms < 5_000
    assert max(be.batch_sizes) >= 1
    assert sum(be.batch_sizes) == 2


def test_deadline_zero_serves_immediately():
    be = StubBackend()
    with InferenceServer(be, config=ServerConfig(
            workers=1, max_batch=8, batch_deadline_ms=0,
            warmup=False)) as srv:
        x = _frames(1)[0]
        np.testing.assert_array_equal(srv.predict(x, timeout=5), x + 1.0)


# -- routing under concurrent load ------------------------------------------

def test_results_route_to_their_requesters_under_concurrency():
    be = StubBackend(delay=0.001)
    xs = _frames(96, seed=3)
    results = {}
    errs = []

    with InferenceServer(be, config=ServerConfig(
            workers=4, max_batch=8, batch_deadline_ms=2,
            warmup=False)) as srv:

        def client(lo, hi):
            try:
                hs = [(i, srv.submit(xs[i])) for i in range(lo, hi)]
                for i, h in hs:
                    results[i] = h.result(timeout=10)
            except Exception as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=client,
                                    args=(i * 24, (i + 1) * 24))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    assert not errs, errs
    assert len(results) == 96
    for i in range(96):
        np.testing.assert_array_equal(results[i], xs[i] + 1.0)


# -- backpressure ------------------------------------------------------------

def test_queue_full_raises_immediately_not_hangs():
    be = StubBackend(gated=True)   # worker pinned: queue can only grow
    srv = InferenceServer(be, config=ServerConfig(
        workers=1, max_batch=1, max_queue=2, batch_deadline_ms=0,
        warmup=False))
    try:
        srv.submit(_frames(1)[0])          # taken by the pinned worker
        time.sleep(0.1)                    # let the worker dequeue it
        srv.submit(_frames(1)[0])
        srv.submit(_frames(1)[0])          # queue now full (max_queue=2)
        t0 = time.perf_counter()
        with pytest.raises(ServerOverloaded, match="queue full"):
            srv.submit(_frames(1)[0])
        assert time.perf_counter() - t0 < 1.0, "backpressure must not block"
        assert srv.stats()["rejected_queue_full"] == 1
    finally:
        be.gate.set()
        srv.close()


# -- per-request timeout ------------------------------------------------------

def test_stale_request_fails_with_timeout_not_executes():
    be = StubBackend(gated=True)
    srv = InferenceServer(be, config=ServerConfig(
        workers=1, max_batch=1, batch_deadline_ms=0,
        request_timeout_ms=20, warmup=False))
    try:
        h0 = srv.submit(_frames(1)[0])     # dequeued fresh, then pinned
        time.sleep(0.1)
        h1 = srv.submit(_frames(1)[0])     # queued behind the pinned one
        time.sleep(0.1)                    # ...for > request_timeout_ms
        be.gate.set()
        h0.result(timeout=5)               # fresh at dequeue: fine
        with pytest.raises(RequestTimeout):
            h1.result(timeout=5)
        assert srv.stats()["timeouts"] == 1
    finally:
        be.gate.set()
        srv.close()


# -- shutdown -----------------------------------------------------------------

def test_graceful_shutdown_drains_in_flight_work():
    be = StubBackend(delay=0.002)
    srv = InferenceServer(be, config=ServerConfig(
        workers=2, max_batch=4, batch_deadline_ms=1, warmup=False))
    xs = _frames(20, seed=5)
    handles = [srv.submit(x) for x in xs]
    srv.close(drain=True)
    for h, x in zip(handles, xs):
        np.testing.assert_array_equal(h.result(timeout=5), x + 1.0)
    st = srv.stats()
    assert st["completed"] == 20
    assert be.closed, "close() must propagate to the backend"
    with pytest.raises(ServerClosed):
        srv.submit(xs[0])
    assert srv.stats()["rejected_closed"] == 1


def test_non_drain_shutdown_fails_queued_requests():
    be = StubBackend(gated=True)
    srv = InferenceServer(be, config=ServerConfig(
        workers=1, max_batch=1, batch_deadline_ms=0, warmup=False))
    h0 = srv.submit(_frames(1)[0])         # pinned in the worker
    time.sleep(0.1)
    queued = [srv.submit(x) for x in _frames(3, seed=7)]
    threading.Timer(0.2, be.gate.set).start()
    srv.close(drain=False)
    h0.result(timeout=5)                   # in-flight one still finishes
    for h in queued:
        with pytest.raises(ServerClosed):
            h.result(timeout=5)


def test_close_is_idempotent():
    srv = InferenceServer(StubBackend(), config=ServerConfig(
        workers=1, warmup=False))
    srv.close()
    srv.close()


# -- stats --------------------------------------------------------------------

def test_stats_percentiles_and_counters_are_sane():
    be = StubBackend(delay=0.001)
    with InferenceServer(be, config=ServerConfig(
            workers=2, max_batch=4, batch_deadline_ms=1,
            warmup=False)) as srv:
        handles = [srv.submit(x) for x in _frames(40, seed=9)]
        for h in handles:
            h.result(timeout=10)
        st = srv.stats()
    assert st["submitted"] == st["completed"] == 40
    assert st["failed"] == st["timeouts"] == 0
    for k in ("latency", "queue_wait", "exec"):
        p50, p99 = st[f"{k}_p50_us"], st[f"{k}_p99_us"]
        assert np.isfinite(p50) and np.isfinite(p99) and 0 <= p50 <= p99, (
            k, p50, p99)
    # exec >= the backend's injected 1ms delay; total >= exec p50
    assert st["exec_p50_us"] >= 1_000
    assert st["latency_p99_us"] >= st["exec_p50_us"]
    assert st["qps"] > 0
    assert 1 <= st["batch_size_mean"] <= st["max_batch"]
    assert 0 < st["batch_occupancy"] <= 1
    assert st["queue_depth"] == 0


def test_request_timestamps_expose_every_stage():
    be = StubBackend()
    with InferenceServer(be, config=ServerConfig(
            workers=1, batch_deadline_ms=0, warmup=False)) as srv:
        h = srv.submit(_frames(1)[0])
        h.result(timeout=5)
    ts = h.timestamps
    assert ts["submit"] <= ts["dequeue"] <= ts["exec_start"] <= ts["done"]
    assert h.batch_size == 1


def test_backend_errors_surface_to_the_waiter():
    class Exploding(StubBackend):
        def predict_batch(self, x):
            raise RuntimeError("kaboom")

    with InferenceServer(Exploding(), config=ServerConfig(
            workers=1, batch_deadline_ms=0, warmup=False)) as srv:
        h = srv.submit(_frames(1)[0])
        with pytest.raises(RuntimeError, match="kaboom"):
            h.result(timeout=5)
        assert srv.stats()["failed"] == 1


def test_config_validation():
    with pytest.raises(ValueError, match="workers"):
        ServerConfig(workers=0)
    with pytest.raises(ValueError, match="max_batch"):
        ServerConfig(max_batch=0)
    with pytest.raises(TypeError, match="not both"):
        InferenceServer(StubBackend(), config=ServerConfig(warmup=False),
                        workers=2)
    srv = InferenceServer(StubBackend(), config=ServerConfig(warmup=False))
    with pytest.raises(ValueError, match="one frame"):
        srv.submit(np.zeros((3, 3), np.float32))
    srv.close()


# -- the real engine under the server -----------------------------------------

@pytest.fixture
def one_thread():
    """One PyTorch CPU thread per server worker while the test runs: the
    test suite runs in several processes at once, and each process's
    default thread pool would oversubscribe the cores the latency gate
    is measured on."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_smoke_64_frames_through_a_real_net_p99_under_100ms(one_thread):
    """Boot the server on a real net, push 64 frames, require p99 < 100ms,
    zero dropped responses, and every frame equal to the offline path."""
    sess = InferenceSession(PAPER_CNNS["pedestrian"](0), config=SessionConfig(
        backend="torch", device="cpu"))
    frames = np.random.default_rng(0).normal(
        size=(64,) + tuple(sess.input_shape)).astype(np.float32)
    ref = sess.predict(frames)
    with InferenceServer(sess, config=ServerConfig(
            workers=3, max_batch=8, batch_deadline_ms=2)) as srv:
        handles = [srv.submit(f) for f in frames]
        outs = np.stack([h.result(timeout=10) for h in handles])
        st = srv.stats()
    # zero drops, every result routed to its frame
    assert st["completed"] == 64
    assert st["failed"] == st["timeouts"] == 0
    assert st["rejected_queue_full"] == st["rejected_closed"] == 0
    np.testing.assert_allclose(outs, ref, rtol=SERVED_RTOL, atol=SERVED_ATOL)
    assert st["latency_p99_us"] < 100_000, st


def test_worker_handles_are_independent():
    # each worker handle shares the session's weights; concurrent handles
    # agree with the session
    sess = InferenceSession(PAPER_CNNS["ball"](0), config=SessionConfig(
        backend="torch", device="cpu"))
    xs = np.random.default_rng(0).normal(
        size=(8,) + tuple(sess.input_shape)).astype(np.float32)
    ref = sess.predict(xs)
    w1, w2 = sess.backend.worker(), sess.backend.worker()
    assert w1 is not w2 and w1 is not sess.backend
    out = [None, None]
    t1 = threading.Thread(target=lambda: out.__setitem__(
        0, w1.predict_batch(xs[:4])))
    t2 = threading.Thread(target=lambda: out.__setitem__(
        1, w2.predict_batch(xs[4:])))
    t1.start(), t2.start(), t1.join(), t2.join()
    np.testing.assert_allclose(np.concatenate(out), ref, rtol=SERVED_RTOL,
                               atol=SERVED_ATOL)


# -- the surface shared with the JAX package ----------------------------------

class Abort(BaseException):
    """Not an Exception: what a worker must still hand to every waiter."""


def test_base_exception_in_a_batch_reaches_every_waiter():
    """A ``BaseException`` raised inside a batch fails every request of
    that batch with it, nobody blocks, and the worker serves on."""
    class Aborting(StubBackend):
        def predict_batch(self, x):
            self.gate.wait(timeout=10)
            if not self.batch_sizes:
                self.batch_sizes.append(x.shape[0])
                raise Abort("stop")
            return x + 1.0

    be = Aborting(gated=True)
    with InferenceServer(be, config=ServerConfig(
            workers=1, max_batch=4, batch_deadline_ms=60_000,
            warmup=False)) as srv:
        handles = [srv.submit(x) for x in _frames(4)]
        be.gate.set()
        for h in handles:
            with pytest.raises(Abort, match="stop"):
                h.result(timeout=5)
        assert all(h.done() for h in handles)
        assert srv.stats()["failed"] == 4
        xs = _frames(4, seed=1)  # a full batch: served at once
        after = [srv.submit(x) for x in xs]
        np.testing.assert_array_equal(
            np.stack([h.result(timeout=5) for h in after]), xs + 1.0)
    assert be.batch_sizes == [4]


def test_result_done_tracks_completion():
    be = StubBackend(gated=True)
    with InferenceServer(be, config=ServerConfig(
            workers=1, batch_deadline_ms=0, warmup=False)) as srv:
        h = srv.submit(_frames(1)[0])
        time.sleep(0.05)
        assert not h.done()
        be.gate.set()
        h.result(timeout=5)
        assert h.done()


def test_stats_on_complete_records_one_request():
    st = ServerStats(window=16)
    st.on_submit()
    st.on_batch(1)
    st.on_complete(total_us=300.0, queue_wait_us=100.0, exec_us=150.0,
                   now=1.0)
    snap = st.snapshot()
    assert snap["submitted"] == snap["completed"] == 1
    assert (snap["latency_p50_us"], snap["queue_wait_p50_us"],
            snap["exec_p50_us"]) == (300.0, 100.0, 150.0)


def test_servers_take_their_config_as_keywords():
    srv = InferenceServer(StubBackend(), workers=1, max_batch=3,
                          warmup=False)
    assert srv.config == ServerConfig(workers=1, max_batch=3, warmup=False)
    srv.close()
    sess = LMSession(config=SessionConfig(
        backend="cuda-lm", device="cpu",
        lm=LMConfig(arch="gemma3-4b", max_context=32)))
    prompts = np.random.default_rng(4).integers(
        0, 256, size=(1, 6)).astype(np.int32)
    with LMTokenServer(sess.backend, workers=1) as srv:
        assert srv.config.workers == 1 and srv.lm_session is None
        np.testing.assert_array_equal(
            srv.generate(prompts[0], max_new=3, timeout=60),
            sess.generate(prompts, 3)[0])
    with LMTokenServer(sess, workers=1, max_batch=2) as srv:
        assert srv.lm_session is sess and srv.config.max_batch == 2
    with pytest.raises(TypeError, match="not both"):
        LMTokenServer(sess, config=ServerConfig(), workers=1)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_cnn_backends_describe_close_and_manage_context(backend):
    sess = InferenceSession(PAPER_CNNS["ball"](0), config=SessionConfig(
        backend=backend, device="cpu"))
    d = sess.backend.describe()
    assert d == {"name": backend, "precision": "fp32",
                 "input_shape": tuple(sess.input_shape),
                 "output_shape": tuple(sess.output_shape),
                 "device": "cpu", "kernels": backend == "cuda"}
    x = np.zeros((2,) + tuple(sess.input_shape), np.float32)
    with sess.backend as be:
        assert be is sess.backend
        assert be.predict_batch(x).shape == (2,) + tuple(sess.output_shape)
    sess.close()
    sess.close()  # idempotent
