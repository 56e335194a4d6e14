"""The port's engine and server on the CPU.

Sessions with ``backend="cuda"`` (the kernel path; on the CPU its plain
versions) and ``backend="torch"`` are held to the JAX package's
``InferenceSession(backend="xla")`` at rtol 1e-3 / atol 1e-5, the
engine's three-way parity tolerance.  The server tests follow
``tests/test_serve.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs import cnn_paper as jnets
from repro.engine import InferenceSession as JaxSession
from repro.engine import SessionConfig as JaxConfig
from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core.graph import from_reference_graph
from repro_torch.engine import (Backend, InferenceSession, SessionConfig,
                                available_backends)
from repro_torch.serve import (InferenceServer, ServerClosed, ServerConfig,
                               ServerOverloaded)

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
JAX_NETS = {**jnets.PAPER_CNNS, **jnets.EXTRA_CNNS}


def _frames(shape, n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", list(NETS))
def test_session_matches_xla_session(name, backend):
    jsess = JaxSession(JAX_NETS[name](0), config=JaxConfig(backend="xla"))
    sess = InferenceSession(NETS[name](0), config=SessionConfig(
        backend=backend, device="cpu"))
    xs = _frames(sess.input_shape, 3)
    np.testing.assert_allclose(sess.predict(xs), jsess.predict(xs),
                               rtol=1e-3, atol=1e-5)
    one = sess.predict(xs[0])
    assert one.shape == tuple(sess.output_shape)
    assert sess.info["backend"] == backend
    assert sess.info["device"] == "cpu"
    assert SessionConfig(**sess.info["config"]) == sess.config


def test_session_accepts_a_carried_graph():
    g = from_reference_graph(jnets.robot_detector(0))
    a = InferenceSession(g, config={"backend": "cuda", "device": "cpu"})
    b = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="cuda", device="cpu"))
    xs = _frames(a.input_shape, 2)
    np.testing.assert_array_equal(a.predict(xs), b.predict(xs))


def test_backends_registered_and_config_validated():
    assert available_backends() == ["cuda", "cuda-lm", "torch"]
    with pytest.raises(ValueError, match="unknown backend"):
        InferenceSession(NETS["ball"](0), config=SessionConfig(
            backend="pallas", device="cpu"))
    assert SessionConfig(precision="int8").precision == "int8"
    with pytest.raises(ValueError, match="calibration method"):
        SessionConfig(precision="int8", calibration={"method": "bogus"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SessionConfig(autotune=True)
    with pytest.raises(ValueError, match="precision"):
        SessionConfig(precision="fp16")
    with pytest.raises(RuntimeError):
        SessionConfig(device="not-a-device")


def test_cuda_backend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (SessionConfig(backend="cuda"), None):
        with pytest.raises(RuntimeError, match="is_available"):
            InferenceSession(NETS["ball"](0), config=cfg)


def test_benchmark_and_raw_graph_refusal():
    sess = InferenceSession(NETS["ball"](0), config=SessionConfig(
        backend="cuda", device="cpu"))
    assert sess.benchmark(iters=3, warmup=1) > 0
    raw = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="cuda", device="cpu", optimize=False))
    with pytest.raises(NotImplementedError, match="passes.optimize"):
        raw.predict(_frames(raw.input_shape, 1))


# -------------------------------------------------------------- serving ----

def test_server_round_trip_through_the_kernel_path():
    sess = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="cuda", device="cpu"))
    xs = _frames(sess.input_shape, 12, seed=3)
    with InferenceServer(sess, config=ServerConfig(
            workers=2, max_batch=4, batch_deadline_ms=2)) as srv:
        handles = [srv.submit(x) for x in xs]
        outs = [h.result(timeout=30) for h in handles]
        st = srv.stats()
    # the CPU convolution's summation order depends on the batch a frame
    # rides in, hence a tolerance rather than equality here
    for o, x in zip(outs, xs):
        np.testing.assert_allclose(o, sess.predict(x), rtol=1e-4, atol=1e-5)
    assert st["submitted"] == st["completed"] == 12
    assert st["failed"] == st["timeouts"] == 0
    assert 1 <= st["batch_size_mean"] <= 4
    assert 0 < st["batch_occupancy"] <= 1
    assert np.isfinite(st["latency_p99_us"])


class _Gated(Backend):
    """Output = input + 1; holds every batch until the gate opens."""

    name = "gated"

    def __init__(self):
        super().__init__(NETS["ball"](0))
        self.out_shape = tuple(self.graph.input_shape)
        self.gate = threading.Event()

    def predict_batch(self, x):
        self.gate.wait(timeout=10)
        return x + 1.0


def test_server_backpressure_on_a_full_queue():
    be = _Gated()
    srv = InferenceServer(be, config=ServerConfig(
        workers=1, max_batch=1, max_queue=2, batch_deadline_ms=0,
        warmup=False))
    x = _frames(be.graph.input_shape, 1)[0]
    try:
        first = srv.submit(x)              # taken by the pinned worker
        time.sleep(0.1)
        srv.submit(x)
        srv.submit(x)                      # queue now full
        t0 = time.perf_counter()
        with pytest.raises(ServerOverloaded, match="queue full"):
            srv.submit(x)
        assert time.perf_counter() - t0 < 1.0
        assert srv.stats()["rejected_queue_full"] == 1
        be.gate.set()
        np.testing.assert_array_equal(first.result(timeout=5), x + 1.0)
    finally:
        be.gate.set()
        srv.close()
    with pytest.raises(ServerClosed):
        srv.submit(x)
    assert srv.stats()["completed"] == 3
