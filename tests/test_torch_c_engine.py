"""The port's ``"c"`` backend through its session, autotuner, server and
config, against the JAX package's ``"c"`` session on the CPU.

* ``InferenceSession(backend="c")`` gives the JAX ``"c"`` session's
  outputs bit for bit on ball and residual at the same config and
  compiler, fp32 and int8 (the int8 sessions take the JAX session's
  activation qparams, so both quantize to the same graph);
* ``autotune=True``: the record lands in the port's tuning directory and
  a second session reads it; ``simd_search``; int8 over simd x fusion;
  ``pipeline_stages=0`` resolves to a tuned stage count;
* ``backend="c"`` refuses a CUDA device;
* ``InferenceServer(workers=2)`` on ``"c"``: every frame equals
  ``session.predict`` bit for bit;
* ``SessionConfig`` round-trips with the JAX one on every C knob.
"""
import json
import os

import numpy as np
import pytest

from repro.configs import cnn_paper as jnets
from repro.engine import InferenceSession as JaxSession
from repro.engine import SessionConfig as JaxConfig
from repro.engine import autotune as jautotune
from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import cgen, runtime
from repro_torch.core.graph import from_reference_graph
from repro_torch.engine import (CBackend, InferenceSession, SessionConfig,
                                TuningCache, autotune)
from repro_torch.serve import InferenceServer, ServerConfig

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
JAX_NETS = {**jnets.PAPER_CNNS, **jnets.EXTRA_CNNS}
C_KNOBS = ("simd", "simd_search", "unroll", "threads", "func_name",
           "fusion", "pipeline_stages")


def _frames(shape, n=8, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(shape)).astype(np.float32)


# ball at the default config; residual with rolled loops, whose -O3
# build takes a second where the unrolled one takes about 13
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("name,unroll", [("ball", "auto"),
                                         ("residual", None)])
def test_c_session_equals_the_jax_c_session(name, unroll, precision):
    raw = JAX_NETS[name](0)
    jsess = JaxSession(raw, config=JaxConfig(
        backend="c", precision=precision, unroll=unroll))
    cal = {}
    if precision == "int8":
        cal = {"qparams": {n: (qp.scale, qp.zero_point)
                           for n, qp in jsess.qgraph.acts.items()}}
        jsess = JaxSession(raw, config=JaxConfig(
            backend="c", precision="int8", calibration=cal))
    sess = InferenceSession(from_reference_graph(raw), config=SessionConfig(
        backend="c", precision=precision, unroll=unroll, calibration=cal))
    assert isinstance(sess.backend, CBackend)
    assert str(sess.device) == "cpu"
    xs = _frames(sess.input_shape, n=5, seed=9)
    want = jsess.predict(xs)
    np.testing.assert_array_equal(sess.predict(xs), want)
    np.testing.assert_array_equal(sess.predict(xs[0]), want[0])
    info, jinfo = sess.info, jsess.info
    for key in ("simd", "schedule", "arena_bytes", "arena_buffer_sum_bytes",
                "per_layer_live_bytes", "peak_live_bytes", "threads",
                "input_shape", "output_shape", "precision"):
        assert info[key] == jinfo[key], key
    # the one banner line apart, the same C
    assert info["c_source_bytes"] == jinfo["c_source_bytes"] + len(
        "NNCG (PyTorch port; repro") - len("NNCG-JAX (repro")
    assert info["so_path"] != jinfo["so_path"]
    assert info["simd_multiple"] == (1 if precision == "int8" else
                                     cgen.ISAS[info["simd"]].width)
    desc = sess.backend.describe()
    assert desc["name"] == "c" and desc["simd"] == info["simd"]
    assert desc["pipeline_stages"] == 1
    assert desc["schedule_digest"] == sess.schedule.digest()
    assert sess.benchmark(xs, iters=20, warmup=2) > 0


def test_autotuned_session_reads_its_record_from_the_port_directory(
        tmp_path):
    cfg = SessionConfig(backend="c", autotune=True, tune_iters=20,
                        tune_cache=str(tmp_path))
    first = InferenceSession(NETS["ball"](0), config=cfg)
    assert first.tuned is not None and not first.tuned.from_cache
    records = sorted(os.listdir(tmp_path))
    assert len(records) == 1 and records[0].endswith(".json")
    rec = json.loads((tmp_path / records[0]).read_text())
    assert rec["levels"] == first.tuned.levels
    assert rec["cc"] == runtime.cc_fingerprint()
    second = InferenceSession(NETS["ball"](0), config=cfg)
    assert second.tuned.from_cache
    assert second.info["tuned_from_cache"] is True
    assert second.tuned.levels == first.tuned.levels
    assert sorted(os.listdir(tmp_path)) == records
    xs = _frames(first.input_shape, n=4)
    np.testing.assert_array_equal(first.predict(xs), second.predict(xs))
    # the default directories of the two packages are apart
    assert TuningCache().path == autotune.DEFAULT_CACHE_DIR
    assert os.path.basename(autotune.DEFAULT_CACHE_DIR) == "tuning_torch"
    assert autotune.DEFAULT_CACHE_DIR != jautotune.DEFAULT_CACHE_DIR
    # the port's key is the reference's key
    jg = from_reference_graph(first.graph)
    assert autotune.graph_fingerprint(jg) == jautotune.graph_fingerprint(
        first.graph)


def test_simd_search_keeps_one_of_the_modes(tmp_path):
    sess = InferenceSession(NETS["ball"](0), config=SessionConfig(
        backend="c", autotune=True, tune_iters=10, tune_cache=str(tmp_path),
        simd_search=("sse", "avx")))
    assert sess.simd in ("sse", runtime.resolve_float_simd("avx"))
    assert sess.simd_multiple == 8  # the widest candidate's width
    assert sess.info["levels"] == sess.tuned.levels
    assert len(os.listdir(tmp_path)) == 2  # one record a mode
    xs = _frames(sess.input_shape, n=3)
    plain = InferenceSession(NETS["ball"](0), config=SessionConfig(
        backend="torch", device="cpu"))
    np.testing.assert_allclose(sess.predict(xs), plain.predict(xs),
                               rtol=1e-3, atol=1e-5)


def test_int8_autotune_over_simd_and_fusion(tmp_path):
    cfg = SessionConfig(backend="c", precision="int8", autotune=True,
                        tune_iters=10, tune_cache=str(tmp_path),
                        calibration={"samples": 8})
    sess = InferenceSession(NETS["residual"](0), config=cfg)
    assert not sess.tuned.from_cache
    assert sess.simd in runtime.supported_int8_simds()
    digests = {s.digest() for s in autotune.fusion_schedule_candidates(
        sess.graph)}
    assert len(digests) == 3 and sess.schedule.digest() in digests
    again = InferenceSession(NETS["residual"](0), config=cfg)
    assert again.tuned.from_cache and again.simd == sess.simd
    assert again.schedule.digest() == sess.schedule.digest()
    xs = _frames(sess.input_shape, n=4)
    np.testing.assert_array_equal(again.predict(xs), sess.predict(xs))
    # every candidate computes the same integers: the untuned build too
    plain = InferenceSession(NETS["residual"](0), config=cfg.replace(
        autotune=False, simd="generic"))
    np.testing.assert_array_equal(plain.predict(xs), sess.predict(xs))


def test_pipeline_stages_zero_resolves(tmp_path):
    sess = InferenceSession(NETS["residual"](0), config=SessionConfig(
        backend="c", pipeline_stages=0, unroll=None, tune_iters=64,
        tune_cache=str(tmp_path)))
    stages = sess.info["pipeline_stages"]
    assert stages in autotune.pipeline_stage_candidates()
    assert sess.schedule.nstages == stages
    xs = _frames(sess.input_shape, n=5)
    one = InferenceSession(NETS["residual"](0), config=SessionConfig(
        backend="c", unroll=None))
    np.testing.assert_array_equal(sess.predict(xs), one.predict(xs))


def test_c_backend_refuses_a_cuda_device():
    for device in ("cuda", "cuda:0"):
        with pytest.raises(ValueError, match="host"):
            SessionConfig(backend="c", device=device)
        with pytest.raises(ValueError, match="host"):
            InferenceSession(NETS["ball"](0), config={
                "backend": "c", "device": device})
    assert str(InferenceSession(NETS["ball"](0), config=SessionConfig(
        backend="c", device="cpu")).device) == "cpu"
    with pytest.raises(ValueError, match="int8"):
        InferenceSession(NETS["ball"](0), config=SessionConfig(
            backend="cuda", device="cpu", precision="int8"))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_served_frames_equal_predict(precision):
    sess = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="c", precision=precision, unroll=None,
        calibration={"samples": 8}))
    frames = _frames(sess.input_shape, n=48, seed=12)
    with InferenceServer(sess, config=ServerConfig(
            workers=2, max_batch=8, batch_deadline_ms=2.0)) as srv:
        handles = [srv.submit(f) for f in frames]
        outs = [h.result(timeout=60) for h in handles]
        st = srv.stats()
    assert st["completed"] == 48 and st["failed"] == 0, st
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, sess.predict(f))
    worker = sess.backend.worker()
    assert worker is not sess.backend and worker.precision == precision
    np.testing.assert_array_equal(worker.predict_batch(frames[:3]),
                                  sess.predict(frames[:3]))


def test_config_round_trips_with_the_jax_config():
    cfg = SessionConfig(backend="c", simd="sse", simd_search=["sse", "avx"],
                        unroll={"conv2d_1": 1}, threads=2,
                        func_name="net_x", fusion=False, pipeline_stages=0,
                        autotune=True, tune_iters=50)
    assert cfg.simd_search == ("sse", "avx")
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["simd_search"] == ["sse", "avx"]
    assert SessionConfig(**d) == cfg.portable() == cfg
    jd = JaxConfig(**{k: d[k] for k in C_KNOBS}, backend="c",
                   autotune=True, tune_iters=50).to_dict()
    for k in C_KNOBS:
        assert d[k] == jd[k], k
    assert SessionConfig(**{k: jd[k] for k in C_KNOBS}) == SessionConfig(
        **{k: d[k] for k in C_KNOBS})
    jdefault, default = JaxConfig().to_dict(), SessionConfig().to_dict()
    for k in C_KNOBS:
        assert default[k] == jdefault[k], k
    with pytest.raises(ValueError, match="pipeline_stages"):
        SessionConfig(pipeline_stages=-1)
