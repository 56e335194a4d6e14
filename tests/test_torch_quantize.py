"""The port's int8 path on the CPU against the JAX package's.

The same seeded numpy inputs go through each JAX function and its port:
``round_half_up``, the qparam rules, the streaming ``Observer``, weight
quantization, ``forward_quantized``, ``calibrate``,
``quantization_error``, the data pipeline, and the int8 session and
server.

Tolerances: the numpy parts and the integer path are exact
(``assert_array_equal``); a Softmax sink runs in float32 and is held at
rtol 1e-5 / atol 1e-6.  ``calibrate``'s float forward sums in another
order than XLA's (about 1e-6 apart), so its scales are held at rtol 1e-5
and its zero points exactly; the three clipping methods are held by the
top-1 agreement they reach on held-out frames, within 0.01 of JAX's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import cnn_paper as jnets
from repro.core import jax_exec
from repro.core import numerics as jnum
from repro.core import passes as jpasses
from repro.core import quantize as jq
from repro.core.graph import (Add, AvgPool, CNNGraph, Concat, Conv2D, Dense,
                              DepthwiseConv2D, Flatten, GlobalAvgPool, Input,
                              MaxPool)
from repro.data import pipeline as jpipe
from repro.engine import InferenceSession as JaxSession
from repro.engine import SessionConfig as JaxConfig
from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import numerics as tnum
from repro_torch.core import quantize as tq
from repro_torch.core import torch_exec
from repro_torch.core.graph import from_reference_graph
from repro_torch.data import pipeline as tpipe
from repro_torch.engine import (CalibrationConfig, InferenceSession,
                                QuantizedTorchBackend, SessionConfig)
from repro_torch.serve import InferenceServer, ServerConfig

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
JAX_NETS = {**jnets.PAPER_CNNS, **jnets.EXTRA_CNNS}
SOFTMAX_NETS = ("ball", "pedestrian", "residual")


# ------------------------------------------------------------ graphs ----

def _conv(rng, kh, kw, ci, co, **kw_args) -> Conv2D:
    w = rng.normal(0, 0.5, (kh, kw, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return Conv2D(weights=w, bias=b, **kw_args)


def _dw(rng, kh, kw, c, m, **kw_args) -> DepthwiseConv2D:
    w = rng.normal(0, 0.5, (kh, kw, c, m)).astype(np.float32)
    b = rng.normal(0, 0.1, (c * m,)).astype(np.float32)
    return DepthwiseConv2D(weights=w, bias=b, **kw_args)


def _kernel_zoo(seed=7) -> CNNGraph:
    """The softmax-free net of ``tests/test_int8_kernels.py``: strided
    same-pad conv, channel counts 19 and 33, leaky/relu epilogues, a
    same-padded MaxPool, a two-input Add, depthwise, two Dense tails."""
    rng = np.random.default_rng(seed)
    dw_w = rng.normal(0, 0.5, (3, 3, 12, 1)).astype(np.float32)
    dw_b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    return CNNGraph([
        Input(shape=(11, 9, 3), name="in"),
        _conv(rng, 3, 3, 3, 12, padding="same", activation="relu",
              name="c1"),
        DepthwiseConv2D(weights=dw_w, bias=dw_b, padding="same",
                        activation="leaky_relu", name="dw"),
        Add(name="add", inputs=["dw", "c1"], activation="relu"),
        _conv(rng, 3, 3, 12, 19, strides=(2, 2), padding="same",
              activation="leaky_relu", name="c2"),
        MaxPool(size=(2, 2), padding="same", name="mp"),
        _conv(rng, 2, 2, 19, 33, padding="valid", name="c3"),
        Flatten(name="fl"),
        Dense(weights=rng.normal(0, 0.2, (2 * 2 * 33, 21)).astype(
                  np.float32),
              bias=rng.normal(0, 0.1, (21,)).astype(np.float32),
              activation="relu", name="d1"),
        Dense(weights=rng.normal(0, 0.2, (21, 10)).astype(np.float32),
              bias=rng.normal(0, 0.1, (10,)).astype(np.float32),
              name="d2"),
    ])


def _per_channel_graph(co=17, seed=13) -> CNNGraph:
    """The valid-padding chain of ``tests/test_quantize.py`` whose every
    non-sink weighted layer (c1, c2, dwx) is per-channel eligible, with
    a softmax-free Dense sink."""
    rng = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(10, 10, 3), name="in"),
        _conv(rng, 3, 3, 3, co, padding="valid", activation="relu",
              name="c1"),
        _conv(rng, 3, 3, co, 8, padding="valid", name="c2"),
        _dw(rng, 1, 1, 8, 2, padding="valid", name="dwx"),
        Dense(weights=rng.normal(0, 0.1, (6 * 6 * 16, 5))
              .astype(np.float32),
              bias=rng.normal(0, 0.05, (5,)).astype(np.float32),
              name="fc"),
    ])


def _pool_dag(seed=5) -> CNNGraph:
    """A softmax-free DAG: a residual Add, a two-branch Concat, then
    AvgPool (same padding, so edge windows count fewer taps) and
    GlobalAvgPool, ending in a Dense."""
    rng = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(12, 10, 3), name="in"),
        _conv(rng, 3, 3, 3, 8, padding="same", activation="relu",
              name="c1"),
        _dw(rng, 3, 3, 8, 1, padding="same", activation="leaky_relu",
            name="dw1"),
        _conv(rng, 1, 1, 8, 8, padding="valid", name="pw"),
        Add(name="add", inputs=["pw", "c1"], activation="relu"),
        _conv(rng, 1, 1, 8, 4, name="b1", inputs=["add"]),
        _conv(rng, 3, 3, 8, 4, padding="same", name="b2", inputs=["add"]),
        Concat(name="cat", inputs=["b1", "b2"]),
        AvgPool(size=(3, 3), strides=(2, 2), padding="same", name="ap"),
        GlobalAvgPool(name="gap"),
        Flatten(name="fl"),
        Dense(weights=rng.normal(0, 0.3, (8, 5)).astype(np.float32),
              bias=rng.normal(0, 0.1, (5,)).astype(np.float32),
              name="fc"),
    ])


GRAPHS = {"kernel_zoo": _kernel_zoo, "per_channel": _per_channel_graph,
          "pool_dag": _pool_dag}


def _frames(shape, n=8, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(shape)).astype(np.float32)


def _camera(shape, n=32, seed=0):
    return jpipe.camera_frame_batch(n, tuple(shape), seed=seed)


def _jax_graph(name):
    g = JAX_NETS[name](0) if name in JAX_NETS else GRAPHS[name]()
    return jpasses.optimize(g, simd_multiple=1)


# ------------------------------------------------- numpy parts, exact ----

def test_round_half_up_is_identical():
    rng = np.random.default_rng(0)
    halves = np.arange(-300, 300) + 0.5
    for a in (halves, np.nextafter(halves, np.inf),
              np.nextafter(halves, -np.inf), rng.normal(0, 200, 4000)):
        for dtype in (np.float32, np.float64):
            x = a.astype(dtype)
            want, got = jnum.round_half_up(x), tnum.round_half_up(x)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_qparams_rules_are_identical():
    """Ranges whose float32 scale stays normal: a range that underflows
    it raises in both packages alike, a fault of the reference."""
    rng = np.random.default_rng(21)
    mn = np.concatenate([rng.normal(0, 5, 200), [0.0, -1.0, 0.0, 2.0]])
    mx = np.concatenate([mn[:200] + np.abs(rng.normal(0, 5, 200)),
                         [0.0, 0.0, 1e-3, 3.0]])
    for lo, hi in zip(mn, mx):
        got, want = tq.qparams_from_range(lo, hi), jq.qparams_from_range(
            lo, hi)
        assert (got.scale, got.zero_point) == (want.scale, want.zero_point)
        assert got.inv_scale == want.inv_scale
    want = jq.channel_qparams_from_range(mn, mx)
    got = tq.channel_qparams_from_range(mn, mx)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(got.zero_point, want.zero_point)
    assert got.scale.dtype == want.scale.dtype
    assert got.zero_point.dtype == want.zero_point.dtype
    np.testing.assert_array_equal(got.inv_scale, want.inv_scale)
    x = rng.normal(0, 5, (7, mn.size)).astype(np.float32)
    np.testing.assert_array_equal(got.quantize(x), want.quantize(x))
    qp_t, qp_j = tq.qparams_from_range(-2.5, 7.0), jq.qparams_from_range(
        -2.5, 7.0)
    np.testing.assert_array_equal(qp_t.quantize(x), qp_j.quantize(x))
    np.testing.assert_array_equal(qp_t.dequantize(qp_t.quantize(x)),
                                  qp_j.dequantize(qp_j.quantize(x)))


@pytest.mark.parametrize("name", ["per_channel", "kernel_zoo", "pool_dag",
                                  *JAX_NETS])
def test_per_channel_eligible_is_identical(name):
    jg = _jax_graph(name)
    assert tq.per_channel_eligible(from_reference_graph(jg)) == \
        jq.per_channel_eligible(jg)


@pytest.mark.parametrize("method", jq.CALIBRATION_METHODS)
def test_observer_is_identical(method):
    """The same chunks, the second of which regrows the histogram's
    span on both sides, give the same counts, edges, extremes and
    selected range."""
    rng = np.random.default_rng(4)
    chunks = [rng.normal(0, 1, (4, 6, 5)), rng.normal(2, 4, (4, 6, 5)),
              rng.uniform(-1, 1, (2, 6, 5)), np.zeros((0,))]
    chunks[1][0, 0, 0] = 40.0  # an outlier the clipping methods trim
    obs_j, obs_t = jq.Observer(256), tq.Observer(256)
    for c in chunks:
        obs_j.update(c.astype(np.float32))
        obs_t.update(c.astype(np.float32))
        np.testing.assert_array_equal(obs_t.counts, obs_j.counts)
        np.testing.assert_array_equal(obs_t.edges, obs_j.edges)
        assert (obs_t.mn, obs_t.mx) == (obs_j.mn, obs_j.mx)
    assert obs_t.select_range(method, 99.0) == \
        obs_j.select_range(method, 99.0)
    with pytest.raises(ValueError, match="unknown calibration method"):
        obs_t.select_range("bogus")


def _acts_across(jqg):
    return {n: tq.QParams(scale=qp.scale, zero_point=qp.zero_point)
            for n, qp in jqg.acts.items()}


def _assert_weights_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        for f in ("w_scale", "w_q", "b_q"):
            a, b = getattr(got[name], f), getattr(want[name], f)
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")
        assert got[name].in_folded == want[name].in_folded


@pytest.mark.parametrize("name,per_channel", [
    ("robot", False), ("kernel_zoo", False), ("pool_dag", False),
    ("residual", False), ("per_channel", True)])
def test_quantize_graph_is_identical(name, per_channel):
    """Given JAX's acts (and per-channel acts), the port quantizes every
    weight, weight scale and bias to the same values, and
    ``quantize_from_qparams`` on those acts rebuilds the same graph."""
    jg = _jax_graph(name)
    jqg = jq.quantize(jg, _frames(jg.input_shape, n=16),
                      per_channel=per_channel)
    if per_channel:
        assert sorted(jqg.channel_acts) == ["c1", "c2", "dwx"]
    pg = from_reference_graph(jg)
    ch = {n: tq.ChannelQParams(scale=cq.scale.copy(),
                               zero_point=cq.zero_point.copy())
          for n, cq in jqg.channel_acts.items()}
    got = tq.quantize_graph(pg, _acts_across(jqg), channel_acts=ch)
    _assert_weights_equal(got.weights, jqg.weights)
    if not per_channel:
        pairs = {n: (qp.scale, qp.zero_point) for n, qp in jqg.acts.items()}
        got = tq.quantize_from_qparams(pg, pairs)
        want = jq.quantize_from_qparams(jg, pairs)
        _assert_weights_equal(got.weights, want.weights)
        assert got.method == want.method == "provided"
        assert got.ranges == want.ranges
        assert tq.qparams_digest(got) == jq.qparams_digest(want)


def test_quantize_from_qparams_validates_as_jax_does():
    jg = _jax_graph("ball")
    pg = from_reference_graph(jg)
    acts = jq.quantize(jg, _frames(jg.input_shape)).acts
    for bad, err in (({**acts, "nope": (0.1, 0)}, ValueError),
                     ({next(iter(acts)): (0.0, 0)}, ValueError),
                     ({next(iter(acts)): "x"}, TypeError)):
        with pytest.raises(err):
            jq.quantize_from_qparams(jg, bad)
        with pytest.raises(err):
            tq.quantize_from_qparams(pg, {
                n: (v.scale, v.zero_point) if isinstance(v, jq.QParams)
                else v for n, v in bad.items()})


# -------------------------------------------------- forward_quantized ----

def _carried(name, per_channel=False, xs=None):
    jg = _jax_graph(name)
    xs = _frames(jg.input_shape, n=16) if xs is None else xs
    jqg = jq.quantize(jg, xs, per_channel=per_channel)
    return jqg, tq.from_reference_qgraph(jqg)


def _both(jqg, pqg, xs):
    want = np.asarray(jax_exec.forward_quantized(jqg, xs))
    got = torch_exec.forward_quantized(pqg, torch.from_numpy(xs)).numpy()
    assert got.dtype == want.dtype == np.float32
    return got, want


@pytest.mark.parametrize("name,per_channel", [
    ("robot", False), ("kernel_zoo", False), ("per_channel", True),
    ("pool_dag", False)])
def test_forward_quantized_is_bit_exact(name, per_channel):
    """On a qgraph carried across from JAX, the softmax-free nets agree
    bit for bit; per-channel zero points on c1, c2 and dwx."""
    jqg, pqg = _carried(name, per_channel)
    if per_channel:
        assert sorted(pqg.channel_acts) == ["c1", "c2", "dwx"]
        assert any(np.unique(cq.zero_point).size > 1
                   for cq in pqg.channel_acts.values())
    xs = _frames(pqg.graph.input_shape, n=6, seed=11)
    xs[0] *= 4.0  # beyond the calibrated range: the clip is exercised
    got, want = _both(jqg, pqg, xs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_exec.make_jit_forward_quantized(jqg)(xs)))


@pytest.mark.parametrize("name", SOFTMAX_NETS)
def test_forward_quantized_softmax_nets(name):
    jqg, pqg = _carried(name)
    got, want = _both(jqg, pqg, _frames(pqg.graph.input_shape, n=6, seed=11))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_int8_accumulator_is_exact_at_wide_k():
    """The float64 sum, rounded, equals an int64 sum: a 3x3 convolution
    over 512 channels (K = 4,608 products of up to 255 * 127)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-255, 256, (2, 7, 6, 512))
    w = rng.integers(-127, 128, (3, 3, 512, 8))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(np.einsum("nhwc,ck->nhwk", xp[:, i:i + 7, j:j + 6], w[i, j])
               for i in range(3) for j in range(3))
    acc = torch_exec._int_acc(torch_exec._conv(
        torch.from_numpy(x).double(), torch.from_numpy(w).double(), None,
        (1, 1), (1, 1, 1, 1)))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)


def test_quantized_module_holds_its_constants():
    jqg, pqg = _carried("kernel_zoo")
    mod = torch_exec.QuantizedCNNModule(pqg, device="cpu")
    bufs = dict(mod.named_buffers())
    assert bufs and all(t.device.type == "cpu" for t in bufs.values())
    assert {t.dtype for t in bufs.values()} == {
        torch.float32, torch.float64, torch.int32}
    xs = _frames(pqg.graph.input_shape, n=3)
    np.testing.assert_array_equal(
        mod(torch.from_numpy(xs)).numpy(),
        np.asarray(jax_exec.forward_quantized(jqg, xs)))


# ---------------------------------------------------------- calibrate ----

@pytest.mark.parametrize("name", list(JAX_NETS))
def test_calibrate_minmax_matches_jax(name):
    """Equal zero points and scales within rtol 1e-5 on the session's
    default frames; the two float forwards differ at about 1e-6."""
    jg = _jax_graph(name)
    xs = _camera(jg.input_shape)
    want_ranges, got_ranges = {}, {}
    want = jq.calibrate(jg, xs, ranges_out=want_ranges)
    got = tq.calibrate(from_reference_graph(jg), xs, ranges_out=got_ranges,
                       device="cpu")
    assert list(got) == list(want)
    assert {n: q.zero_point for n, q in got.items()} == {
        n: q.zero_point for n, q in want.items()}
    np.testing.assert_allclose([q.scale for q in got.values()],
                               [q.scale for q in want.values()], rtol=1e-5)
    np.testing.assert_allclose(np.array(list(got_ranges.values())),
                               np.array(list(want_ranges.values())),
                               rtol=1e-5, atol=1e-6)


def test_calibrate_per_channel_and_chunks_match_jax():
    jg = _jax_graph("per_channel")
    pg = from_reference_graph(jg)
    xs = _frames(jg.input_shape, n=11)  # chunks of 8 and 3
    names = tuple(jq.per_channel_eligible(jg))
    want_ch, got_ch = {}, {}
    jq.calibrate(jg, xs, channel_names=names, channel_out=want_ch)
    one = tq.calibrate(pg, xs, channel_names=names, channel_out=got_ch,
                       device="cpu")
    assert sorted(got_ch) == sorted(want_ch) == sorted(names)
    for n in names:
        np.testing.assert_array_equal(got_ch[n].zero_point,
                                      want_ch[n].zero_point)
        np.testing.assert_allclose(got_ch[n].scale, want_ch[n].scale,
                                   rtol=1e-5)
    # chunking changes nothing with minmax
    assert tq.calibrate(pg, xs, chunk_size=64, device="cpu") == one
    with pytest.raises(ValueError, match="unknown calibration method"):
        tq.calibrate(pg, xs, method="bogus", device="cpu")


def _held_out(shape):
    return jpipe.camera_frame_batch(16, tuple(shape), seed=99)


@pytest.mark.parametrize("method", ["percentile", "mse", "entropy"])
@pytest.mark.parametrize("name", list(JAX_NETS))
def test_clipping_methods_keep_jax_top1(name, method):
    """The clipping methods pick ranges from histograms of float values
    that differ from XLA's at about 1e-6: the port's int8 top-1
    agreement on held-out frames stays within 0.01 of JAX's."""
    jg = _jax_graph(name)
    xs, held = _camera(jg.input_shape), _held_out(jg.input_shape)
    want = jq.quantization_error(jq.quantize(jg, xs, method=method), held)
    pqg = tq.quantize(from_reference_graph(jg), xs, method=method,
                      device="cpu")
    assert pqg.method == method
    got = tq.quantization_error(pqg, held, device="cpu")
    assert abs(got["top1_agreement"] - want["top1_agreement"]) <= 0.01, (
        got, want)


def test_quantization_error_matches_jax_on_a_carried_qgraph():
    jqg, pqg = _carried("robot", xs=_camera((60, 80, 3)))
    held = _held_out((60, 80, 3))
    got = tq.quantization_error(pqg, held, device="cpu")
    want = jq.quantization_error(jqg, held)
    assert got["top1_agreement"] == want["top1_agreement"]
    np.testing.assert_allclose(got["max_abs_err"], want["max_abs_err"],
                               rtol=1e-4, atol=1e-6)


def test_default_calibrated_robot_keeps_top1():
    """The port's counterpart of the JAX suite's default-calibration
    regression: percentile on 32 camera frames, top-1 >= 0.99 on
    held-out frames."""
    s = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu"))
    assert s.qgraph.method == "percentile"
    stats = tq.quantization_error(s.qgraph, _held_out(s.input_shape),
                                  device="cpu")
    assert stats["top1_agreement"] >= 0.99, stats


# ------------------------------------------------------ data pipeline ----

@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 7, 1),
                                             (11, 2, 3)])
def test_data_pipeline_is_bit_identical(seed, step, shard):
    kw = dict(vocab_size=97, seq_len=12, global_batch=8, seed=seed,
              n_shards=4, shard=shard)
    want = jpipe.token_batch(jpipe.TokenStreamConfig(**kw), step)
    got = tpipe.token_batch(tpipe.TokenStreamConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    stream_t = tpipe.token_stream(tpipe.TokenStreamConfig(**kw), step)
    stream_j = jpipe.token_stream(jpipe.TokenStreamConfig(**kw), step)
    for _ in range(2):
        a, b = next(stream_t), next(stream_j)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for a, b in zip(tpipe.ball_image_batch(6, seed=seed, step=step),
                    jpipe.ball_image_batch(6, seed=seed, step=step)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a = tpipe.camera_frame_batch(5, (9, 7, 3), seed=seed)
    b = jpipe.camera_frame_batch(5, (9, 7, 3), seed=seed)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_prefetcher_yields_the_stream_in_order():
    items = list(tpipe.Prefetcher(iter(range(7)), depth=2))
    assert items == list(range(7))


# ---------------------------------------------------- session, server ----

def test_int8_session_equals_xla_int8_session_on_the_robot():
    """Bit for bit, both with the same calibration data (each package
    calibrates on its own float forward; on the robot the chosen ranges
    coincide) and with JAX's acts imported as qparams."""
    cal = _camera((60, 80, 3))
    jsess = JaxSession(JAX_NETS["robot"](0), config=JaxConfig(
        backend="xla", precision="int8", calibration={"data": cal}))
    sess = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration=CalibrationConfig(data=cal)))
    assert isinstance(sess.backend, QuantizedTorchBackend)
    assert sess.qgraph.method == jsess.qgraph.method == "minmax"
    xs = _frames(sess.input_shape, n=5, seed=9)
    want = jsess.predict(xs)
    np.testing.assert_array_equal(sess.predict(xs), want)
    np.testing.assert_array_equal(sess.predict(xs[0]), want[0])
    imported = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration=CalibrationConfig(qparams={
            n: (qp.scale, qp.zero_point)
            for n, qp in jsess.qgraph.acts.items()})))
    assert imported.qgraph.method == "provided"
    np.testing.assert_array_equal(imported.predict(xs), want)


@pytest.mark.parametrize("name", SOFTMAX_NETS)
def test_int8_session_close_to_xla_int8_session(name):
    cal = _camera(JAX_NETS[name](0).input_shape)
    jsess = JaxSession(JAX_NETS[name](0), config=JaxConfig(
        backend="xla", precision="int8", calibration={"data": cal}))
    sess = InferenceSession(NETS[name](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration={"qparams": {n: (qp.scale, qp.zero_point)
                                 for n, qp in jsess.qgraph.acts.items()}}))
    xs = _frames(sess.input_shape, n=5, seed=9)
    np.testing.assert_allclose(sess.predict(xs), jsess.predict(xs),
                               rtol=1e-5, atol=1e-6)


def test_int8_session_refuses_the_kernel_path_and_reports_int8_info():
    with pytest.raises(ValueError, match="int8"):
        InferenceSession(NETS["ball"](0), config=SessionConfig(
            backend="cuda", precision="int8", device="cpu"))
    xs = _frames((16, 16, 1), n=8)
    sess = InferenceSession(NETS["ball"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration={"data": xs, "method": "percentile",
                     "percentile": 99.9}))
    jsess = JaxSession(JAX_NETS["ball"](0), config=JaxConfig(
        backend="xla", precision="int8",
        calibration={"data": xs, "method": "percentile",
                     "percentile": 99.9}))
    info, jinfo = sess.info, jsess.info
    for key in ("quantized_layers", "calibration_method",
                "calibration_percentile"):
        assert info[key] == jinfo[key], key
    assert info["input_qparams"][1] == jinfo["input_qparams"][1]
    np.testing.assert_allclose(info["input_qparams"][0],
                               jinfo["input_qparams"][0], rtol=1e-6)
    assert info["precision"] == "int8" and info["simd_multiple"] == 1
    desc = sess.backend.describe()
    assert desc["name"] == "torch-int8" and desc["precision"] == "int8"
    assert "calibration_percentile" not in InferenceSession(
        NETS["ball"](0), config=SessionConfig(
            backend="torch", precision="int8", device="cpu",
            calibration={"data": xs})).info


def test_int8_session_builds_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        InferenceSession(NETS["ball"](0), config=SessionConfig(
            backend="torch", precision="int8"))


def test_session_config_with_calibration_round_trips():
    xs = _frames((16, 16, 1), n=4)
    cfg = SessionConfig(backend="torch", precision="int8", device="cpu",
                        calibration=CalibrationConfig(
                            data=xs, samples=8, method="mse",
                            percentile=99.5, per_channel=True))
    d = json.loads(json.dumps(cfg.to_dict()))
    assert d["calibration"] == {"samples": 8, "method": "mse",
                                "percentile": 99.5, "per_channel": True}
    back = SessionConfig.from_dict(d)
    assert back == cfg.portable()
    assert back.calibration.data is None
    assert cfg.portable().to_dict() == cfg.to_dict()
    plain = SessionConfig(device="cpu")
    assert plain.portable() is plain
    assert SessionConfig.from_dict(plain.to_dict()) == plain
    # the JAX config's calibration section reads back in the port
    jd = JaxConfig(precision="int8", calibration={
        "method": "entropy", "samples": 4}).to_dict()["calibration"]
    assert SessionConfig(calibration=jd).calibration == CalibrationConfig(
        method="entropy", samples=4)
    assert SessionConfig(calibration=xs).calibration.data is xs
    with pytest.raises(ValueError, match="calibration method"):
        CalibrationConfig(method="bogus")
    with pytest.raises(ValueError, match="percentile"):
        CalibrationConfig(percentile=0.0)
    with pytest.raises(ValueError, match="samples"):
        CalibrationConfig(samples=0)
    assert dataclasses.replace(cfg, precision="fp32").calibration.method \
        == "mse"


def test_served_int8_frames_equal_predict_bit_for_bit():
    """The integer sums are exact in any order, so a frame served in a
    batch of any size equals ``session.predict`` on it alone."""
    sess = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration={"samples": 8}))
    frames = _frames(sess.input_shape, n=64, seed=12)
    with InferenceServer(sess, config=ServerConfig(
            workers=2, max_batch=8, batch_deadline_ms=2.0)) as srv:
        handles = [srv.submit(f) for f in frames]
        outs = [h.result(timeout=60) for h in handles]
        st = srv.stats()
    assert st["completed"] == 64 and st["failed"] == 0, st
    assert st["batch_size_mean"] > 1, st
    for o, f in zip(outs, frames):
        np.testing.assert_array_equal(o, sess.predict(f))
