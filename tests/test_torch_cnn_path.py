"""The port's executors against the JAX package's on all four nets.

``torch_exec.forward`` is held to ``jax_exec.forward`` and
``torch_exec.forward_kernels`` to ``jax_exec.forward_pallas`` (Pallas in
interpret mode), raw and optimized, at batch 1 and 2, at rtol 1e-4 /
atol 1e-5 — the tolerance of ``tests/test_pallas_cnn_path.py``.  The
weights are carried across with ``from_reference_graph``; inputs come
from a numpy seed.  On the CPU the port's kernel path runs the plain
versions of its kernels; ``test_torch_cuda.py`` runs the CUDA kernels.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn_paper as jnets
from repro.core import jax_exec
from repro.core import passes as jpasses
from repro_torch.configs import cnn_paper as tnets
from repro_torch.core import passes, torch_exec
from repro_torch.core.graph import from_reference_graph

NETS = ["ball", "pedestrian", "robot", "residual"]
BUILDERS = {"ball": "ball_classifier", "pedestrian": "pedestrian_classifier",
            "robot": "robot_detector", "residual": "residual_cnn"}
WEIGHT_FIELDS = ("weights", "bias", "mean", "var", "gamma", "beta")


def _graphs(name, optimized):
    g = getattr(jnets, BUILDERS[name])(0)
    if optimized:
        g = jpasses.optimize(g, simd_multiple=4)
    return g, from_reference_graph(g)


def _frames(g, batch):
    return np.random.default_rng(5).normal(
        size=(batch,) + tuple(g.input_shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_out(name, optimized, fn):
    """The JAX executor ``fn`` on two frames, or the NotImplementedError
    it raises; computed once per net and shared by the batch-1 case
    (its first frame) and the batch-2 case."""
    jg, _ = _graphs(name, optimized)
    try:
        return np.asarray(getattr(jax_exec, fn)(jg, jnp.asarray(
            _frames(jg, 2))))
    except NotImplementedError as e:
        return e


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("optimized", [False, True], ids=["raw", "opt"])
@pytest.mark.parametrize("name", NETS)
def test_forward_matches_jax(name, optimized, batch):
    jg, tg = _graphs(name, optimized)
    want = _jax_out(name, optimized, "forward")[:batch]
    got = torch_exec.forward(tg, torch.from_numpy(_frames(jg, 2)[:batch]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("optimized", [False, True], ids=["raw", "opt"])
@pytest.mark.parametrize("name", NETS)
def test_forward_kernels_matches_forward_pallas(name, optimized, batch):
    """Same results, and the same refusal: a raw graph with BatchNorm,
    Dropout, Dense or Flatten raises NotImplementedError on both sides."""
    jg, tg = _graphs(name, optimized)
    want = _jax_out(name, optimized, "forward_pallas")
    x = torch.from_numpy(_frames(jg, 2)[:batch])
    if isinstance(want, NotImplementedError):
        with pytest.raises(NotImplementedError, match="passes.optimize"):
            torch_exec.forward_kernels(tg, x)
        return
    got = torch_exec.forward_kernels(tg, x).numpy()
    np.testing.assert_allclose(got, want[:batch], rtol=1e-4, atol=1e-5)


def _window_graph():
    """The window layers no kernel covers: a strided depthwise conv and
    ``same``-padded max and average pools with overlapping windows."""
    from repro.core import graph as jgraph
    rng = np.random.default_rng(9)
    return jgraph.CNNGraph([
        jgraph.Input(shape=(11, 9, 3)),
        jgraph.Conv2D(weights=rng.normal(size=(3, 3, 3, 4)) * 0.3,
                      bias=rng.normal(size=4), padding="same",
                      activation="relu"),
        jgraph.DepthwiseConv2D(weights=rng.normal(size=(3, 3, 4, 2)) * 0.3,
                               bias=rng.normal(size=8), strides=(2, 1),
                               padding="same", activation="leaky_relu"),
        jgraph.MaxPool(size=(3, 3), strides=(1, 2), padding="same"),
        jgraph.AvgPool(size=(3, 2), strides=(2, 2), padding="same"),
        jgraph.Conv2D(weights=rng.normal(size=(1, 1, 8, 3)) * 0.3,
                      padding="valid", activation="softmax"),
    ])


def test_window_layers_without_a_kernel_match_forward_pallas():
    jg = _window_graph()
    x = _frames(jg, 2)
    want = np.asarray(jax_exec.forward_pallas(jg, jnp.asarray(x)))
    tg = from_reference_graph(jg)
    got = torch_exec.forward_kernels(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_kernel_path_calls_no_library_convolution_or_pooling(monkeypatch):
    graphs = [passes.optimize(getattr(tnets, b)(0), simd_multiple=4)
              for b in BUILDERS.values()]
    graphs.append(from_reference_graph(_window_graph()))
    xs = [torch.from_numpy(_frames(g, 2)) for g in graphs]
    want = [torch_exec.forward(g, x) for g, x in zip(graphs, xs)]

    def refuse(*args, **kwargs):
        raise AssertionError("library call on the kernel path")

    for name in ("conv2d", "max_pool2d", "avg_pool2d"):
        monkeypatch.setattr(torch.nn.functional, name, refuse)
    for g, x, w in zip(graphs, xs, want):
        np.testing.assert_allclose(torch_exec.forward_kernels(g, x).numpy(),
                                   w.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="library call"):
        torch_exec.forward(graphs[0], xs[0])


@pytest.mark.parametrize("name", NETS)
def test_from_reference_graph_carries_weights_bit_for_bit(name):
    ref = getattr(jnets, BUILDERS[name])(0)
    carried = from_reference_graph(ref)
    own = getattr(tnets, BUILDERS[name])(0)
    assert [type(l).__name__ for l in carried.layers] == \
        [type(l).__name__ for l in ref.layers] == \
        [type(l).__name__ for l in own.layers]
    for r, c, o in zip(ref.layers, carried.layers, own.layers):
        assert c.name == r.name == o.name and c.inputs == r.inputs
        for f in WEIGHT_FIELDS:
            if hasattr(r, f):
                np.testing.assert_array_equal(getattr(c, f), getattr(r, f))
                np.testing.assert_array_equal(getattr(o, f), getattr(r, f))
                assert getattr(c, f) is not getattr(r, f)


@pytest.mark.parametrize("name", NETS)
def test_port_passes_match_reference_passes(name):
    ref = jpasses.optimize(getattr(jnets, BUILDERS[name])(0))
    own = passes.optimize(getattr(tnets, BUILDERS[name])(0))
    assert [(type(l).__name__, l.name, l.inputs) for l in own.layers] == \
        [(type(l).__name__, l.name, l.inputs) for l in ref.layers]
    for r, o in zip(ref.layers, own.layers):
        for f in WEIGHT_FIELDS + ("activation",):
            if hasattr(r, f):
                np.testing.assert_array_equal(getattr(o, f), getattr(r, f))


def test_forward_kernels_refuses_unoptimized_graph():
    g = tnets.robot_detector(0)  # BatchNorm not folded
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        torch_exec.forward_kernels(
            g, torch.zeros((1,) + tuple(g.input_shape)))


def test_params_round_trip_and_module():
    g = passes.optimize(tnets.residual_cnn(0))
    params = torch_exec.extract_params(g)
    g2 = torch_exec.insert_params(g, params)
    for a, b in zip(g.layers, g2.layers):
        if hasattr(a, "weights"):
            np.testing.assert_array_equal(a.weights, b.weights)
    x = torch.from_numpy(_frames(g, 2))
    mod = torch_exec.CNNModule(g, device="cpu", kernels=True)
    np.testing.assert_allclose(
        mod(x).numpy(), torch_exec.forward(g, x, params).numpy(),
        rtol=1e-5, atol=1e-6)
    assert len(mod.state_dict()) == 2 * len(params)


def test_forward_with_params_is_differentiable():
    g = passes.optimize(tnets.ball_classifier(0))
    params = {k: {n: t.clone().requires_grad_() for n, t in p.items()}
              for k, p in torch_exec.extract_params(g).items()}
    y = torch_exec.forward_with_params(
        g, params, torch.from_numpy(_frames(g, 2)))
    y[..., 0].sum().backward()
    for p in params.values():
        assert p["w"].grad is not None and p["w"].grad.abs().sum() > 0


def test_predict_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tnets.ball_classifier(0)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_exec.predict(g, _frames(g, 1))
    y = torch_exec.predict(g, _frames(g, 1)[0], device="cpu")
    assert y.shape == tuple(g.output_shape)
