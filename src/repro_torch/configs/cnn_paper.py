"""The paper's three evaluation CNNs (Tables I, II, III) and the residual
DAG, PyTorch port.

The port's own copy of the JAX package's ``configs/cnn_paper.py``
builders: the same numpy RNG calls in the same order, so every weight
is bit-identical to the reference's for the same seed, and its ball
trainer (:func:`trained_ball_classifier`), which trains on the caller's
device, the card by default.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import (
    Add,
    AvgPool,
    BatchNorm,
    CNNGraph,
    Concat,
    Conv2D,
    DepthwiseConv2D,
    Dropout,
    GlobalAvgPool,
    Input,
    LeakyReLU,
    MaxPool,
    ReLU,
    Softmax,
)


def _conv(rng, kh, kw, ci, co, **kw_args) -> Conv2D:
    fan_in = kh * kw * ci
    w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(kh, kw, ci, co))
    b = rng.normal(0.0, 0.01, size=(co,))
    return Conv2D(weights=w.astype(np.float32), bias=b.astype(np.float32),
                  **kw_args)


def _bn(rng, c) -> BatchNorm:
    return BatchNorm(
        mean=rng.normal(0, 0.5, c), var=rng.uniform(0.5, 1.5, c),
        gamma=rng.uniform(0.8, 1.2, c), beta=rng.normal(0, 0.1, c))


def ball_classifier(seed: int = 0) -> CNNGraph:
    """Paper Table I — 16x16x1 ball/no-ball classifier."""
    r = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(16, 16, 1)),
        _conv(r, 5, 5, 1, 8, strides=(2, 2), padding="same"),
        ReLU(),
        MaxPool(size=(2, 2), strides=(2, 2)),
        _conv(r, 3, 3, 8, 12, padding="valid"),
        ReLU(),
        _conv(r, 2, 2, 12, 2, padding="valid"),
        Softmax(),
    ])


def pedestrian_classifier(seed: int = 0) -> CNNGraph:
    """Paper Table II — 36x18 (Daimler) pedestrian classifier."""
    r = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(36, 18, 1)),
        _conv(r, 3, 3, 1, 12, padding="same"),
        ReLU(),
        MaxPool(size=(2, 2)),
        _conv(r, 3, 3, 12, 32, padding="same"),
        LeakyReLU(alpha=0.1),
        MaxPool(size=(2, 2)),
        _conv(r, 3, 3, 32, 64, padding="same"),
        LeakyReLU(alpha=0.1),
        MaxPool(size=(2, 2)),
        Dropout(rate=0.3),
        _conv(r, 4, 2, 64, 2, padding="valid"),
        Softmax(),
    ])


def robot_detector(seed: int = 0) -> CNNGraph:
    """Paper Table III — 60x80x3 YOLO-style robot detector backbone."""
    r = np.random.default_rng(seed)
    layers = [Input(shape=(60, 80, 3))]

    def block(ci, co, pool):
        layers.append(_conv(r, 3, 3, ci, co, padding="same"))
        layers.append(_bn(r, co))
        layers.append(LeakyReLU(alpha=0.1))
        if pool:
            layers.append(MaxPool(size=(2, 2)))

    block(3, 8, pool=True)
    block(8, 12, pool=False)
    block(12, 8, pool=True)
    block(8, 16, pool=False)
    block(16, 20, pool=False)
    return CNNGraph(layers)


def _dwconv(rng, kh, kw, c, mult, **kw_args) -> DepthwiseConv2D:
    fan_in = kh * kw
    w = rng.normal(0.0, np.sqrt(2.0 / fan_in), size=(kh, kw, c, mult))
    b = rng.normal(0.0, 0.01, size=(c * mult,))
    return DepthwiseConv2D(weights=w.astype(np.float32),
                           bias=b.astype(np.float32), **kw_args)


def residual_cnn(seed: int = 0) -> CNNGraph:
    """A small ResNet/MobileNet-style DAG (not from the paper): a
    depthwise-separable block with a residual Add, a two-branch Concat,
    and a global-average-pool head.  Exercises every non-sequential
    construct the DAG IR supports, end-to-end through codegen."""
    r = np.random.default_rng(seed)
    return CNNGraph([
        Input(shape=(16, 16, 3), name="in"),
        _conv(r, 3, 3, 3, 8, padding="same", name="stem"),
        ReLU(name="stem_relu"),
        # depthwise-separable residual block on the stem features
        _dwconv(r, 3, 3, 8, 1, padding="same", name="dw",
                inputs=["stem_relu"]),
        ReLU(name="dw_relu"),
        _conv(r, 1, 1, 8, 8, padding="valid", name="pw", inputs=["dw_relu"]),
        Add(name="res_add", inputs=["pw", "stem_relu"]),
        ReLU(name="res_relu"),
        # two-branch feature mix, channel-concatenated
        _conv(r, 1, 1, 8, 4, padding="valid", name="branch_1x1",
              inputs=["res_relu"]),
        _conv(r, 3, 3, 8, 4, padding="same", name="branch_3x3",
              inputs=["res_relu"]),
        Concat(name="mix", inputs=["branch_1x1", "branch_3x3"]),
        AvgPool(size=(2, 2), name="pool"),
        GlobalAvgPool(name="gap"),
        _conv(r, 1, 1, 8, 4, padding="valid", name="head"),
        Softmax(name="probs"),
    ])


def trained_ball_classifier(steps: int = 150, *, seed: int = 0,
                            learning_rate: float = 3e-3, batch: int = 64,
                            eval_n: int = 2000, log=None, device=None):
    """The Table-I ball net *trained* on the synthetic ball dataset.

    The reference's trainer step for step: AdamW (no weight decay) on
    the log-softmax NLL of ``logits[:, 0, 0, :]``, the batches
    ``ball_image_batch(batch, seed=0, step=i)``, plain
    :func:`~repro_torch.core.torch_exec.forward` convolutions through
    autograd (the reference trains through XLA convolutions, not the
    conv2d kernel), on ``device`` (the card unless the caller names
    another; its convolutions in full fp32).  Deterministic in
    ``(steps, seed)``.  Returns ``(graph, accuracy)`` with the trained
    weights inserted and the accuracy on ``ball_image_batch(eval_n,
    seed=99)``."""
    import torch

    from repro_torch.core import torch_exec
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import ball_image_batch
    from repro_torch.optim import AdamW

    dev = torch_exec.resolve_device(device)
    torch_exec.use_fp32_convolutions(dev)
    graph = ball_classifier(seed=seed)
    params = torch_exec.extract_params(graph, dev)
    opt = AdamW(learning_rate=learning_rate, weight_decay=0.0)
    opt_state = opt.init(params)

    def logits(p, x):
        return torch_exec.forward_with_params(graph, p, x)[:, 0, 0, :]

    for i in range(steps):
        xs, ys = ball_image_batch(batch, seed=0, step=i)
        x = torch.from_numpy(xs).to(dev)
        y = torch.from_numpy(ys).to(dev).long()
        p = tree_map(lambda a: a.detach().requires_grad_(), params)
        logp = torch.log_softmax(logits(p, x), dim=-1)
        loss = -torch.gather(logp, 1, y[:, None]).mean()
        loss.backward()
        grads = tree_map(lambda a: a.grad, p)
        up, opt_state = opt.update(grads, opt_state, params)
        params = tree_map(lambda a, u: a + u, params, up)
        if log is not None and (i + 1) % 50 == 0:
            log(f"  step {i + 1}: loss {float(loss.detach()):.4f}")

    xs, ys = ball_image_batch(eval_n, seed=99, step=0)
    with torch.no_grad():
        pred = logits(params, torch.from_numpy(xs).to(dev)).argmax(-1)
    acc = float((pred.cpu() == torch.from_numpy(ys)).float().mean())
    return torch_exec.insert_params(graph, params), acc


PAPER_CNNS = {
    "ball": ball_classifier,
    "pedestrian": pedestrian_classifier,
    "robot": robot_detector,
}

# non-paper workloads the engine also serves; kept out of PAPER_CNNS so
# paper-table parametrizations stay exactly the paper's three nets
EXTRA_CNNS = {
    "residual": residual_cnn,
}
