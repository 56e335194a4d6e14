"""Deterministic synthetic data pipelines (the port's copy of the JAX
package's ``data/pipeline.py``, numpy only).

Determinism contract (fault tolerance): every batch is a pure function
of ``(seed, step, shard_index)`` — any host can recompute any other
host's shard after a restart or topology change (straggler/elastic
story, DESIGN.md §9), and a resumed run consumes *exactly* the stream it
would have seen uninterrupted.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ModelConfig  # noqa: F401  (kept from the source)


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def token_batch(tc: TokenStreamConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens with learnable structure (so training
    loss visibly falls): token_{t+1} = (a * token_t + b) % V with noise."""
    assert tc.global_batch % tc.n_shards == 0
    b_local = tc.global_batch // tc.n_shards
    rng = _rng_for(tc.seed, step, tc.shard)
    V = tc.vocab_size
    a = 31
    start = rng.integers(0, V, (b_local, 1))
    steps = np.arange(tc.seq_len + 1)
    seq = (start * pow(a, 1, V) + 0)  # placeholder, filled below
    seq = np.empty((b_local, tc.seq_len + 1), np.int64)
    seq[:, 0] = start[:, 0]
    noise = rng.random((b_local, tc.seq_len)) < 0.05
    rand_tok = rng.integers(0, V, (b_local, tc.seq_len))
    for t in range(tc.seq_len):
        nxt = (seq[:, t] * a + 7) % V
        seq[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def token_stream(tc: TokenStreamConfig, start_step: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield token_batch(tc, step)
        step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering — overlap host data
    generation with device compute)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: Queue = Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


# ------------------------------------------------------ synthetic balls -----

def ball_image_batch(n: int, *, res: int = 16, seed: int = 0, step: int = 0):
    """Procedural stand-in for the paper's RoboCup ball dataset: white
    discs with dark spots on noisy background vs. pure noise/edges.
    Returns (images (n,res,res,1) float32 in [0,1], labels (n,) {0,1})."""
    rng = _rng_for(seed, step, 0)
    labels = rng.integers(0, 2, n)
    imgs = rng.normal(0.35, 0.15, (n, res, res, 1)).astype(np.float32)
    yy, xx = np.mgrid[0:res, 0:res]
    for i in range(n):
        if labels[i]:
            cx, cy = rng.uniform(res * 0.3, res * 0.7, 2)
            r = rng.uniform(res * 0.25, res * 0.45)
            disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < r ** 2
            imgs[i, :, :, 0][disc] = rng.uniform(0.8, 1.0)
            n_spots = rng.integers(2, 5)
            for _ in range(n_spots):
                sx, sy = rng.uniform(cx - r / 2, cx + r / 2), \
                         rng.uniform(cy - r / 2, cy + r / 2)
                spot = ((xx - sx) ** 2 + (yy - sy) ** 2) < (r / 4) ** 2
                imgs[i, :, :, 0][spot & disc] = rng.uniform(0.0, 0.2)
        else:
            # distractor: bright edge/corner blob (not a disc)
            if rng.random() < 0.5:
                w = rng.integers(2, 6)
                imgs[i, :w, :, 0] += rng.uniform(0.4, 0.6)
    return np.clip(imgs, 0, 1), labels.astype(np.int32)


def camera_frame_batch(n: int, shape, *, seed: int = 0,
                       blur_passes: int = 2, blur_k: int = 5) -> np.ndarray:
    """Synthetic camera-like frames for int8 calibration: smooth,
    bounded [0, 1] images with per-frame brightness/contrast jitter.

    The paper's CNNs consume camera images; calibrating activation
    ranges on unbounded white noise (the old benchmark default) is
    unrepresentative of deployment and inflates every per-tensor range.
    These frames are spatially-correlated uniform noise (separable box
    blur), contrast-stretched per frame, then gain/offset-jittered so
    the calibration set covers a spread of exposure conditions.
    Deterministic in ``(seed)``; returns ``(n, *shape)`` float32."""
    rng = _rng_for(seed, 0, 1)
    h, w, c = shape
    imgs = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    half = blur_k // 2
    for _ in range(blur_passes):
        # separable box blur via padded cumulative sums (no scipy dep)
        s = np.cumsum(np.pad(imgs, ((0, 0), (half + 1, half), (0, 0),
                                    (0, 0)), mode="edge"), axis=1)
        imgs = (s[:, blur_k:] - s[:, :-blur_k]) / blur_k
        s = np.cumsum(np.pad(imgs, ((0, 0), (0, 0), (half + 1, half),
                                    (0, 0)), mode="edge"), axis=2)
        imgs = (s[:, :, blur_k:] - s[:, :, :-blur_k]) / blur_k
    mn = imgs.min(axis=(1, 2, 3), keepdims=True)
    mx = imgs.max(axis=(1, 2, 3), keepdims=True)
    imgs = (imgs - mn) / np.maximum(mx - mn, 1e-6)
    gain = rng.uniform(0.6, 1.0, (n, 1, 1, 1)).astype(np.float32)
    offset = rng.uniform(0.0, 0.3, (n, 1, 1, 1)).astype(np.float32)
    return np.clip(imgs * gain + offset, 0.0, 1.0).astype(np.float32)
