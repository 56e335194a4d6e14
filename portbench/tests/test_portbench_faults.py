"""A whole run on the CPU at the ``.smoke()`` size, the look for a card
skipped, with the timed path broken underneath: ``correct`` must come
out false for every fault a serving cell can have, and true without
one.  The limits are the cells' own."""
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, smoke_cell
from portbench.harness.bench import Bench
from portbench.harness.cell import run_cell

CELLS = [w["name"] for w in Bench(ROOT).spec["workloads"]]


def token_altered(backend):
    """A decode step's logits changed so that one row's token is another
    (the program serves and feeds the changed token)."""
    decode = backend.decode

    def broken(handle, tokens):
        out = np.array(decode(handle, tokens))
        worst = int(out[0].argmin())
        out[0, worst] = out[0].max() + 1.0
        return out
    backend.decode = broken


def state_unchanged(backend):
    """A decode step that returns its state unchanged: the caches and the
    position as they were before it."""
    decode = backend.decode

    def broken(handle, tokens):
        saved = [t.clone() for t in _tensors(handle.caches)]
        pos = handle.pos
        out = decode(handle, tokens)
        for dst, src in zip(_tensors(handle.caches), saved):
            dst.copy_(src)
        handle.pos = pos
        return out
    backend.decode = broken


def half_batch(backend):
    """Half of the batch left out: the second half's rows get the first
    half's answers."""
    generate = backend.generate

    def broken(prompts, max_new):
        half = max(1, len(prompts) // 2)
        out = generate(prompts[:half], max_new)
        return np.concatenate([out, out[:len(prompts) - half]])[
            :len(prompts)]
    backend.generate = broken


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def _run(cell, fault=None, seed=2**31 + 99):
    return run_cell(Bench(ROOT), smoke_cell(cell), seed, 2.0, False,
                    t_process=time.perf_counter(), device="cpu", smoke=True,
                    fault=fault, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s", "request_latency_p95_ms"}


@pytest.mark.parametrize("fault", [token_altered, state_unchanged,
                                   half_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert not out["correct"], (fault.__name__, out["checks"])
