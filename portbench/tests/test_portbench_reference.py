"""The plain reference against the port on the ``.smoke()`` shape (CPU,
float32): the program's prefill and decode logits, call by call, as the
check compares them."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness.weights import draw_params
from portbench.reference import common, moe


def _program_and_reference(cfg, fam, seed=11, b=5, t=12, n=6):
    from repro_torch.engine.backends import CudaLMBackend
    from repro_torch.models.stack import init_params
    params = draw_params(init_params(cfg, device="meta"), seed, "cpu")
    be = CudaLMBackend(cfg, params=params, max_context=t + n,
                       decode_batch=b, device="cpu")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)
    logits, handle = be.prefill(prompts)
    outs, toks = [logits], [logits.argmax(-1)]
    for _ in range(n - 1):
        step = be.decode(handle, toks[-1].astype(np.int32))
        outs.append(step)
        toks.append(step.argmax(-1))
    toks = np.stack(toks, 1)
    seq = torch.from_numpy(np.concatenate([prompts, toks[:, :-1]], 1)
                           .astype(np.int64))
    ref = fam.logits(params, dataclasses.asdict(cfg), seq, t - 1)
    prog = torch.from_numpy(np.stack(outs, 1))
    return params, seq, prog, ref


def _rel(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def _smoke(capacity_factor=None):
    from repro_torch.configs.lm_archs import ARCHS
    cfg = ARCHS["deepseek-moe-16b"].smoke()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


@pytest.mark.parametrize("capacity_factor", [None, 10.75, 1.25, 0.5])
def test_moe_reference_matches_the_port_only_where_nothing_drops(
        capacity_factor):
    """deepseek-moe-16b's ``.smoke()`` shape: dropless (the smoke
    default, and the benchmark's 10.75) the program equals the
    reference; where an expert's capacity drops slots (1.25 on the
    prompt's call, 0.5) it departs from it."""
    *_, prog, ref = _program_and_reference(_smoke(capacity_factor), moe)
    if capacity_factor in (None, 10.75):
        assert _rel(prog, ref) < 1e-5
    else:
        assert _rel(prog, ref) > 1e-2


def test_float8_control_is_far_from_the_reference():
    """The control path: the same reference with every linear layer's
    weights and inputs through float8 e4m3 reads far from float32."""
    cfg = _smoke()
    params, seq, prog, ref = _program_and_reference(cfg, moe)
    low = moe.logits(params, dataclasses.asdict(cfg), seq, 11,
                     quant=common.fp8)
    assert _rel(low, ref) > 1e3 * max(_rel(prog, ref), 1e-7)
    assert _rel(low, ref) > 0.02


def test_fp8_rounding():
    a = torch.tensor([[1.0, 0.3, -448.0], [2.0, 1.1, 0.0]])
    q = common.fp8(a, -1)
    assert q[0, 2] == -448.0 and q[1, 0] == 2.0 and q[1, 2] == 0.0
    assert 0 < float((q - a).abs().max()) < 0.1
