"""The decode step's attention on the CPU: the plain version that the
decode-attention kernel's wrapper runs for a CPU tensor against the JAX
package's ``decode_attention_jax`` over the kernel's cases, the kernel's
plan and scratch, and the stack's choice between the kernel and the
plain version, read from the calls of the kernel's stub with the caches
reporting a card (``is_cuda``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ops
from repro_torch.kernels import cases
from repro_torch.kernels.cases import (DECODE_ATOL, DECODE_ATTN_CASES,
                                       DECODE_FLIPS, DECODE_RTOL,
                                       check_decode)
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import lm, stack
from repro_torch.models.layers import ParamInit
from repro_torch.models.kernel_policy import (DEFAULT_KERNELS, PLAIN_KERNELS,
                                              TRAIN_KERNELS)
from repro_torch.models.par import Par
from repro_torch.models.stack import init_block, init_params


def _rnd(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("b,s,hkv,g,dh,ring,window,pos", DECODE_ATTN_CASES)
def test_plain_decode_attention_at_the_kernels_cases(b, s, hkv, g, dh, ring,
                                                     window, pos):
    """The wrapper's route for a CPU tensor is the plain
    ``decode_attention_ref`` bit for bit (fp32 and bf16, an int and a
    0-d tensor position) and, in fp32, JAX's ``decode_attention_jax`` at
    1e-4."""
    q = _rnd(1, (b, 1, hkv * g, dh))
    kc, vc = _rnd(2, (b, s, hkv, dh)), _rnd(3, (b, s, hkv, dh))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, kc, vc))
    got = ops.decode_attention(tq, tk, tv, pos, window=window, ring=ring)
    assert torch.equal(got, decode_attention_ref(tq, tk, tv, pos,
                                                 window=window, ring=ring))
    assert torch.equal(got, ops.decode_attention(
        tq, tk, tv, torch.tensor(pos), window=window, ring=ring))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.decode_attention_jax(
            q, kc, vc, jnp.int32(pos), window=window, ring=ring)),
        rtol=1e-4, atol=1e-4)
    bq, bk, bv = (a.bfloat16() for a in (tq, tk, tv))
    assert torch.equal(
        ops.decode_attention(bq, bk, bv, pos, window=window, ring=ring),
        decode_attention_ref(bq, bk, bv, pos, window=window, ring=ring))


@pytest.mark.parametrize("b,hkv,s", [(64, 16, 320), (1, 2, 32768),
                                     (2, 2, 4096), (4, 4, 1024), (2, 2, 1),
                                     (3, 5, 777), (64, 16, 4096)])
def test_decode_plan_covers_the_cache(b, hkv, s):
    """Chunks of at most 512 slots cover S once; one chunk where B * Hkv
    blocks fill the card (the benchmark's step: 64 x 16 rows of 320);
    the scratch holds the scores, two numbers a chunk and head, and with
    several chunks each chunk's output."""
    chunk, chunks = dk.decode_plan(b, hkv, s)
    assert 1 <= chunk <= dk.MAX_CHUNK
    assert (chunks - 1) * chunk < s <= chunks * chunk
    if b * hkv >= dk.TARGET_BLOCKS and s <= dk.MAX_CHUNK:
        assert chunks == 1
    g, dh = 2, 128
    parts = chunks * g * dh if chunks > 1 else 0
    assert dk.scratch_floats(b, hkv, s, g, dh) == b * hkv * (
        s * g + 2 * chunks * g + parts)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: the choice of
    ``ops.decode_attention`` reads ``is_cuda``, and nothing else of the
    device."""

    @property
    def is_cuda(self):
        return True


def _attn(cfg, kind):
    """An attention block's parameters, drawn from seed 0."""
    return init_block(ParamInit("cpu", torch.Generator().manual_seed(0)),
                      kind, cfg)["attn"]


@pytest.mark.parametrize("attention,dtype,on_card,taken", [
    ("flash_pallas", "bfloat16", True, True),
    ("flash_pallas", "float32", True, False),
    ("reference", "bfloat16", True, False),
    ("flash_jax", "bfloat16", True, False),
    ("flash_pallas", "bfloat16", False, False)])
@pytest.mark.parametrize("arch,kind", [("deepseek-moe-16b", "A"),
                                       ("gemma3-4b", "L")])
def test_decode_step_takes_the_kernel_only_for_bf16_caches_on_the_card(
        monkeypatch, arch, kind, attention, dtype, on_card, taken):
    """One attention block's decode step (T == 1): the kernel is called
    under ``"flash_pallas"`` with bf16 caches on the card alone, with
    the step's window and ring; the output is the plain version's in
    every case."""
    cfg = dataclasses.replace(ARCHS[arch].smoke(), dtype=dtype)
    pol = DEFAULT_KERNELS._replace(attention=attention)
    p = _attn(cfg, kind)
    calls = []

    def stub(q, k, v, pos, *, window=None, ring=False):
        calls.append((window, ring))
        return decode_attention_ref(
            q, k.as_subclass(torch.Tensor), v.as_subclass(torch.Tensor),
            pos, window=window, ring=ring)

    monkeypatch.setattr(ops, "decode_attention_cuda", stub)
    x = torch.from_numpy(_rnd(4, (2, 1, cfg.d_model))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    positions = torch.full((2, 1), 9)
    slots = 8 if kind == "L" else 16  # a ring of the window, or linear

    def run(card):
        cache = {n: torch.from_numpy(_rnd(5 + i, (2, slots, cfg.n_kv_heads,
                                                  cfg.head_dim))).to(x.dtype)
                 for i, n in enumerate(("k", "v"))}
        if card:
            cache = {n: a.as_subclass(_OnCard) for n, a in cache.items()}
        y = stack.attention_block(x, p, cfg, pol, kind, positions=positions,
                                  cache=cache, pos=9)
        return y.as_subclass(torch.Tensor)

    got = run(on_card)
    assert len(calls) == taken
    want = run(False)  # the plain version on plain CPU tensors
    assert len(calls) == taken
    assert torch.equal(got, want)
    if calls:
        ring = kind == "L"
        assert calls[0] == ((cfg.window if ring else None), ring)


class _HeadDimPar(Par):
    """One rank of a ``model`` axis of one under the head-dim rule: the
    split decode's code with every collective the identity."""
    model_n, model_rank = 1, 0

    def dense_split(self, kind):
        return "head_dim"

    def gather_out(self, x, dim):
        return x

    def model_sum(self, x):
        return x


def test_head_dim_decode_keeps_the_plain_version_on_the_card(monkeypatch):
    """The head-dim split sums partial scores over ``model`` before the
    softmax: the kernel cannot take them, so its step on the card never
    calls the kernel."""
    cfg = dataclasses.replace(ARCHS["deepseek-moe-16b"].smoke(),
                              dtype="bfloat16")
    p = _attn(cfg, "A")
    calls = []
    monkeypatch.setattr(ops, "decode_attention_cuda",
                        lambda *a, **kw: calls.append(a))
    x = torch.from_numpy(_rnd(4, (2, 1, cfg.d_model))).bfloat16()
    cache = {n: torch.zeros(2, 8, cfg.n_kv_heads, cfg.head_dim,
                            dtype=torch.bfloat16).as_subclass(_OnCard)
             for n in ("k", "v")}
    y = stack.attention_block(x, p, cfg, DEFAULT_KERNELS, "A",
                              positions=torch.full((2, 1), 0), cache=cache,
                              pos=0, par=_HeadDimPar())
    assert calls == []
    assert y.shape == x.shape


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-moe-16b",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("policy", [DEFAULT_KERNELS, PLAIN_KERNELS,
                                    TRAIN_KERNELS])
def test_cpu_decode_steps_are_the_plain_versions(monkeypatch, arch, policy):
    """On the CPU a bf16 decode step under every policy gives the logits
    and caches of the plain ``decode_attention_ref`` called directly
    (the stack as it was before the kernel), bit for bit, and never
    calls the kernel."""
    cfg = dataclasses.replace(ARCHS[arch].smoke(), dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, size=(2, 1)))

    def step():
        prefill = lm.make_prefill_step(cfg, 16, policy)
        decode = lm.make_decode_step(cfg, policy)
        with torch.inference_mode():
            _, caches, pos = prefill(params, {"tokens": torch.from_numpy(
                np.random.default_rng(8).integers(0, 256, size=(2, 11)))})
            logits, caches, _ = decode(params, caches, tokens,
                                       torch.tensor(pos))
        return logits, leaves(caches)

    calls = []
    monkeypatch.setattr(ops, "decode_attention_cuda",
                        lambda *a, **kw: calls.append(a))
    got, got_caches = step()
    assert calls == []
    monkeypatch.setattr(
        stack, "_decode_attention",
        lambda q, k, v, pos, pol, *, window, ring: decode_attention_ref(
            q, k, v, pos, window=window, ring=ring))
    want, want_caches = step()
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_caches, want_caches))


def test_check_decode_takes_one_unit_and_refuses_a_dropped_slot():
    """The kernel's tolerance on the CPU: the plain output passes itself
    and itself one bf16 unit off in one place, and fails against the
    output that leaves out the oldest attended slot."""
    b, s, hkv, g, dh, pos = 4, 64, 2, 2, 64, 40
    q, k, v = (torch.from_numpy(_rnd(i, shape)).bfloat16() for i, shape in
               enumerate(((b, 1, hkv * g, dh), (b, s, hkv, dh),
                          (b, s, hkv, dh))))
    want = decode_attention_ref(q, k, v, pos)
    assert check_decode(want, want, q, k, v, pos) == 0.0
    nudged = want.clone()
    nudged.view(torch.int16)[0, 0, 0, 0] += 1  # the next bf16 value
    assert check_decode(nudged, want, q, k, v, pos) > 0.0
    dropped = decode_attention_ref(q, k, v, pos, window=pos)
    with pytest.raises(AssertionError, match="bf16 unit"):
        check_decode(dropped, want, q, k, v, pos)


def test_check_decode_bounds_a_flip_by_the_largest_slot():
    """One output of 1,024 may lie one bf16 unit and up to
    ``DECODE_FLIPS`` of its largest ``2**-7 p_s |v_s|`` off, no further;
    every output one such move past one unit is too many."""
    b, s, hkv, g, dh, pos = 4, 64, 2, 2, 64, 40
    q, k, v = (torch.from_numpy(_rnd(i, shape)).bfloat16() for i, shape in
               enumerate(((b, 1, hkv * g, dh), (b, s, hkv, dh),
                          (b, s, hkv, dh))))
    want = decode_attention_ref(q, k, v, pos).float()
    tight = DECODE_RTOL * want.abs() + DECODE_ATOL
    flip = cases._largest_flip(q, k, v, pos, None, False)
    assert bool((flip > 0).all())
    for n, ok in ((DECODE_FLIPS - 1, True), (DECODE_FLIPS + 1, False)):
        got = want.clone()
        got[1, 0, 2, 7] += tight[1, 0, 2, 7] + n * flip[1, 0, 2, 7]
        if ok:
            check_decode(got, want, q, k, v, pos)
        else:
            with pytest.raises(AssertionError, match="bf16 unit"):
                check_decode(got, want, q, k, v, pos)
    with pytest.raises(AssertionError, match="bf16 unit"):
        check_decode(want + tight + flip, want, q, k, v, pos)
