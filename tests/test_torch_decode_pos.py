"""The decode step with its position on the device (the form the card
captures in a CUDA graph) against the int position and against the JAX
package's ``make_decode_step``, and the two repairs that let the step be
captured: ``mrope``'s section ids and ``embed_tokens``' scale, each
built on the device with no host copy.

Tensor and int positions are held bit for bit (logits and every cache
tensor); both to JAX at the tolerance of
``tests/test_torch_lm_model.py``'s decode test, 1e-4 (fp32 sums in
another order through every layer of a smoke config).  ``mrope`` keeps
its parent's numbers bit for bit and its section ids are JAX's exactly;
its rotation matches JAX's at 1e-5, the module tolerance, since XLA's and
PyTorch's ``cos``, ``sin`` and ``pow`` differ in the last bit (2.4e-7).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.stack import DEFAULT_PAR
from repro.models.stack import init_params as jax_init_params
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.core.tree import leaves
from repro_torch.models import layers, lm

DECODING = sorted(a for a, c in ARCHS.items() if not c.is_encoder)


def _perturbed(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(
            a.dtype), jax_init_params(cfg, jax.random.PRNGKey(0)))


def _inputs(cfg, rng, t):
    """A (2, t) batch of tokens, or of embeddings for a config that takes
    them, as (jax, torch) pairs."""
    if cfg.embed_inputs:
        a = rng.integers(0, cfg.vocab_size, size=(2, t))
        return jnp.asarray(a, jnp.int32), torch.from_numpy(a)
    a = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("arch,prompt", [(a, 12) for a in DECODING]
                         + [("gemma3-4b", 5), ("h2o-danube-3-4b", 5)])
def test_device_position_decode_is_the_int_decode_and_jaxs(arch, prompt):
    """Six decode steps.  Prompt 12 is past the smoke window of 8, so the
    ring caches have wrapped before decode; prompt 5 wraps during it."""
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = _perturbed(jcfg)
    tparams = lm.from_jax_params(cfg, params)
    rng = np.random.default_rng(3)
    key = "tokens" if cfg.embed_inputs else "embeds"
    jtok, ttok = _inputs(cfg, rng, prompt)
    want, jcache, jpos = jax.jit(jlm.make_prefill_step(jcfg, 32))(
        params, {key: jtok})
    prefill = lm.make_prefill_step(cfg, 32)
    _, cache_i, pos_i = prefill(tparams, {key: ttok})
    got, cache_t, pos_t = prefill(tparams, {key: ttok})
    pos_t = torch.tensor(pos_t)
    jdec = jax.jit(jlm.make_decode_step(jcfg))
    decode = lm.make_decode_step(cfg)
    for step in range(6):
        if cfg.embed_inputs:
            nxt = np.array(jnp.argmax(want, -1), np.int64)[:, None]
            jin, tin = jnp.asarray(nxt, jnp.int32), torch.from_numpy(nxt)
        else:
            jin, tin = _inputs(cfg, rng, 1)
        want, jcache, jpos = jdec(params, jcache, jin, jpos)
        got_i, cache_i, pos_i = decode(tparams, cache_i, tin, pos_i)
        got, cache_t, pos_t = decode(tparams, cache_t, tin, pos_t)
        assert isinstance(pos_i, int) and isinstance(pos_t, torch.Tensor)
        assert pos_t.dtype == torch.int64 and pos_t.dim() == 0
        assert int(pos_t) == pos_i == int(jpos) == prompt + 1 + step
        assert torch.equal(got, got_i), step
        assert all(torch.equal(a, b) for a, b in zip(leaves(cache_t),
                                                     leaves(cache_i)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_device_position_decode_takes_a_bf16_model():
    """The bf16 gemma3 smoke config: tensor and int positions agree bit
    for bit (the cache write through ``index_copy_`` keeps the type)."""
    cfg = replace(ARCHS["gemma3-4b"].smoke(), dtype="bfloat16")
    from repro_torch.models.stack import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, size=(2, 10)))
    prefill, decode = lm.make_prefill_step(cfg, 24), lm.make_decode_step(cfg)
    with torch.inference_mode():
        out = [prefill(params, {"tokens": toks}) for _ in range(2)]
        (li, ci, pi), (lt, ct, pt) = out
        pt = torch.tensor(pt)
        for _ in range(4):
            tok = li.argmax(-1)[:, None]
            li, ci, pi = decode(params, ci, tok, pi)
            lt, ct, pt = decode(params, ct, tok, pt)
            assert torch.equal(li, lt)
            assert all(torch.equal(a, b) for a, b in zip(leaves(ci),
                                                         leaves(ct)))


# --------------------------------------------------------- the repairs ----

def _parent_mrope(x, positions3, sections, theta=1e4):
    """``mrope`` as it stood before the repair: the section ids through
    ``repeat_interleave`` with a repeats tensor (a host round trip)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    sec_id = torch.repeat_interleave(torch.arange(3),
                                     torch.tensor(sections))
    pos = positions3.float()[sec_id]
    return layers._rotate(x, pos.permute(1, 2, 0) * freqs)


def _parent_embed(params, cfg, tokens):
    x = params["embed"][tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24), (0, 4, 4),
                                      (5, 0, 3)])
def test_mrope_section_ids_are_jaxs_and_the_parents(sections):
    half = sum(sections)
    ids = layers.section_ids(sections, "cpu")
    want = jnp.repeat(jnp.arange(3), jnp.array(sections),
                      total_repeat_length=half)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert torch.equal(ids, torch.repeat_interleave(
        torch.arange(3), torch.tensor(sections)))
    rng = np.random.default_rng(half)
    x = rng.normal(size=(2, 5, 4, 2 * half)).astype(np.float32)
    pos3 = rng.integers(0, 3000, size=(3, 2, 5))
    got = layers.mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections)
    assert torch.equal(got, _parent_mrope(torch.from_numpy(x),
                                          torch.from_numpy(pos3), sections))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.mrope(x, jnp.asarray(pos3, jnp.int32),
                                              sections)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-vl-72b", "rwkv6-7b",
                                  "deepseek-moe-16b"])
def test_embed_tokens_scale_is_the_parents_and_jaxs(arch, dtype):
    """The scale filled on the device is the parent's host scalar and
    JAX's ``jnp.asarray(sqrt(d), dtype)``, bit for bit: the smoke width
    and the arch's own d_model (whose square root rounds differently)."""
    for d_model in (64, ARCHS[arch].d_model):
        cfg = replace(ARCHS[arch].smoke(), dtype=dtype, d_model=d_model)
        jcfg = replace(JAX_ARCHS[arch].smoke(), dtype=dtype, d_model=d_model)
        rng = np.random.default_rng(d_model)
        emb = rng.normal(size=(32, d_model)).astype(np.float32)
        toks = rng.integers(0, 32, size=(2, 7))
        jemb = jnp.asarray(emb, jnp.dtype(dtype))
        params = {"embed": torch.from_numpy(emb).to(
            getattr(torch, dtype))}
        got = lm.embed_tokens(params, cfg, torch.from_numpy(toks))
        assert torch.equal(got, _parent_embed(params, cfg,
                                              torch.from_numpy(toks)))
        want = jlm.embed_tokens({"embed": jemb}, jcfg,
                                jnp.asarray(toks, jnp.int32), DEFAULT_PAR)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
