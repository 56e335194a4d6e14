"""The port's LM stack (``repro_torch.models``) against the JAX package's
``repro.models`` on the same inputs and weights.

Inputs come from numpy seeds; weights are the JAX ``init_params`` tree
with numpy noise added to every leaf (so zero-initialized biases, norm
scales and the RWKV u-bonus matter), carried across with
``from_jax_params``.  Both sides run in fp32 on the CPU.  Tolerances:
each module 1e-5 (fp32 sums in another order), whole-model logits 1e-4
(the same, through every layer of a smoke config).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.kernel_policy import KernelPolicy as JaxKernelPolicy
from repro.models.stack import DEFAULT_PAR
from repro.models.stack import init_params as jax_init_params
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.kernels.ref import attention_ref, decode_attention_ref
from repro_torch.models import layers, lm, ssm
from repro_torch.models.kernel_policy import DEFAULT_KERNELS, PLAIN_KERNELS
from repro_torch.models.stack import init_cache, init_params

COVERED = ["gemma3-4b", "gemma3-27b", "h2o-danube-3-4b", "qwen1.5-110b",
           "qwen2-vl-72b", "hubert-xlarge", "rwkv6-7b", "deepseek-moe-16b",
           "grok-1-314b", "zamba2-2.7b"]
POLICIES = {"kernels": DEFAULT_KERNELS, "plain": PLAIN_KERNELS}


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def perturbed_jax_params(cfg, seed=1):
    """The JAX ``init_params`` of ``cfg`` plus N(0, 0.05) noise on every
    leaf, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.normal(size=a.shape)).astype(
            a.dtype), jax_init_params(cfg, jax.random.PRNGKey(0)))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- modules ----

def test_norms_match():
    x, s, b = _rnd(0, (2, 5, 64)), _rnd(1, (64,), 0.3), _rnd(2, (64,), 0.3)
    xt, st, bt = (torch.from_numpy(a) for a in (x, s, b))
    _close(layers.rms_norm(xt, st), jlayers.rms_norm(x, s), 1e-5)
    _close(layers.layer_norm(xt, st, bt), jlayers.layer_norm(x, s, b), 1e-5)
    xh = x.reshape(2, 5, 4, 16)
    _close(layers.group_norm_heads(torch.from_numpy(xh),
                                   st.reshape(4, 16)),
           jlayers.group_norm_heads(xh, s.reshape(4, 16)), 1e-5)


@pytest.mark.parametrize("rope_dim", [None, 12])
def test_rope_matches(rope_dim):
    x = _rnd(3, (2, 7, 4, 16))
    pos = np.random.default_rng(4).integers(0, 200, size=(2, 7))
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       rope_dim),
           jlayers.rope(x, jnp.asarray(pos, jnp.int32), 1e6, rope_dim), 1e-5)


def test_mrope_matches():
    x = _rnd(5, (2, 6, 4, 16))
    pos3 = np.random.default_rng(6).integers(0, 50, size=(3, 2, 6))
    _close(layers.mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                        (2, 3, 3)),
           jlayers.mrope(x, jnp.asarray(pos3, jnp.int32), (2, 3, 3)), 1e-5)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_gated_mlp_matches(act, gated):
    x = _rnd(7, (2, 5, 32))
    p = {"wg": _rnd(8, (32, 48), 0.2), "wd": _rnd(9, (48, 32), 0.2)}
    if gated:
        p["wu"] = _rnd(10, (32, 48), 0.2)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(layers.gated_mlp(torch.from_numpy(x), pt, act),
           jlayers.gated_mlp(x, p, act), 1e-5)


@pytest.mark.parametrize("ring,window,pos", [
    (False, None, 5), (False, 4, 9), (True, 8, 5), (True, 8, 21)])
def test_decode_attention_matches(ring, window, pos):
    """One new token against a plain cache, or a ring of 8 slots before
    and after it wraps (position 21 is past two turns)."""
    s = 8 if ring else 12
    q = _rnd(11, (2, 1, 4, 16))
    kc, vc = _rnd(12, (2, s, 2, 16)), _rnd(13, (2, s, 2, 16))
    got = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), pos, window=window,
                               ring=ring)
    _close(got, jlayers.decode_attention_jax(q, kc, vc, jnp.int32(pos),
                                             window=window, ring=ring), 1e-5)


def _rwkv_block(seed=20, d=64, d_ff=128):
    p = jssm.init_rwkv6(jax.random.PRNGKey(0), d, d_ff, head_dim=16,
                        dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) + (0.05 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in p.items()}
    return p, {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("scan", ["linear_scan", "chunked"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 19])
def test_rwkv6_time_mix_matches(scan, with_state, t):
    p, pt = _rwkv_block()
    x = _rnd(21, (2, t, 64))
    state = tstate = None
    if with_state:
        parts = (_rnd(22, (2, 4, 16, 16), 0.3), _rnd(23, (2, 64)),
                 _rnd(24, (2, 64)))
        state = jssm.RWKVState(*map(jnp.asarray, parts))
        tstate = ssm.RWKVState(*map(torch.from_numpy, parts))
    want = jssm.rwkv6_time_mix(x, p, head_dim=16, state=state, scan=scan,
                               chunk=8)
    got = ssm.rwkv6_time_mix(torch.from_numpy(x), pt, head_dim=16,
                             state=tstate, scan=scan)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_rwkv6_channel_mix_matches():
    p, pt = _rwkv_block()
    x, prev = _rnd(25, (2, 9, 64)), _rnd(26, (2, 64))
    for jp, tp in ((None, None), (prev, torch.from_numpy(prev))):
        want = jssm.rwkv6_channel_mix(x, p, jp)
        got = ssm.rwkv6_channel_mix(torch.from_numpy(x), pt, tp)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


# -------------------------------------------------------- whole model ----

def _batch(cfg, t=20, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        toks = rng.integers(0, cfg.vocab_size, size=(2, t))
        return ({"tokens": jnp.asarray(toks, jnp.int32)},
                {"tokens": torch.from_numpy(toks)})
    e = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", COVERED)
def test_forward_logits_match(arch, policy):
    """Full-sequence logits of the smoke config, 20 tokens (longer than
    the smoke window of 8), against the JAX forward at 1e-4."""
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = perturbed_jax_params(jcfg)
    jb, tb = _batch(cfg)
    want, _ = jax.jit(lambda p, b: jlm.forward(p, jcfg, b))(params, jb)
    got = lm.forward(lm.from_jax_params(cfg, params), cfg, tb,
                     POLICIES[policy])
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b"])
def test_bf16_drift_is_the_reference_models(arch):
    """The smoke width at the full arch's group count, in bf16: the
    port's logits, under either policy, lie no further from the fp32
    model than 1.2 times the JAX package's own bf16 logits do (the
    factor ``chip_smoke.py`` holds the card's kernel policy to).  The
    bf16 model's drift from fp32 grows with depth through random-weight
    layers; it belongs to that model, not to the port."""
    full = ARCHS[arch]
    depth = dict(n_layers=len(full.prologue[:1])
                 + full.n_groups * len(full.pattern))
    jcfg = replace(JAX_ARCHS[arch].smoke(), **depth)
    jcfg16 = replace(jcfg, dtype="bfloat16")
    params = perturbed_jax_params(jcfg)
    params16 = jax.tree.map(  # the leaf types of the bf16 model's tree
        lambda a, w: np.asarray(jnp.asarray(a).astype(w.dtype)), params,
        jax_init_params(jcfg16, jax.random.PRNGKey(0)))
    jb, tb = _batch(jcfg)
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(p, jcfg, b))(
        params, jb)[0])

    def rel_l2(logits):
        return float(np.linalg.norm(np.asarray(logits, np.float32) - want)
                     / np.linalg.norm(want))

    ref = rel_l2(jax.jit(lambda p, b: jlm.forward(p, jcfg16, b))(
        params16, jb)[0])
    cfg16 = replace(ARCHS[arch].smoke(), dtype="bfloat16", **depth)
    tp = lm.from_jax_params(cfg16, params16)
    for name, policy in POLICIES.items():
        got = rel_l2(lm.forward(tp, cfg16, tb, policy).numpy())
        assert got <= 1.2 * ref, (arch, name, got, ref)


def test_bf16_reference_attention_differs_from_jax_only_in_rounding():
    """The two packages' ``attention_ref`` on the same bf16 inputs: the
    JAX one rounds q·kᵀ to bf16 before the scale, the port's keeps it in
    fp32 (``models/kernel_policy.py``).  They agree at the bf16 tolerance
    of 3e-2 and are not the same function."""
    rng = np.random.default_rng(30)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((2, 4, 48, 32), (2, 2, 48, 32), (2, 2, 48, 32)))
    for causal, window in ((True, None), (True, 16), (False, None)):
        want = np.asarray(jax_attention_ref(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            causal=causal, window=window), np.float32)
        got = attention_ref(
            *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
            causal=causal, window=window).float().numpy()
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
        assert not np.array_equal(got, want)


@pytest.mark.parametrize("arch", [a for a in COVERED
                                  if ARCHS[a].n_heads])
def test_bf16_reference_policy_matches_jax(arch):
    """The bf16 ``.smoke()`` config under both packages' ``"reference"``
    policy, weights carried across with ``from_jax_params``: logits
    within 3e-2 in relative L2.  (The deepest smoke configs, gemma3's
    seven layers, drift apart by more than 3e-2 elementwise even with
    the attention functions made identical: that is bf16 rounding at
    other places in the two frameworks, as in the drift test above.)"""
    jcfg = replace(JAX_ARCHS[arch].smoke(), dtype="bfloat16")
    cfg = replace(ARCHS[arch].smoke(), dtype="bfloat16")
    params16 = jax.tree.map(
        lambda a, w: np.asarray(jnp.asarray(a).astype(w.dtype)),
        perturbed_jax_params(JAX_ARCHS[arch].smoke()),
        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jb, tb = _batch(cfg)
    par = DEFAULT_PAR.with_kernels(JaxKernelPolicy("reference", "chunked"))
    want = np.asarray(jax.jit(lambda p, b: jlm.forward(p, jcfg, b, par))(
        params16, jb)[0], np.float32)
    got = lm.forward(lm.from_jax_params(cfg, params16), cfg, tb,
                     PLAIN_KERNELS)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 3e-2, (arch, rel)


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b", "qwen2-vl-72b",
                                  "zamba2-2.7b", "deepseek-moe-16b"])
def test_prefill_and_decode_steps_match(arch):
    """Prefill (last-position logits) and two decode steps with the
    port's in-place caches against the JAX steps, prompt 12 > window 8."""
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = perturbed_jax_params(jcfg)
    tparams = lm.from_jax_params(cfg, params)
    jb, tb = _batch(cfg, t=12)
    jpre = jax.jit(jlm.make_prefill_step(jcfg, 16))
    jdec = jax.jit(jlm.make_decode_step(jcfg))
    want, jcache, jpos = jpre(params, jb)
    got, cache, pos = lm.make_prefill_step(cfg, 16)(tparams, tb)
    _close(got, want, 1e-4)
    assert pos == int(jpos) == 12
    decode = lm.make_decode_step(cfg)
    for step in range(2):
        tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
        want, jcache, jpos = jdec(params, jcache, jnp.asarray(tok), jpos)
        got, cache, pos = decode(tparams, cache, torch.from_numpy(tok), pos)
        _close(got, want, 1e-4)
        assert pos == int(jpos) == 13 + step


@pytest.mark.parametrize("arch", COVERED)
def test_params_carry_across_bit_for_bit(arch):
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = lm.from_jax_params(cfg, jax.tree.map(np.asarray, params))
    jleaves = jax.tree.leaves(params)
    tleaves = jax.tree.leaves(tparams)  # the same dicts and lists
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert np.array_equal(np.asarray(a), t.numpy())
    assert lm.param_count(cfg) == jlm.param_count(jcfg)
    assert lm.param_count(ARCHS[arch]) == jlm.param_count(JAX_ARCHS[arch])
    assert (lm.active_param_count(ARCHS[arch])
            == jlm.active_param_count(JAX_ARCHS[arch]))


def test_from_jax_params_refuses_a_foreign_tree():
    cfg = ARCHS["gemma3-4b"].smoke()
    params = jax.tree.map(np.asarray, jax_init_params(
        JAX_ARCHS["gemma3-4b"].smoke(), jax.random.PRNGKey(0)))
    params["final_norm"] = params["final_norm"][:10]
    with pytest.raises(ValueError, match="final_norm"):
        lm.from_jax_params(cfg, params)


def test_init_params_has_the_jax_shapes_and_scales():
    """The port's own random init: the JAX tree's shapes and types, and
    weights drawn at fan_in ** -0.5."""
    cfg = ARCHS["gemma3-4b"].smoke()
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    ref_shapes = jax.eval_shape(lambda: jax_init_params(
        JAX_ARCHS["gemma3-4b"].smoke()))
    for a, t in zip(jax.tree.leaves(ref_shapes), jax.tree.leaves(mine)):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
    wq = mine["groups"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-4b", "rwkv6-7b"])
def test_init_cache_has_the_jax_tree(arch):
    """Every cache leaf's shape and type as the JAX ``init_cache`` makes
    them: zamba2's Mamba2 states and the shared block's per-use KV
    caches, stacked over groups."""
    from repro.models.stack import init_cache as jax_init_cache
    jcfg, cfg = JAX_ARCHS[arch].smoke(), ARCHS[arch].smoke()
    want = jax.eval_shape(lambda: jax_init_cache(jcfg, 2, 16))
    got = init_cache(cfg, 2, 16)
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype) == "torch." + str(w.dtype)


def test_init_cache_shapes():
    cfg = ARCHS["gemma3-4b"].smoke()
    c = init_cache(cfg, 2, 32)
    assert c["pro"][0]["k"].shape == (2, 8, 2, 16)        # L: a ring of 8
    assert c["grp"][-1]["k"].shape == (cfg.n_groups, 2, 32, 2, 16)  # G
