"""The port's head-dim alignment (``repro_torch.models.align``) against the
JAX package's ``repro.models.align``, with the cases of
``tests/test_align.py``.

``pad_head_dim`` of a JAX tree carried across with ``from_jax_params``
equals the JAX-padded tree leaf for leaf, bit for bit (fp32, and bf16
weights, whose q scale both packages round to bf16 first); the padded
config's forward equals the unpadded one at 2e-5 under both policies,
and the JAX padded forward at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import ARCHS as JAX_ARCHS
from repro.models import lm as jlm
from repro.models.align import pad_head_dim as jax_pad_head_dim
from repro.models.stack import init_params as jax_init_params
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.models import lm
from repro_torch.models.align import pad_head_dim
from repro_torch.models.kernel_policy import DEFAULT_KERNELS, PLAIN_KERNELS

# tests/test_align.py's cases: (arch, changes, key, tokens)
CASES = {
    "danube": ("h2o-danube-3-4b", dict(head_dim=12, n_heads=4, n_kv_heads=2),
               0, 24),
    "qwen-bias": ("qwen1.5-110b", dict(head_dim=12), 1, 16)}


def _cfgs(case, dtype="float32"):
    arch, changes, _, _ = CASES[case]
    return (dataclasses.replace(JAX_ARCHS[arch].smoke(), dtype=dtype,
                                **changes),
            dataclasses.replace(ARCHS[arch].smoke(), dtype=dtype, **changes))


def _jax_params(case, jcfg):
    return jax_init_params(jcfg, jax.random.PRNGKey(CASES[case][2]))


def _tokens(case, vocab):
    t = CASES[case][3]
    toks = np.arange(2 * t).reshape(2, t) % vocab
    return ({"tokens": jnp.asarray(toks, jnp.int32)},
            {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_padded_tree_equals_the_jax_one_bit_for_bit(case, dtype):
    jcfg, cfg = _cfgs(case, dtype)
    jparams = _jax_params(case, jcfg)
    want, jcfg_p = jax_pad_head_dim(jparams, jcfg, 16)
    got, cfg_p = pad_head_dim(
        lm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams)), cfg, 16)
    assert (cfg_p.head_dim, cfg_p.rope_dim) == (jcfg_p.head_dim,
                                                jcfg_p.rope_dim) == (16, 12)
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), w)
    # the padded tree is the port's own: it carries across unchanged
    lm.from_jax_params(cfg_p, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("policy", ["kernels", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_padded_forward_equals_the_unpadded_one(case, policy):
    """tests/test_align.py's check on the port (2e-5), and the port's
    padded logits against the JAX padded forward (1e-4)."""
    pol = {"kernels": DEFAULT_KERNELS, "plain": PLAIN_KERNELS}[policy]
    jcfg, cfg = _cfgs(case)
    jparams = _jax_params(case, jcfg)
    params = lm.from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    padded, cfg_p = pad_head_dim(params, cfg, 16)
    jb, tb = _tokens(case, cfg.vocab_size)
    y0 = lm.forward(params, cfg, tb, pol)
    y1 = lm.forward(padded, cfg_p, tb, pol)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=2e-5, atol=2e-5)
    jpadded, jcfg_p = jax_pad_head_dim(jparams, jcfg, 16)
    want, _ = jax.jit(lambda p, b: jlm.forward(p, jcfg_p, b))(jpadded, jb)
    np.testing.assert_allclose(y1.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_pad_head_dim_refuses_what_it_cannot_pad():
    _, cfg = _cfgs("danube")
    with pytest.raises(ValueError, match="no narrower"):
        pad_head_dim({}, cfg, 8)
    vl = ARCHS["qwen2-vl-72b"].smoke()
    with pytest.raises(ValueError, match="M-RoPE"):
        pad_head_dim({}, vl, 32)
