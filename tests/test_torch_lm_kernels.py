"""The port's LM kernel entry points against the JAX package's Pallas
kernels.

On the CPU, ``repro_torch.kernels.ops`` runs the plain PyTorch versions
(``kernels/ref.py``); the JAX side runs the Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` does.  Inputs come from numpy seeds
(the helpers of ``test_torch_cuda.py``, which hold the CUDA kernels to
the same plain versions on the card) and go to both.  Tolerances are
those of ``tests/test_kernels.py``: flash attention fp32 2e-5 and bf16
3e-2, linear scan fp32 1e-4 and bf16 5e-2 (bf16 rounds at other places
in the two frameworks), the two-halves state carry 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import LMConfig as JaxLMConfig
from repro.kernels import ops as jops
from repro_torch.engine import LMConfig
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import linear_scan as scan_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.kernel_policy import (DEFAULT_KERNELS, PLAIN_KERNELS,
                                              KernelPolicy)
from test_torch_cuda import FLASH_CASES, SCAN_CASES, flash_inputs, scan_inputs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the JAX kernel's tiles per case (tests/test_kernels.py); the port's
# CUDA kernel has fixed tiles and masks the ragged edge
BLOCKS = [(64, 64), (128, 64), (64, 64), (64, 64), (64, 64)]


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case,blocks", list(zip(FLASH_CASES, BLOCKS)))
def test_flash_attention_matches_pallas(case, blocks, dtype):
    b, hq, hkv, t, d, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype)
                                    for a in flash_inputs(b, hq, hkv, t, d))
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=blocks[0], block_k=blocks[1])
    before = flash_mod.launches
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_mod.launches == before  # a CPU tensor takes the plain path
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_flash_attention_matches_every_pallas_tiling():
    """The JAX kernel's result is independent of its tiles; the port's
    plain version equals it at each of them."""
    q, k, v = flash_inputs(1, 2, 2, 256, 32)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    for bq, bk in [(64, 64), (128, 128), (256, 64), (64, 256)]:
        want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    block_q=bq, block_k=bk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def _bf16_kernel_arithmetic(q, k, v, *, block_k, split_p):
    """The bf16 CUDA kernel's arithmetic (``csrc/flash_attention_sm90.cu``)
    in plain torch, causal: kv tiles of ``block_k`` keys; scores of the
    bf16 inputs summed in fp32, scaled into the exp2 domain; online
    softmax with fp32 m and l (l summed from the fp32 p); p.v from
    ``p_hi = bf16(p)`` and ``p_lo = bf16(p - p_hi)``, both products summed
    in fp32 (``split_p``), or from ``bf16(p)`` alone as the TPU kernel
    does; one bf16 rounding of the output."""
    t, d = q.shape[-2:]
    c = d ** -0.5 * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape)
    qi = torch.arange(t)[:, None]
    for k0 in range(0, k.shape[-2], block_k):
        kj = torch.arange(k0, min(k0 + block_k, k.shape[-2]))[None]
        x = (qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2)) * c
        x = x.masked_fill(kj > qi, -math.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        m, l = m_new, alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        vt = vf[..., k0:k0 + block_k, :]
        pv = p_hi @ vt
        if split_p:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        acc = alpha * acc + pv
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16()


@pytest.mark.parametrize("split_p", [True, False])
def test_bf16_kernel_keeps_p_to_one_output_rounding(split_p):
    """The precision design of the bf16 kernel: with p split into hi and
    lo bf16 parts every output lies within one bf16 rounding (2**-8
    relative, 1e-5 absolute) of the fp32 function of the bf16 inputs;
    one bf16 rounding of p, the TPU kernel's, breaks that bound (on about
    a quarter of the outputs here)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 256, 64)).astype(
        np.float32)).bfloat16() for _ in range(3))
    got = _bf16_kernel_arithmetic(q, k, v, block_k=64,
                                  split_p=split_p).float()
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    outside = (got - want).abs() > 2.0 ** -8 * want.abs() + 1e-5
    if split_p:
        assert int(outside.sum()) == 0
    else:
        assert int(outside.sum()) > got.numel() // 10


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,n,m,chunk", [
    case + (chunk,) for case, chunk in zip(SCAN_CASES, (32, 128, 32))])
def test_linear_scan_matches_pallas(b, t, h, n, m, chunk, dtype):
    decay, k, v, r, s0 = scan_inputs(b, t, h, n, m)
    jax_in = [_both(a, dtype) for a in (decay, k, v, r)]
    want_y, want_s = jops.linear_scan(*(j for j, _ in jax_in),
                                      jnp.asarray(s0), chunk=chunk)
    before = scan_mod.launches
    y, s_t = tops.linear_scan(*(t_ for _, t_ in jax_in),
                              torch.from_numpy(s0))
    assert scan_mod.launches == before
    assert y.dtype == DTYPES[dtype][1] and s_t.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(want_s),
                               rtol=tol, atol=tol)


def test_linear_scan_state_carry_matches_pallas():
    """Two half scans, the second from the first's final state, equal one
    scan, and both equal the Pallas kernel's whole scan (1e-5)."""
    b, t, h, n, m = 1, 64, 2, 4, 8
    rng = np.random.default_rng(15)
    decay = np.full((b, t, h, n), 0.9, np.float32)
    k, r = (rng.normal(size=(b, t, h, n)).astype(np.float32) * 0.2
            for _ in range(2))
    v = rng.normal(size=(b, t, h, m)).astype(np.float32) * 0.2
    s0 = np.zeros((b, h, n, m), np.float32)
    want_y, want_s = jops.linear_scan(*map(jnp.asarray, (decay, k, v, r, s0)),
                                      chunk=16)
    args = [torch.from_numpy(a) for a in (decay, k, v, r)]
    y1, s1 = tops.linear_scan(*(a[:, :32] for a in args),
                              torch.from_numpy(s0))
    y2, s2 = tops.linear_scan(*(a[:, 32:] for a in args), s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run the plain version: a CPU tensor is an
    error there, and only ``ops`` dispatches by device."""
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_mod.flash_attention_cuda(q, q, q)
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_mod.linear_scan_cuda(x, x, x, x, torch.zeros(1, 2, 4, 4))


def test_kernel_policy_defaults_and_pins():
    assert DEFAULT_KERNELS.validate() == KernelPolicy(
        "flash_pallas", "linear_scan")
    assert PLAIN_KERNELS.validate() == KernelPolicy(
        "reference", "chunked")
    with pytest.raises(NotImplementedError, match="attention_vjp"):
        KernelPolicy(attention="flash_jax").validate()
    with pytest.raises(ValueError, match="scan variant"):
        KernelPolicy(scan="fast").validate()


def test_lm_config_round_trips_with_the_jax_package():
    cfg = LMConfig(arch="rwkv6-7b", smoke=False, max_context=2048,
                   decode_batch=4, attn_variant="flash_jax",
                   scan_variant="linear_scan", block_q=128, seed=3)
    jax_cfg = JaxLMConfig(**cfg.to_dict())
    assert jax_cfg.to_dict() == cfg.to_dict()
    assert LMConfig(**jax_cfg.to_dict()) == cfg
