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
from repro_torch.configs.lm_archs import ARCHS
from repro_torch.engine import LMConfig
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import linear_scan as scan_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import attention_ref, linear_scan_ref
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
    case + (chunk,) for case, chunk in zip(SCAN_CASES, (32, 128, 32))] + [
    # N no power of two (the CUDA kernel takes any N up to 128, the JAX
    # kernel any N) and an M of 80
    (1, 64, 2, 5, 16, 32), (1, 64, 2, 48, 80, 64)])
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


def _grouped_scan_arithmetic(decay, k, v, r, s0):
    """The CUDA scan kernel's arithmetic (``csrc/linear_scan.cu``) in
    plain torch, fp32: each state element updated by one fma,
    ``fma(decay, s, k * v)``; the N rows of a state column split into
    four blocks of R = ceil(N / 4) rows, each block's part of y summed
    row by row with fmas, and the parts combined by the lanes' xor
    shuffles, ``(p0 + p1) + (p2 + p3)``.  An fma is emulated in float64,
    where the product of two fp32 values is exact."""
    groups = 4

    def fma(a, x, c):
        return (a.double() * x.double() + c.double()).float()

    d, kk, vv, rr = (a.float() for a in (decay, k, v, r))
    b, t, h, n = kk.shape
    rows = -(-n // groups)

    def blocks(a):  # rows (dim 2) -> (groups, R), padded with zeros
        a = torch.nn.functional.pad(a.movedim(2, -1), (0, rows * groups - n))
        return a.reshape(a.shape[:-1] + (groups, rows)).movedim((-2, -1),
                                                                (2, 3))

    state = blocks(s0.float())                          # B,H,G,R,M
    ys = []
    for i in range(t):
        di, ki, ri = (blocks(a[:, i])[..., None] for a in (d, kk, rr))
        state = fma(di, state, ki * vv[:, i, :, None, None, :])
        part = torch.zeros((b, h, groups, vv.shape[-1]))  # B,H,G,M
        for j in range(rows):
            part = fma(ri[:, :, :, j], state[:, :, :, j], part)
        ys.append((part[:, :, 0] + part[:, :, 1])
                  + (part[:, :, 2] + part[:, :, 3]))
    return (torch.stack(ys, dim=1),
            state.reshape(b, h, groups * rows, -1)[:, :, :n])


def test_linear_scan_group_split_holds_fp32_tolerance():
    """The summation order of the CUDA scan kernel's y (four lanes to a
    state column, each summing 16 of N = 64 rows, then two shuffles) at
    rwkv6-7b's N = M = 64 and the main path's T = 1536, on two heads:
    within 1e-4 of the plain version, as the card's gate asks, and the
    final state within 1e-5 (the same fmas, in no other order)."""
    decay, k, v, r, s0 = (torch.from_numpy(a) for a in
                          scan_inputs(1, 1536, 2, 64, 64))
    y, s_t = _grouped_scan_arithmetic(decay, k, v, r, s0)
    y_ref, s_ref = linear_scan_ref(decay, k, v, r, s0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), s_ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_every_attention_head_dim_has_a_flash_kernel():
    """The head dim of every arch with attention, zamba2-2.7b's shared
    block included, is one the CUDA flash kernels are built for."""
    dims = {a: cfg.head_dim for a, cfg in ARCHS.items() if cfg.n_heads}
    assert dims["hubert-xlarge"] == dims["zamba2-2.7b"] == 80
    assert set(dims.values()) <= set(flash_mod.HEAD_DIMS), dims


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
    assert KernelPolicy(attention="flash_jax").validate().block_q == 512
    with pytest.raises(ValueError, match="scan variant"):
        KernelPolicy(scan="fast").validate()


def test_lm_config_round_trips_with_the_jax_package():
    cfg = LMConfig(arch="rwkv6-7b", smoke=False, max_context=2048,
                   decode_batch=4, attn_variant="flash_jax",
                   scan_variant="linear_scan", block_q=128, seed=3)
    jax_cfg = JaxLMConfig(**cfg.to_dict())
    assert jax_cfg.to_dict() == cfg.to_dict()
    assert LMConfig(**jax_cfg.to_dict()) == cfg
