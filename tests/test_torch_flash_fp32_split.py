"""The arithmetic of the fp32 flash-attention kernel
(``csrc/flash_attention.cu``), emulated in numpy and held against
attention in float64.

The kernel runs both products, q.k^T and p.v, on the tensor cores in
TF32 (11 significant bits) as split TF32: each fp32 operand x becomes
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, rounded to nearest with ties
away from zero (``cvt.rna.tf32.f32``), and a product a.b becomes
``lo_a.hi_b + hi_a.lo_b + hi_a.hi_b`` with fp32 accumulators (lo.lo is
dropped). The kernel masks hi; for lo it only adds half a TF32 unit,
since the tensor cores drop an operand's low 13 bits, which makes it the
same rounded ``tf32(x - hi)`` there. The emulation follows the kernel
step for step: q tiles of ``BLOCK_Q`` rows, key tiles of
``KEY_TILE[d]`` keys starting where the q tile's causal / window
band starts, the score products in ``k8`` steps into two accumulators
(hi.hi, and the two corrections), the online softmax in base 2 with fp32
running max and sum, and p.v with the three products of each ``k8`` step
summed into one accumulator. Each ``mma`` is modelled as its exact sum
rounded once to fp32.

Every case must come within a tenth of the fp32 gate that the card's
tests hold the kernel to (rtol / atol 2e-5 against the plain version):
the split leaves about 2**-22 of each operand, where one TF32 product
leaves 2**-11 and misses the gate, which the last CPU test shows.

``BLOCK_Q`` and ``KEY_TILE`` are the kernel's ``Tiles<D>::kBlockQ`` and
``Tiles<D>::kBK``; the card test at the end reads them from the built
kernel library (``flash_attention_f32_tiles``) and holds them equal.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import HEAD_DIMS

GATE = 2e-5  # the fp32 kernel against attention_ref on the card
# q rows a block; keys a kv tile, per head dim
BLOCK_Q = 64
KEY_TILE = {16: 64, 32: 64, 64: 64, 80: 64, 120: 32, 128: 32, 256: 32}
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
# (b, hq, hkv, t, s, causal, window): the masks at small sizes, ragged T
MASKS = {
    "causal": (1, 2, 2, 77, 77, True, None),
    "window": (1, 2, 2, 150, 150, True, 40),
    "window0": (1, 2, 1, 33, 33, True, 0),
    "gqa": (1, 4, 1, 70, 70, True, None),
    "bidirectional": (1, 2, 2, 33, 77, False, None),
}
# one head at the main path's length: zamba2-2.7b / hubert-xlarge (80),
# deepseek-moe-16b (128), gemma3-4b's local layers (256, window 1024)
LONG = [(80, None), (128, None), (256, 1024)]


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` of finite fp32 values: round to the nearest
    of 11 significant bits, ties away from zero (the kernel adds 0x1000 to
    the bits and masks the low 13 off)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x - hi)


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def mma(acc, a, b):
    """One ``mma``: the exact products of a (m, k) and b (k, n) summed
    onto the fp32 accumulator, rounded once."""
    return f32(acc.astype(np.float64) + a.astype(np.float64)
               @ b.astype(np.float64))


def attention_emulated(q, k, v, causal, window, scale=None, products=3):
    """The kernel's arithmetic on fp32 numpy q (B,Hq,T,D), k, v
    (B,Hkv,S,D); ``products=1`` runs one TF32 product (hi.hi) instead."""
    b_, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = np.float32(d ** -0.5 if scale is None else scale)
    bk = KEY_TILE[d]
    out = np.zeros(q.shape, np.float32)
    for bi in range(b_):
        for h in range(hq):
            kh, vh = k[bi, h // (hq // hkv)], v[bi, h // (hq // hkv)]
            for q0 in range(0, t, BLOCK_Q):
                out[bi, h, q0:q0 + BLOCK_Q] = _q_tile(
                    q[bi, h, q0:q0 + BLOCK_Q], kh, vh, q0, t, s, causal,
                    window, scale, bk, products)
    return out


def _q_tile(qt, k, v, q0, t, s, causal, window, scale, bk, products):
    rows, d = qt.shape
    q_last = min(q0 + BLOCK_Q, t) - 1
    k_begin = max(0, q0 - window + 1) if window is not None else 0
    k_end = min(s, q_last + 1) if causal else s
    qi = np.arange(q0, q0 + rows)[:, None]
    m = np.full((rows, 1), NEG_INF, np.float32)
    lsum = np.zeros((rows, 1), np.float32)
    acc = np.zeros((rows, d), np.float32)
    q_hi, q_lo = split(qt)
    for k0 in range(k_begin, k_end, bk):
        kt, vt = k[k0:k0 + bk], v[k0:k0 + bk]
        kj = np.arange(k0, k0 + kt.shape[0])[None, :]
        k_hi, k_lo = split(kt)
        s_hh = np.zeros((rows, kt.shape[0]), np.float32)
        s_cor = np.zeros_like(s_hh)
        for kk in range(0, d, 8):
            c = slice(kk, kk + 8)
            if products == 3:
                s_cor = mma(s_cor, q_lo[:, c], k_hi[:, c].T)
                s_cor = mma(s_cor, q_hi[:, c], k_lo[:, c].T)
            s_hh = mma(s_hh, q_hi[:, c], k_hi[:, c].T)
        x = f32(f32(s_hh + s_cor) * scale)
        ok = np.ones(x.shape, bool)
        if causal:
            ok &= kj <= qi
        if window is not None:
            ok &= (qi - kj) < window
        x = np.where(ok, x, NEG_INF)
        m_new = np.maximum(m, x.max(axis=1, keepdims=True))
        ms_new = f32(m_new * LOG2E)
        alpha = f32(np.exp2(f32(f32(m * LOG2E) - ms_new)))
        # fma(x, log2e, -ms); a masked p is 0, not exp2 of its score
        p = f32(np.exp2(np.where(ok, f32(x.astype(np.float64) * LOG2E
                                         - ms_new), -np.inf)))
        lsum = f32(alpha * lsum + p.sum(axis=1, keepdims=True,
                                        dtype=np.float32))
        acc = f32(acc * alpha)
        m = m_new
        p_hi, p_lo = split(p)
        v_hi, v_lo = split(vt)
        for j in range(0, kt.shape[0], 8):
            c = slice(j, j + 8)
            if products == 3:
                acc = mma(acc, p_lo[:, c], v_hi[c])
                acc = mma(acc, p_hi[:, c], v_lo[c])
            acc = mma(acc, p_hi[:, c], v_hi[c])
    return f32(acc * f32(1.0 / np.where(lsum == 0, 1, lsum)))


def attention_f64(q, k, v, causal, window):
    """The function in float64: masked scores' p is 0, a fully masked row
    gives 0."""
    b_, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    kf = np.repeat(k.astype(np.float64), rep, axis=1)
    vf = np.repeat(v.astype(np.float64), rep, axis=1)
    x = q.astype(np.float64) @ kf.transpose(0, 1, 3, 2) * d ** -0.5
    qi, kj = np.arange(t)[:, None], np.arange(s)[None, :]
    ok = np.ones((t, s), bool)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= (qi - kj) < window
    x = np.where(ok, x, -np.inf)
    mx = x.max(axis=-1, keepdims=True)
    p = np.where(ok, np.exp(x - np.where(np.isfinite(mx), mx, 0)), 0.0)
    den = p.sum(axis=-1, keepdims=True)
    return (p / np.where(den == 0, 1, den)) @ vf


def _inputs(seed, b, hq, hkv, t, s, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's last place at 1
    x = np.array([one + ulp * 0.49, one + ulp * 0.5, -(one + ulp * 0.5),
                  one + ulp * 1.5, 0.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([one, one + ulp, -(one + ulp), one + 2 * ulp, 0.0],
                          np.float32))
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    # hi keeps 11 bits, lo the next 11: 2**-22 of x is left
    left = np.abs(hi.astype(np.float64) + lo - x)
    assert (left <= 2.0 ** -22 * np.abs(x)).all()
    assert (np.abs(hi.astype(np.float64) - x) > 2.0 ** -16 * np.abs(x)).any()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mask", list(MASKS))
def test_split_tf32_is_within_a_tenth_of_the_gate(mask, d):
    b, hq, hkv, t, s, causal, window = MASKS[mask]
    q, k, v = _inputs(d + t, b, hq, hkv, t, s, d)
    got = attention_emulated(q, k, v, causal, window)
    want = attention_f64(q, k, v, causal, window)
    np.testing.assert_allclose(got, want, rtol=GATE / 10, atol=GATE / 10)
    if window == 0:
        assert not got.any()  # every row masked: 0


@pytest.mark.parametrize("d,window", LONG)
def test_split_tf32_one_long_head_is_within_a_tenth_of_the_gate(d, window):
    q, k, v = _inputs(d, 1, 1, 1, 1536, 1536, d)
    got = attention_emulated(q, k, v, True, window)
    np.testing.assert_allclose(got, attention_f64(q, k, v, True, window),
                               rtol=GATE / 10, atol=GATE / 10)


@pytest.mark.parametrize("d,window", LONG)
def test_one_tf32_product_misses_the_gate(d, window):
    """Why the kernel issues three products: one TF32 product of each
    pair keeps 11 bits and falls outside rtol / atol 2e-5."""
    q, k, v = _inputs(d, 1, 1, 1, 1536, 1536, d)
    want = attention_f64(q, k, v, True, window)
    one = attention_emulated(q, k, v, True, window, products=1)
    assert not np.allclose(one, want, rtol=GATE, atol=GATE)
    assert np.abs(one - want).max() > 10 * GATE


@pytest.mark.cuda
def test_emulated_tiles_are_the_kernels():
    """The tiles the emulation takes are those the built kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from repro_torch.kernels.build import kernel_library
    lib = kernel_library()
    for d in HEAD_DIMS:
        block_q, key_tile = ctypes.c_int(), ctypes.c_int()
        assert lib.flash_attention_f32_tiles(
            d, ctypes.byref(block_q), ctypes.byref(key_tile)) == 0
        assert (block_q.value, key_tile.value) == (BLOCK_Q, KEY_TILE[d]), d
    assert lib.flash_attention_f32_tiles(
        96, ctypes.byref(block_q), ctypes.byref(key_tile)) != 0
