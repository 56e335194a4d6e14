"""The port on the card: each CUDA kernel against its plain version, the
CNN kernel path against the plain executor, and the LM session's kernel
policy against its plain policy.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: conv fp32 1e-5 (fp32 sums in another order), bf16 3e-2 (the
output rounds to bf16), pool exact; whole nets rtol 1e-4 / atol 1e-5,
the tolerance of ``tests/test_pallas_cnn_path.py``; flash attention
fp32 2e-5 and bf16 3e-2, linear scan fp32 1e-4 and bf16 5e-2 and its
two-halves state carry 1e-5, the tolerances of ``tests/test_kernels.py``.
The CNN fixture switches TF32 off, since cuDNN's default keeps about
three digits; ``test_torch_session_is_fp32_with_default_switches``
leaves the switches at their defaults and shows the ``"torch"`` backend
sets what it needs itself.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes, torch_exec
from repro_torch.kernels import conv2d as conv_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import linear_scan as scan_mod
from repro_torch.kernels import maxpool2d as pool_mod
from repro_torch.kernels import ref

CONV_CASES = [  # the cases of tests/test_kernels.py
    (1, 16, 16, 1, 8, 5, 5, 2, "same", "relu"),
    (2, 9, 7, 3, 4, 3, 3, 1, "same", "leaky_relu"),
    (1, 8, 8, 8, 12, 3, 3, 1, "valid", None),
    (2, 6, 6, 4, 16, 2, 2, 2, "valid", "relu"),
    (1, 12, 10, 2, 6, 1, 1, 1, "valid", None),
    (1, 60, 80, 3, 8, 3, 3, 1, "same", "leaky_relu"),  # robot detector L1
]
# c_out no multiple of the CUDA kernel's 256-thread block
CUDA_CONV_CASES = CONV_CASES + [(3, 7, 5, 5, 300, 3, 3, 1, "same", "relu")]
POOL_CASES = [
    ((1, 8, 8, 8), (2, 2), None),
    ((2, 9, 9, 4), (3, 3), (2, 2)),
    ((1, 16, 8, 12), (2, 2), (2, 2)),
]
ROBOT_POOL_CASES = [((2, 60, 80, 8), (2, 2), None),
                    ((2, 30, 40, 8), (2, 2), None)]
FLASH_CASES = [  # (b, hq, hkv, t, d, causal, window): tests/test_kernels.py
    (1, 4, 4, 128, 32, True, None),
    (2, 8, 2, 128, 64, True, None),    # GQA 4:1
    (1, 4, 1, 256, 32, True, 64),      # sliding window (MQA)
    (1, 2, 2, 128, 32, False, None),   # bidirectional (encoder)
    (1, 4, 2, 192, 64, True, 100),     # window not tile-aligned
]
# the archs' head dims, ragged T, a window of 0 (every row masked) and
# gemma3-4b's heads (8:4, D 256, window 1024) at a cut T
CUDA_FLASH_CASES = FLASH_CASES + [
    (1, 4, 2, 77, 120, True, 16),
    (2, 4, 4, 100, 128, False, 30),
    (1, 2, 1, 33, 16, True, 0),
    (1, 8, 4, 1100, 256, True, 1024),
]
SCAN_CASES = [  # (b, t, h, n, m): tests/test_kernels.py
    (1, 64, 2, 8, 16),
    (2, 128, 4, 16, 16),
    (1, 96, 1, 4, 8),
]
# rwkv6-7b's heads (N = M = 64) and an M that is no multiple of 64
CUDA_SCAN_CASES = SCAN_CASES + [(2, 70, 3, 64, 64), (1, 33, 2, 32, 80)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NETS = {**PAPER_CNNS, **EXTRA_CNNS}


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def flash_inputs(b, hq, hkv, t, d):
    """q, k, v (numpy fp32) of the flash tests, from seeds 4, 5, 6."""
    return (_rnd(4, (b, hq, t, d)), _rnd(5, (b, hkv, t, d)),
            _rnd(6, (b, hkv, t, d)))


def scan_inputs(b, t, h, n, m):
    """decay, k, v, r, s0 (numpy fp32) of the scan tests, from seeds
    10-14: decay in (0.5, 1), the rest scaled as in tests/test_kernels.py."""
    decay = 0.5 / (1.0 + np.exp(-_rnd(10, (b, t, h, n)))) + 0.5
    return (decay.astype(np.float32), _rnd(11, (b, t, h, n), 0.3),
            _rnd(12, (b, t, h, m), 0.3), _rnd(13, (b, t, h, n), 0.3),
            _rnd(14, (b, h, n, m), 0.1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         CUDA_CONV_CASES)
def test_conv2d_kernel_matches_plain(cuda, n, h, w, ci, co, kh, kw, stride,
                                     padding, act, dtype):
    td = DTYPES[dtype]
    x = torch.from_numpy(_rnd(0, (n, h, w, ci))).to(cuda, td)
    wt = torch.from_numpy(_rnd(1, (kh, kw, ci, co), 0.2)).to(cuda, td)
    b = torch.from_numpy(_rnd(2, (co,))).to(cuda)
    kw_args = dict(strides=(stride, stride), padding=padding, act=act)
    before = conv_mod.launches
    got = conv_mod.conv2d_cuda(x, wt, b, **kw_args)
    want = ref.conv2d_ref(x, wt, b, **kw_args)
    torch.cuda.synchronize()
    assert conv_mod.launches == before + 1
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,size,stride", POOL_CASES + ROBOT_POOL_CASES)
def test_maxpool_kernel_matches_plain(cuda, shape, size, stride, dtype):
    x = torch.from_numpy(_rnd(3, shape)).to(cuda, DTYPES[dtype])
    got = pool_mod.maxpool2d_cuda(x, size=size, strides=stride)
    want = ref.maxpool2d_ref(x, size=size, strides=stride)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_maxpool_kernel_propagates_nan(cuda):
    x = torch.from_numpy(_rnd(3, (1, 4, 4, 2))).to(cuda)
    x[0, 1, 1, 0] = float("nan")
    got = pool_mod.maxpool2d_cuda(x)
    want = ref.maxpool2d_ref(x)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 6, 6, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 8, device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        conv_mod.conv2d_cuda(x, w.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        conv_mod.conv2d_cuda(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="do not match"):
        conv_mod.conv2d_cuda(x, w[:, :, :3].contiguous(), b)
    with pytest.raises(ValueError, match="dtype"):
        pool_mod.maxpool2d_cuda(x.half())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NETS))
def test_forward_kernels_on_the_card_matches_plain_forward(cuda, name):
    g = passes.optimize(NETS[name](0), simd_multiple=4)
    x = torch.from_numpy(_rnd(5, (2,) + tuple(g.input_shape)))
    want = torch_exec.forward(g, x).numpy()
    before = conv_mod.launches
    got = torch_exec.forward_kernels(
        g, x.to(cuda), torch_exec.extract_params(g, cuda)).cpu().numpy()
    assert conv_mod.launches > before
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,t,d,causal,window", CUDA_FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, t, d, causal,
                                              window, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
               for a in flash_inputs(b, hq, hkv, t, d))
    before = flash_mod.launches
    got = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_and_writes_strided_heads(cuda):
    """The model hands the kernel (B,T,H,D) activations transposed to
    (B,H,T,D) views: the same numbers as contiguous inputs, and the output
    keeps q's memory order."""
    b, t, h, hkv, d = 2, 70, 8, 4, 64
    q = torch.from_numpy(_rnd(4, (b, t, h, d))).to(cuda)
    k = torch.from_numpy(_rnd(5, (b, t, hkv, d))).to(cuda)
    v = torch.from_numpy(_rnd(6, (b, t, hkv, d))).to(cuda)
    views = [a.transpose(1, 2) for a in (q, k, v)]
    got = flash_mod.flash_attention_cuda(*views, window=20)
    want = flash_mod.flash_attention_cuda(*(a.contiguous() for a in views),
                                          window=20)
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,n,m", CUDA_SCAN_CASES)
def test_linear_scan_kernel_matches_plain(cuda, b, t, h, n, m, dtype):
    td = DTYPES[dtype]
    *seq, s0 = (torch.from_numpy(a).to(cuda) for a in
                scan_inputs(b, t, h, n, m))
    seq = [a.to(td) for a in seq]
    before = scan_mod.launches
    y, s_t = scan_mod.linear_scan_cuda(*seq, s0)
    y_ref, s_ref = ref.linear_scan_ref(*seq, s0)
    torch.cuda.synchronize()
    assert scan_mod.launches == before + 1
    assert y.dtype == td and s_t.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(s_t.cpu().numpy(), s_ref.cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_linear_scan_kernel_carries_state_across_calls(cuda):
    """Two half scans, the second from the first's final state, equal one
    scan (tests/test_kernels.py's state-carry case, 1e-5)."""
    b, t, h, n, m = 1, 64, 2, 4, 8
    decay = torch.full((b, t, h, n), 0.9, device=cuda)
    k, v, r = (torch.from_numpy(_rnd(s, shape, 0.2)).to(cuda) for s, shape in
               ((15, (b, t, h, n)), (16, (b, t, h, m)), (17, (b, t, h, n))))
    s0 = torch.zeros((b, h, n, m), device=cuda)
    y_full, s_full = scan_mod.linear_scan_cuda(decay, k, v, r, s0)
    half = [a[:, :32].contiguous() for a in (decay, k, v, r)]
    rest = [a[:, 32:].contiguous() for a in (decay, k, v, r)]
    y1, s1 = scan_mod.linear_scan_cuda(*half, s0)
    y2, s2 = scan_mod.linear_scan_cuda(*rest, s1)
    np.testing.assert_allclose(y_full.cpu().numpy(),
                               torch.cat([y1, y2], 1).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_full.cpu().numpy(), s2.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_lm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mod.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 3, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        flash_mod.flash_attention_cuda(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="dtype"):
        flash_mod.flash_attention_cuda(q, q.bfloat16(), q)
    x = torch.zeros(1, 4, 1, 128, device=cuda)
    with pytest.raises(ValueError, match="state dim"):
        scan_mod.linear_scan_cuda(x, x, x, x, torch.zeros(1, 1, 128, 128,
                                                          device=cuda))


@pytest.mark.cuda
def test_torch_session_is_fp32_with_default_switches(cuda):
    """With PyTorch's TF32 switches at their defaults, building a
    ``"torch"`` session on the card switches cuDNN's TF32 off itself, and
    the session equals the kernel session at rtol 1e-4 / atol 1e-5."""
    from repro_torch.engine import InferenceSession, SessionConfig
    torch.backends.cudnn.allow_tf32 = True   # PyTorch's default
    plain = InferenceSession(NETS["robot"](0),
                             config=SessionConfig(backend="torch"))
    assert torch.backends.cudnn.allow_tf32 is False
    kern = InferenceSession(NETS["robot"](0),
                            config=SessionConfig(backend="cuda"))
    x = _rnd(7, (8,) + tuple(plain.input_shape))
    np.testing.assert_allclose(plain.predict(x), kern.predict(x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b"])
def test_lm_session_kernel_policy_matches_plain_on_the_card(cuda, arch):
    """The smoke configs in fp32 on the card: the kernel policy and the
    plain policy give the same prefill logits (1e-4) and the same greedy
    tokens, with a prompt longer than the smoke window of 8."""
    from repro_torch.engine import LMConfig, LMSession, SessionConfig
    sessions = [LMSession(config=SessionConfig(
        backend="cuda-lm", lm=LMConfig(arch=arch, max_context=32, **pins)))
        for pins in ({}, dict(attn_variant="reference",
                              scan_variant="chunked"))]
    prompts = np.random.default_rng(3).integers(
        0, 256, size=(2, 20)).astype(np.int32)
    before = (flash_mod.launches, scan_mod.launches)
    (lk, _), (lp, _) = (s.prefill(prompts) for s in sessions)
    np.testing.assert_allclose(lk, lp, rtol=1e-4, atol=1e-4)
    launched = (flash_mod.launches - before[0], scan_mod.launches - before[1])
    assert launched[0 if arch == "gemma3-4b" else 1] > 0
    np.testing.assert_array_equal(sessions[0].generate(prompts, 6),
                                  sessions[1].generate(prompts, 6))
