"""The port on the card: each CUDA kernel against its plain version, the
CNN kernel path against the plain executor, the int8 reference against
itself on the CPU, the LM session's kernel policy against its plain
policy, and the LM backend's decode replayed as a CUDA graph against the
eager decode step (tokens and last logits bit for bit, two handles
interleaved, a capture from a server's worker thread).

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: conv fp32 1e-5 (fp32 sums in another order), bf16 3e-2 (the
output rounds to bf16) and within one bf16 rounding of the fp32 function
of its inputs; on the wide and deep shapes (``BIG_CONV_CASES``) fp32
``conv_tol``: rtol 1e-5 and an atol that grows as the K products a sum
takes, bf16 3e-2; pool exact; whole nets rtol 1e-4 / atol 1e-5,
the tolerance of ``tests/test_pallas_cnn_path.py``; flash attention
fp32 2e-5 and bf16 3e-2, linear scan fp32 1e-4 and bf16 5e-2 (also
with decays down to 1e-6) and its two-halves state carry 1e-5, the
tolerances of ``tests/test_kernels.py``;
the bf16 flash kernel also within one bf16 rounding (2**-8 relative,
1e-5 absolute) of the fp32 function of its inputs.  The CNN fixture switches TF32 off, since cuDNN's default keeps about
three digits; ``test_torch_session_is_fp32_with_default_switches``
leaves the switches at their defaults and shows the ``"torch"`` backend
sets what it needs itself.  The int8 reference is exact on the integer
path, so its card output equals its CPU output on the same quantized
graph bit for bit; a Softmax sink is held at rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes, quantize, torch_exec
from repro_torch.core.graph import (Add, CNNGraph, Conv2D, Dense,
                                    DepthwiseConv2D, Flatten, Input, MaxPool)
from repro_torch.kernels import conv2d as conv_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import linear_scan as scan_mod
from repro_torch.kernels import maxpool2d as pool_mod
from repro_torch.kernels import ref
from repro_torch.kernels.cases import (BIG_CONV_CASES, EDGE_CONV_CASES,
                                       EDGE_POOL_CASES, conv_tol)

CONV_CASES = [  # the cases of tests/test_kernels.py
    (1, 16, 16, 1, 8, 5, 5, 2, "same", "relu"),
    (2, 9, 7, 3, 4, 3, 3, 1, "same", "leaky_relu"),
    (1, 8, 8, 8, 12, 3, 3, 1, "valid", None),
    (2, 6, 6, 4, 16, 2, 2, 2, "valid", "relu"),
    (1, 12, 10, 2, 6, 1, 1, 1, "valid", None),
    (1, 60, 80, 3, 8, 3, 3, 1, "same", "leaky_relu"),  # robot detector L1
]
# c_out no multiple of the 256-thread block of the kernel's first design
CUDA_CONV_CASES = CONV_CASES + [(3, 7, 5, 5, 300, 3, 3, 1, "same", "relu")]
# every Conv2D of the four optimized nets at the main path's batches
# (robot 64, the others 8; a softmax layer's conv has no activation)
NET_CONV_CASES = [
    (64, 60, 80, 3, 8, 3, 3, 1, "same", "leaky_relu"),       # robot
    (64, 30, 40, 8, 12, 3, 3, 1, "same", "leaky_relu"),
    (64, 30, 40, 12, 8, 3, 3, 1, "same", "leaky_relu"),
    (64, 15, 20, 8, 16, 3, 3, 1, "same", "leaky_relu"),
    (64, 15, 20, 16, 20, 3, 3, 1, "same", "leaky_relu"),
    (8, 36, 18, 1, 12, 3, 3, 1, "same", "relu"),              # pedestrian
    (8, 18, 9, 12, 32, 3, 3, 1, "same", "leaky_relu"),
    (8, 9, 4, 32, 64, 3, 3, 1, "same", "leaky_relu"),
    (8, 4, 2, 64, 2, 4, 2, 1, "valid", None),
    (8, 16, 16, 1, 8, 5, 5, 2, "same", "relu"),               # ball
    (8, 4, 4, 8, 12, 3, 3, 1, "valid", "relu"),
    (8, 2, 2, 12, 2, 2, 2, 1, "valid", None),
    (8, 16, 16, 3, 8, 3, 3, 1, "same", "relu"),               # residual
    (8, 16, 16, 8, 8, 1, 1, 1, "valid", None),
    (8, 16, 16, 8, 4, 1, 1, 1, "valid", None),
    (8, 16, 16, 8, 4, 3, 3, 1, "same", None),
    (8, 1, 1, 8, 4, 1, 1, 1, "valid", None),
]
CUDA_CONV_CASES += NET_CONV_CASES + EDGE_CONV_CASES
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
    # head dim 80 (hubert-xlarge, zamba2-2.7b): GQA 1 and 2, causal and
    # windowed, ragged T
    (1, 4, 4, 100, 80, True, None),
    (1, 4, 2, 130, 80, True, 32),
    (2, 4, 2, 70, 80, False, None),
]
# the bf16 tensor-core kernel: every head dim, each under five masks and
# layouts (b, hq, hkv, t, s, causal, window, (B,T,H,D) views): GQA groups
# 1, 2 and 4, causal and not (S > T and S < T), windows None, 0, 16 and
# 1024, ragged T of 33, 77, 130 and 1537
BF16_FLASH_CASES = [
    (1, 4, 2, 130, 130, True, None, False),
    (1, 8, 2, 77, 77, True, 16, True),
    (1, 2, 2, 33, 77, False, None, False),
    (2, 4, 4, 130, 60, False, 30, True),
    (1, 2, 1, 33, 33, True, 0, False),
    (1, 4, 2, 1537, 1537, True, 1024, True),
]
# a query offset (q_start): a rank's rows of a longer sequence against the
# whole k and v (b, hq, hkv, rows, s, d, causal, window, q_start,
# (B,T,H,D) views): head dims 16, 80, 128 and 256, the last quarter of
# four ranks' rows and ragged ones, windows off the tile grid
OFFSET_FLASH_CASES = [
    (1, 4, 2, 64, 256, 80, True, None, 192, False),
    (1, 8, 4, 384, 1536, 256, True, 1024, 1152, True),
    (2, 4, 4, 100, 400, 128, True, 30, 300, False),
    (1, 4, 2, 33, 130, 16, True, None, 97, True),
    (1, 2, 2, 77, 154, 80, False, None, 77, False),
    (1, 4, 2, 130, 520, 256, True, 16, 260, True),
]
SCAN_CASES = [  # (b, t, h, n, m): tests/test_kernels.py
    (1, 64, 2, 8, 16),
    (2, 128, 4, 16, 16),
    (1, 96, 1, 4, 8),
]
# rwkv6-7b's heads (N = M = 64) and an M that is no multiple of 64
CUDA_SCAN_CASES = SCAN_CASES + [(2, 70, 3, 64, 64), (1, 33, 2, 32, 80)]
# N no power of two (5 takes the kernel's plain copies, 48 pads to 64
# rows) and N 128; M 80 (no multiple of the 64-column tile) and M 10 (no
# whole 16-byte chunks); T 1, 33 and 1537 (no multiple of the 32-step
# chunk)
CUDA_SCAN_CASES += [(1, 40, 2, 5, 16), (1, 40, 3, 48, 64),
                    (1, 33, 2, 128, 64), (2, 33, 2, 64, 80),
                    (1, 33, 2, 16, 10), (2, 1, 2, 64, 64),
                    (1, 1537, 2, 64, 64)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NETS = {**PAPER_CNNS, **EXTRA_CNNS}


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def flash_inputs(b, hq, hkv, t, d, s=None):
    """q, k, v (numpy fp32) of the flash tests, from seeds 4, 5, 6; k and
    v have ``s`` keys (default ``t``)."""
    s = t if s is None else s
    return (_rnd(4, (b, hq, t, d)), _rnd(5, (b, hkv, s, d)),
            _rnd(6, (b, hkv, s, d)))


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


@pytest.fixture
def cards(cuda):
    """The number of CUDA cards; skips with fewer than two."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.cuda.device_count()


@pytest.fixture
def four_cards(cuda):
    """Skips with fewer than four CUDA cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return torch.cuda.device_count()


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
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         CUDA_CONV_CASES)
def test_conv2d_bf16_kernel_within_one_rounding(cuda, n, h, w, ci, co, kh,
                                                kw, stride, padding, act):
    """The bf16 kernel sums in fp32 and rounds once: every output within
    one bf16 rounding (2**-8 relative, 1e-5 absolute) of the plain version
    on the upcast inputs."""
    x = torch.from_numpy(_rnd(0, (n, h, w, ci))).to(cuda, torch.bfloat16)
    wt = torch.from_numpy(_rnd(1, (kh, kw, ci, co), 0.2)).to(cuda,
                                                             torch.bfloat16)
    b = torch.from_numpy(_rnd(2, (co,))).to(cuda)
    kw_args = dict(strides=(stride, stride), padding=padding, act=act)
    got = conv_mod.conv2d_cuda(x, wt, b, **kw_args)
    want32 = ref.conv2d_ref(x.float(), wt.float(), b, **kw_args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want32.cpu().numpy(), rtol=2.0 ** -8,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         BIG_CONV_CASES)
def test_conv2d_kernel_takes_wide_and_deep_shapes(cuda, n, h, w, ci, co, kh,
                                                  kw, stride, padding, act,
                                                  dtype):
    """Column tiles and filter chunks: shapes whose full output row and
    filters do not fit in a block's shared memory."""
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
    rtol, atol = conv_tol(kh, kw, ci)
    if dtype == "bfloat16":
        rtol, atol = 3e-2, max(atol, 3e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,size,stride",
                         POOL_CASES + ROBOT_POOL_CASES + EDGE_POOL_CASES)
def test_maxpool_kernel_matches_plain(cuda, shape, size, stride, dtype):
    x = torch.from_numpy(_rnd(3, shape)).to(cuda, DTYPES[dtype])
    before = pool_mod.launches
    got = pool_mod.maxpool2d_cuda(x, size=size, strides=stride)
    want = ref.maxpool2d_ref(x, size=size, strides=stride)
    assert pool_mod.launches == before + 1
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
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size,stride", [((2, 2), None), ((3, 3), (2, 2)),
                                         ((2, 3), (1, 2))])
def test_maxpool_kernel_propagates_nan_in_a_vector_lane(cuda, dtype, size,
                                                        stride):
    """A NaN inside a 16-byte vector (channel 5 of 8: the second fp32
    vector's second lane, the bf16 vector's sixth), in the first tap of
    one window and a later tap of another, on the compiled and the
    runtime windows."""
    x = torch.from_numpy(_rnd(3, (2, 7, 9, 8))).to(cuda, DTYPES[dtype])
    x[0, 0, 0, 5] = float("nan")
    x[1, 3, 4, 5] = float("nan")
    got = pool_mod.maxpool2d_cuda(x, size=size, strides=stride)
    want = ref.maxpool2d_ref(x, size=size, strides=stride)
    assert int(want.isnan().sum()) >= 2
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_maxpool_kernel_reads_a_tensor_off_16_byte_alignment(cuda, dtype):
    """x a contiguous view 4 bytes past an allocation: the plan narrows
    the vector to what the pointer allows."""
    td = DTYPES[dtype]
    flat = torch.from_numpy(_rnd(3, (2 * 6 * 8 * 8 + 2,))).to(cuda, td)
    x = flat[4 // flat.element_size():][:2 * 6 * 8 * 8].view(2, 6, 8, 8)
    assert x.data_ptr() % 16 == 4
    got = pool_mod.maxpool2d_cuda(x)
    assert torch.equal(got, ref.maxpool2d_ref(x))


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
@pytest.mark.parametrize("d", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hkv,t,s,causal,window,model_layout",
                         BF16_FLASH_CASES)
def test_flash_attention_bf16_kernel_within_one_rounding(
        cuda, b, hq, hkv, t, s, causal, window, model_layout, d):
    """The bf16 tensor-core kernel against the plain version at 3e-2, and
    within one bf16 rounding (2**-8 relative, 1e-5 absolute) of the plain
    version on the upcast inputs, the gate of ``chip_smoke.py``."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in flash_inputs(b, hq, hkv, t, d, s))
    if model_layout:  # (B,T,H,D) activations viewed as (B,H,T,D)
        q, k, v = (a.transpose(1, 2).contiguous().transpose(1, 2)
                   for a in (q, k, v))
    before = flash_mod.launches
    got = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    want32 = ref.attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    got = got.float().cpu().numpy()
    np.testing.assert_allclose(got, want.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(got, want32.cpu().numpy(), rtol=2.0 ** -8,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", flash_mod.HEAD_DIMS)
@pytest.mark.parametrize("b,hq,hkv,t,s,causal,window,model_layout",
                         BF16_FLASH_CASES)
def test_flash_attention_fp32_kernel_at_every_head_dim(
        cuda, b, hq, hkv, t, s, causal, window, model_layout, d):
    """The fp32 split-TF32 kernel under the bf16 kernel's masks and
    layouts (T != S, (B,T,H,D) views, window 0, T = S = 1537 with window
    1024) at every head dim, against the plain version at 2e-5; counted
    once in ``launches`` and once in ``launches_f32``."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in flash_inputs(b, hq, hkv, t, d, s))
    if model_layout:  # (B,T,H,D) activations viewed as (B,H,T,D)
        q, k, v = (a.transpose(1, 2).contiguous().transpose(1, 2)
                   for a in (q, k, v))
    before = (flash_mod.launches, flash_mod.launches_f32)
    got = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_mod.launches, flash_mod.launches_f32) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.stride() == q.stride()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,m,s,d,causal,window,q_start,model_layout",
                         OFFSET_FLASH_CASES)
def test_flash_attention_kernels_at_a_query_offset(
        cuda, b, hq, hkv, m, s, d, causal, window, q_start, model_layout,
        dtype):
    """Both routes on ``m`` query rows at positions ``q_start ..`` against
    ``s`` whole keys (the head-dim rule's prefill on one rank's rows),
    against the plain version at the same offset: fp32 at 2e-5, bf16 at
    3e-2 and within one bf16 rounding of the fp32 function."""
    q, k, v = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
               for a in flash_inputs(b, hq, hkv, s, d))
    if model_layout:  # (B,T,H,D) activations viewed as (B,H,T,D)
        q, k, v = (a.transpose(1, 2).contiguous().transpose(1, 2)
                   for a in (q, k, v))
    q = q[:, :, q_start:q_start + m]
    before = flash_mod.launches
    got = flash_mod.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, q_start=q_start)
    want = ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_start=q_start)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    got = got.float().cpu().numpy()
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if dtype == "bfloat16":
        want32 = ref.attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   q_start=q_start)
        np.testing.assert_allclose(got, want32.cpu().numpy(),
                                   rtol=2.0 ** -8, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_fp32_kernel_refuses_unaligned_tensors(cuda):
    """The fp32 kernel copies 16-byte chunks by cp.async: a t stride of 33
    floats, and a base pointer 4 bytes off, raise; a bf16 launch does not
    count in ``launches_f32``."""
    strided = torch.zeros(1, 2, 8, 33, device=cuda)[..., :32]
    shifted = torch.zeros(2 * 8 * 32 + 1, device=cuda)[1:].view(1, 2, 8, 32)
    before = (flash_mod.launches, flash_mod.launches_f32)
    for q in (strided, shifted):
        with pytest.raises(ValueError, match="16-byte"):
            flash_mod.flash_attention_cuda(q, q, q)
    assert (flash_mod.launches, flash_mod.launches_f32) == before
    qb = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.bfloat16)
    flash_mod.flash_attention_cuda(qb, qb, qb)
    assert (flash_mod.launches, flash_mod.launches_f32) == (before[0] + 1,
                                                            before[1])


@pytest.mark.cuda
def test_fp32_flash_and_scan_run_on_every_card(cards):
    """More than 48 KB of shared memory a block is an opt-in held per
    device.  The fp32 flash kernel at D 256 (201,728 bytes) and the fp32
    scan, launched on each card in turn, run and hold their plain
    versions (2e-5, 1e-4) on every card, not only the first."""
    attn = flash_inputs(1, 2, 1, 100, 256)
    scan = scan_inputs(1, 40, 2, 64, 64)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            q, k, v = (torch.from_numpy(a).to(dev) for a in attn)
            np.testing.assert_allclose(
                flash_mod.flash_attention_cuda(q, k, v).cpu().numpy(),
                ref.attention_ref(q, k, v).cpu().numpy(), rtol=2e-5,
                atol=2e-5)
            seq = [torch.from_numpy(a).to(dev) for a in scan]
            for got, want in zip(scan_mod.linear_scan_cuda(*seq),
                                 ref.linear_scan_ref(*seq)):
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-4,
                                           atol=1e-4)


@pytest.mark.cuda
def test_bf16_flash_runs_on_every_card(cards):
    """The bf16 tensor-core kernel at D 256 takes more than 48 KB of
    shared memory a block, an opt-in held per device: launched on each
    card in turn, it runs and holds its plain version at 3e-2 on every
    card, not only the first."""
    attn = flash_inputs(1, 4, 2, 130, 256)
    for i in range(cards):
        dev = torch.device("cuda", i)
        with torch.cuda.device(dev):
            q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                       for a in attn)
            before = flash_mod.launches
            got = flash_mod.flash_attention_cuda(q, k, v, causal=True)
            want = ref.attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize(dev)
            assert flash_mod.launches == before + 1
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b", "gemma3-4b"])
def test_split_forward_over_nccl_matches_unmeshed(cards, arch, tmp_path):
    """Two ranks of an NCCL world, each on its card: the forward of the
    arch's smoke config with its dense layers split over a (1, 2) mesh
    (``MeshPar``: every layer kind ``"heads"``; T = 32 divides 2, so the
    residual stream runs split over T), through the kernel policy's CUDA
    kernels on each rank's heads, against the unmeshed forward at rtol
    1e-5 / atol 1e-5, the CPU tests' bound."""
    import torch_launch_jobs as jobs
    from repro_torch.kernels import build
    from torch_worlds import run_world
    build.kernel_library()  # built once, before the ranks load it
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(
        np.int32)
    ranks = run_world(2, jobs.tp_card, (arch, (1, 2), 0, {"tokens": tokens}),
                      tmp_path, backend="nccl")
    for r in ranks:
        assert set(r["dense"].values()) == {"heads"}
        kernel = "linear_scan" if arch == "rwkv6-7b" else "flash_attention"
        assert r["launches"][kernel] > 0, r["launches"]
        np.testing.assert_allclose(r["meshed"], r["unmeshed"], rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(ranks[0]["meshed"], ranks[1]["meshed"])


@pytest.mark.cuda
def test_split_train_step_over_nccl_matches_unmeshed(cards, tmp_path):
    """Two ranks of an NCCL world: one train step of gemma3-4b's smoke
    config on a (1, 2) mesh, its residual stream split over T and its
    loss read from each rank's vocabulary (the vocab-parallel cross
    entropy), against the unmeshed step from the same weights: loss, its
    parts and the grad norm at rtol 1e-4."""
    import torch_launch_jobs as jobs
    from torch_worlds import run_world
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, 256, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    ranks = run_world(2, jobs.tp_card_train, ("gemma3-4b", (1, 2), 0, batch),
                      tmp_path, backend="nccl")
    for r in ranks:
        assert r["describe"]["activations"] == "sequence"
        assert r["describe"]["logits"] == "vocab"
        for key, want in r["unmeshed"].items():
            np.testing.assert_allclose(r["meshed"][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    assert ranks[0]["meshed"] == ranks[1]["meshed"]


@pytest.mark.cuda
def test_head_dim_attention_over_four_nccl_ranks(four_cards, tmp_path):
    """Four ranks of an NCCL world, each on its card: gemma3-4b's smoke
    config on a (1, 4) mesh under the default attention rule, where its 2
    kv and 4 q heads do not divide 4 and its head dim of 16 does
    (``"head_dim"``): a session's prefill of 32 tokens, each rank's 8
    rows through the flash kernel at its query offset (launches counted),
    8 greedy decode steps replayed as a CUDA graph with the head-dim
    collectives captured, each rank's k / v caches (b, S, Hkv, Dh / 4);
    the unmeshed session's tokens and logits at 1e-5; one train step
    against the unmeshed one, loss and grad norm at rtol 1e-4."""
    import torch_launch_jobs as jobs
    from repro_torch.kernels import build
    from torch_worlds import run_world
    build.kernel_library()  # built once, before the ranks load it
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 256, (2, 32)).astype(np.int32)
    batch = {k: rng.integers(0, 256, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    ranks = run_world(4, jobs.head_dim_card,
                      ("gemma3-4b", (1, 4), 0, prompts, 8, batch), tmp_path,
                      backend="nccl")
    for r in ranks:
        assert r["dense"]["attn"] == "head_dim"
        assert r["meshed"]["launches"] > 0 and r["unmeshed"]["launches"] > 0
        assert r["meshed"]["decode"] == "cuda_graph"
        assert np.array_equal(r["meshed"]["tokens"], r["unmeshed"]["tokens"])
        np.testing.assert_allclose(r["meshed"]["logits"],
                                   r["unmeshed"]["logits"], rtol=1e-5,
                                   atol=1e-5)
        for path, shape in r["cache_shapes"].items():
            if path.rpartition("/")[2] in ("k", "v"):
                assert shape[-2:] == (2, 4), (path, shape)
        train = r["train"]
        assert train["describe"]["dense"]["attn"] == "head_dim"
        for key, want in train["unmeshed"].items():
            np.testing.assert_allclose(train["meshed"][key], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
    assert all(np.array_equal(r["meshed"]["logits"],
                              ranks[0]["meshed"]["logits"]) for r in ranks)


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
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,t,h,n,m", [(1, 200, 2, 64, 64), (1, 70, 2, 5, 16),
                                       (1, 70, 2, 128, 80)])
def test_linear_scan_kernel_with_small_decays(cuda, b, t, h, n, m, dtype):
    """Decays drawn log-uniform in [1e-6, 1], as RWKV6's exp(-exp(w))
    spreads them: the state forgets within a step on some rows and keeps
    everything on others (fp32 1e-4, bf16 5e-2)."""
    td = DTYPES[dtype]
    decay = np.exp(np.random.default_rng(18).uniform(
        np.log(1e-6), 0.0, size=(b, t, h, n))).astype(np.float32)
    _, *rest = scan_inputs(b, t, h, n, m)
    *seq, s0 = (torch.from_numpy(a).to(cuda) for a in (decay, *rest))
    seq = [a.to(td) for a in seq]
    y, s_t = scan_mod.linear_scan_cuda(*seq, s0)
    y_ref, s_ref = ref.linear_scan_ref(*seq, s0)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_ref.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(s_t.cpu().numpy(), s_ref.cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(48, 64), (64, 64), (128, 80)])
def test_linear_scan_kernel_carries_state_at_any_state_dim(cuda, n, m):
    """The two-halves state carry (1e-5) at N = 48, 64 and 128, split at
    step 33 of 70, inside a 32-step chunk."""
    b, t, h = 1, 70, 2
    decay, k, v, r, s0 = (torch.from_numpy(a).to(cuda) for a in
                          scan_inputs(b, t, h, n, m))
    y_full, s_full = scan_mod.linear_scan_cuda(decay, k, v, r, s0)
    half = [a[:, :33].contiguous() for a in (decay, k, v, r)]
    rest = [a[:, 33:].contiguous() for a in (decay, k, v, r)]
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
    # the bf16 kernel's 16-byte copies: a t stride of 33 elements and a
    # base pointer 2 bytes off
    qb = torch.zeros(1, 2, 8, 33, device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.flash_attention_cuda(qb, qb, qb)
    x = torch.zeros(1, 4, 1, 129, device=cuda)
    with pytest.raises(ValueError, match="state dim"):
        scan_mod.linear_scan_cuda(x, x, x, x, torch.zeros(1, 1, 129, 129,
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


# ------------------------------------------------------------- int8 ----

def _int8_kernel_zoo(seed=7) -> CNNGraph:
    """The softmax-free net of ``tests/test_int8_kernels.py`` in the
    port's graph classes: strided same-pad conv, channel counts 19 and
    33, leaky/relu epilogues, a same-padded MaxPool, a two-input Add,
    depthwise, two Dense tails."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, ci, co, **kw_args):
        return Conv2D(weights=rng.normal(0, 0.5, (kh, kw, ci, co)).astype(
            np.float32), bias=rng.normal(0, 0.1, (co,)).astype(np.float32),
            **kw_args)

    dw_w = rng.normal(0, 0.5, (3, 3, 12, 1)).astype(np.float32)
    dw_b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    return CNNGraph([
        Input(shape=(11, 9, 3), name="in"),
        conv(3, 3, 3, 12, padding="same", activation="relu", name="c1"),
        DepthwiseConv2D(weights=dw_w, bias=dw_b, padding="same",
                        activation="leaky_relu", name="dw"),
        Add(name="add", inputs=["dw", "c1"], activation="relu"),
        conv(3, 3, 12, 19, strides=(2, 2), padding="same",
             activation="leaky_relu", name="c2"),
        MaxPool(size=(2, 2), padding="same", name="mp"),
        conv(2, 2, 19, 33, padding="valid", name="c3"),
        Flatten(name="fl"),
        Dense(weights=rng.normal(0, 0.2, (2 * 2 * 33, 21)).astype(
                  np.float32),
              bias=rng.normal(0, 0.1, (21,)).astype(np.float32),
              activation="relu", name="d1"),
        Dense(weights=rng.normal(0, 0.2, (21, 10)).astype(np.float32),
              bias=rng.normal(0, 0.1, (10,)).astype(np.float32),
              name="d2"),
    ])


INT8_GRAPHS = {**NETS, "kernel_zoo": _int8_kernel_zoo}


def _int8_card_and_cpu(cuda, name):
    """One quantized graph (calibrated on the CPU) run on the card and
    on the CPU, 16 frames."""
    g = passes.optimize(INT8_GRAPHS[name](0 if name in NETS else 7),
                        simd_multiple=1)
    qg = quantize.quantize(g, _rnd(3, (16,) + tuple(g.input_shape)),
                           device="cpu")
    x = torch.from_numpy(_rnd(8, (16,) + tuple(g.input_shape)))
    with torch.inference_mode():
        cpu = torch_exec.forward_quantized(qg, x).numpy()
        card = torch_exec.forward_quantized(qg, x.to(cuda))
    assert card.device.type == "cuda"
    return card.cpu().numpy(), cpu


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["robot", "kernel_zoo"])
def test_int8_forward_on_the_card_equals_the_cpu(cuda, name):
    card, cpu = _int8_card_and_cpu(cuda, name)
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ball", "pedestrian", "residual"])
def test_int8_softmax_nets_on_the_card_match_the_cpu(cuda, name):
    card, cpu = _int8_card_and_cpu(cuda, name)
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_int8_accumulator_is_exact_at_wide_k(cuda):
    """The float64 sum, rounded, equals an int64 sum on the CPU for a
    3x3 convolution over 512 channels (K = 4,608 products of up to
    255 * 127)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-255, 256, (2, 9, 11, 512))
    w = rng.integers(-127, 128, (3, 3, 512, 16))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(np.einsum("nhwc,ck->nhwk", xp[:, i:i + 9, j:j + 11], w[i, j])
               for i in range(3) for j in range(3))
    acc = torch_exec._int_acc(torch_exec._conv(
        torch.from_numpy(x).double().to(cuda),
        torch.from_numpy(w).double().to(cuda), None, (1, 1), (1, 1, 1, 1)))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.cpu().numpy(), want)


@pytest.mark.cuda
def test_int8_session_on_the_card_equals_the_cpu_session(cuda):
    """The default int8 session calibrates on the card; the CPU session
    given the card's qparams computes the same frames bit for bit."""
    from repro_torch.engine import InferenceSession, SessionConfig
    sess = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8"))
    assert sess.info["device"] == "cuda:0"
    assert sess.qgraph.method == "percentile"
    cpu = InferenceSession(NETS["robot"](0), config=SessionConfig(
        backend="torch", precision="int8", device="cpu",
        calibration={"qparams": {n: (qp.scale, qp.zero_point)
                                 for n, qp in sess.qgraph.acts.items()}}))
    x = _rnd(9, (8,) + tuple(sess.input_shape))
    np.testing.assert_array_equal(sess.predict(x), cpu.predict(x))


# -------------------------------------------------------------- training --

# (b, t, h, hkv, dh, causal, window, bq, bk): tests/test_attention_vjp.py's
# cases, plus head dims 80 and 256
TRAIN_FLASH_CASES = [
    (2, 128, 4, 2, 32, True, None, 64, 64),
    (1, 256, 8, 8, 16, True, None, 128, 64),
    (2, 128, 4, 1, 32, False, None, 64, 64),
    (1, 128, 4, 4, 16, True, 48, 64, 64),
    (1, 128, 4, 2, 80, True, None, 64, 64),
    (1, 128, 2, 1, 256, True, None, 64, 128),
]
TRAIN_LOCAL_CASES = [  # (b, t, h, hkv, dh, window, bq)
    (2, 256, 4, 2, 32, 64, 64),
    (1, 512, 2, 2, 16, 100, 128),
    (1, 128, 4, 1, 32, 32, 32),
    (1, 128, 4, 2, 80, 32, 64),
    (1, 128, 2, 1, 256, 48, 64),
]


@pytest.mark.cuda
def test_cuda_wrappers_raise_under_grad_on_the_card(cuda):
    """A CUDA input that requires grad under grad mode: each wrapper
    raises naming the differentiable policy; under ``no_grad`` the same
    call launches."""
    x = torch.rand(1, 8, 8, 4, device=cuda, requires_grad=True)
    w = torch.rand(3, 3, 4, 4, device=cuda)
    b = torch.zeros(4, device=cuda)
    q = torch.rand(1, 2, 8, 32, device=cuda, requires_grad=True)
    s = torch.rand(1, 8, 2, 4, device=cuda, requires_grad=True)
    s0 = torch.zeros(1, 2, 4, 4, device=cuda)
    calls = [lambda: conv_mod.conv2d_cuda(x, w, b),
             lambda: pool_mod.maxpool2d_cuda(x),
             lambda: flash_mod.flash_attention_cuda(q, q, q),
             lambda: scan_mod.linear_scan_cuda(s, s, s, s, s0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="flash_jax"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _attn_grads(fn, arrays, do, device):
    ts = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(do).to(device))
    return [a.detach().cpu() for a in [out] + [t.grad for t in ts]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_FLASH_CASES + TRAIN_LOCAL_CASES)
def test_flash_backward_on_the_card_matches_the_cpu(cuda, case):
    """``flash_mha`` / ``local_mha``: output and dq/dk/dv on the card
    equal the CPU's at rtol 1e-4 / atol 1e-5."""
    from repro_torch.models import flash_mha, local_mha
    if len(case) == 9:
        b, t, h, hkv, dh, causal, window, bq, bk = case
        fn = lambda q, k, v: flash_mha(q, k, v, causal, window, None, bq, bk)  # noqa: E731
    else:
        b, t, h, hkv, dh, window, bq = case
        fn = lambda q, k, v: local_mha(q, k, v, window, None, bq)  # noqa: E731
    arrays = (_rnd(1, (b, t, h, dh), 0.5), _rnd(2, (b, t, hkv, dh), 0.5),
              _rnd(3, (b, t, hkv, dh), 0.5))
    do = _rnd(4, (b, t, h, dh), 0.5)
    for got, want in zip(_attn_grads(fn, arrays, do, cuda),
                         _attn_grads(fn, arrays, do, "cpu")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """One gemma3-4b ``.smoke()`` train step from the same weights on the
    card and the CPU: the grads at rtol 1e-4 / atol 1e-5, loss and grad
    norm at rtol 1e-4, the moments at rtol 1e-4 / atol 1e-5, the
    parameters as ``optim.parity`` holds them."""
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.core.tree import unflatten
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    from repro_torch.optim import AdamW, parity
    cfg = ARCHS["gemma3-4b"].smoke()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 32)),
             "labels": rng.integers(0, 256, (2, 32))}
    opt = AdamW(learning_rate=1e-3)
    host = init_params(cfg, torch.Generator().manual_seed(0))
    states, grads, metrics = [], [], []
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda p: p.to(dev, copy=True), host)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, _ = lm.loss_fn(unflatten(params, live), cfg, tb)
        grads.append(unflatten(params, [g.cpu() for g in torch.autograd.grad(
            loss, live)]))
        state = (params, opt.init(params),
                 torch.zeros((), dtype=torch.int32, device=dev))
        before = tree_map(lambda a: a.clone(), state[:2])
        state, m = lm.make_train_step(cfg, opt)(state, tb)
        states.append(state)
        metrics.append(m)
    for (k, a), (_, b) in zip(leaves_with_paths(grads[0]),
                              leaves_with_paths(grads[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[0][key]),
                                   float(metrics[1][key]), rtol=1e-4)
    flat = [{k: v.cpu().numpy() for k, v in leaves_with_paths(st[1])}
            for st in states]
    for k in flat[1]:
        if k != "step":
            np.testing.assert_allclose(flat[0][k], flat[1][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    marks = {}
    parity.mark_amplified(opt, before[1], before[0], grads[0], grads[1],
                          marks, 1e-5)
    parity.hold_params(*({k: v.cpu().numpy() for k, v in leaves_with_paths(
        st[0])} for st in states), marks, parity.adam_step_bound(
            1e-3, 0.1, 1.0), 1e-4, 1e-5)


# ------------------------------------------------------ LM decode graph ----

def _lm_backend(arch, dev, batch=2, **changes):
    """The arch's ``.smoke()`` config (fp32) on the card, as a
    ``"cuda-lm"`` backend with random weights from seed 0."""
    import dataclasses

    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.engine import CudaLMBackend
    cfg = dataclasses.replace(ARCHS[arch].smoke(), **changes)
    return CudaLMBackend(cfg, max_context=40, decode_batch=batch, device=dev)


def _graphed_generate(backend, prompts, new):
    """Greedy tokens and the last logits through ``backend.decode``: the
    first step eager, the second captured, the rest replayed."""
    logits, handle = backend.prefill(prompts)
    toks = [np.argmax(logits, -1).astype(np.int32)]
    for _ in range(new - 1):
        logits = backend.decode(handle, toks[-1])
        toks.append(np.argmax(logits, -1).astype(np.int32))
    return np.stack(toks, 1), logits, handle


def _eager_generate(backend, prompts, new):
    """The same loop through ``make_decode_step`` with an int position,
    eager, on the current stream: the oracle."""
    from repro_torch.models import lm
    cfg, params = backend.model_cfg, backend.params
    prefill = lm.make_prefill_step(cfg, backend.max_context, backend.policy)
    decode = lm.make_decode_step(cfg, backend.policy)
    with torch.inference_mode():
        logits, caches, pos = prefill(params, {"tokens": torch.from_numpy(
            prompts.astype(np.int64)).to(backend.device)})
        toks = [logits.argmax(-1)]
        for _ in range(new - 1):
            logits, caches, pos = decode(params, caches, toks[-1][:, None],
                                         pos)
            toks.append(logits.argmax(-1))
    return (torch.stack(toks, 1).cpu().numpy().astype(np.int32),
            logits.cpu().numpy())


def _prompts(seed, batch, t=12):
    return np.random.default_rng(seed).integers(
        0, 256, size=(batch, t)).astype(np.int32)


_DECODING = ["gemma3-4b", "gemma3-27b", "h2o-danube-3-4b", "qwen1.5-110b",
             "qwen2-vl-72b", "rwkv6-7b", "deepseek-moe-16b", "grok-1-314b",
             "zamba2-2.7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "gemma3-4b"])
def test_one_decode_step_captures(cuda, arch):
    """``make_decode_step`` with a device position captured as it stands
    in ``torch.cuda.graph``: nothing in the step (M-RoPE's section ids,
    the embedding scale, the positions, the ring slot, the mask) may
    copy from or wait for the host.  The replay gives the eager step's
    logits and caches bit for bit."""
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.core.tree import leaves
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    cfg = ARCHS[arch].smoke()
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(_prompts(5, 2).astype(np.int64)).to(cuda)
    prefill, decode = lm.make_prefill_step(cfg, 40), lm.make_decode_step(cfg)
    with torch.inference_mode():
        _, c_eager, p_eager = prefill(params, {"tokens": toks})
        _, c_graph, p_graph = prefill(params, {"tokens": toks})
        tok = toks[:, -1:].clone()
        pos = torch.full((), p_graph, dtype=torch.int64, device=cuda)
        side = torch.cuda.Stream(cuda)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):  # warm-up, on caches of its own
            _, c_warm, _ = prefill(params, {"tokens": toks})
            decode(params, c_warm, tok, pos.clone())
        torch.cuda.current_stream(cuda).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _, nxt = decode(params, c_graph, tok, pos)
        graph.replay()
        want, c_eager, _ = decode(params, c_eager, tok, p_eager)
        torch.cuda.synchronize(cuda)
    assert int(nxt) == p_eager + 1
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(c_graph),
                                                 leaves(c_eager)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,batch,changes", [
    (a, 2, {}) for a in _DECODING] + [
    # the MoE at capacity factor 1.25 and batch 4: 1 slot an expert, so
    # tokens drop in decode, and the graph must drop the same ones
    ("deepseek-moe-16b", 4, {"capacity_factor": 1.25})])
def test_graph_decode_equals_eager_decode(cuda, arch, batch, changes):
    """Prompts of 12 (past the smoke window of 8: the ring caches have
    wrapped), 8 new tokens: the replayed graph gives the eager loop's
    tokens and last logits bit for bit, and launches no kernel."""
    backend = _lm_backend(arch, cuda, batch, **changes)
    assert backend.describe()["decode"] == "cuda_graph"
    prompts = _prompts(1, batch)
    want_toks, want_logits = _eager_generate(backend, prompts, 8)

    def launches():
        return flash_mod.launches + scan_mod.launches

    before = launches()
    got_toks, got_logits, handle = _graphed_generate(backend, prompts, 8)
    run = launches() - before
    assert handle.graph is not None and handle.pos == 12 + 7
    np.testing.assert_array_equal(got_toks, want_toks)
    np.testing.assert_array_equal(got_logits, want_logits)
    before = launches()
    backend.prefill(prompts)
    assert run == launches() - before  # the prefill's, none in decode


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-7b", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_interleaved_handles_each_replay_their_own_graph(cuda, arch):
    """Two handles of one batch size decoded step by step in turns: each
    gives the tokens of its own run alone (no cache is shared)."""
    backend = _lm_backend(arch, cuda)
    pa, pb = _prompts(2, 2), _prompts(3, 2)
    alone = [_graphed_generate(backend, p, 10)[0] for p in (pa, pb)]
    (la, ha), (lb, hb) = backend.prefill(pa), backend.prefill(pb)
    ta, tb = [np.argmax(la, -1).astype(np.int32)], [
        np.argmax(lb, -1).astype(np.int32)]
    for _ in range(9):
        ta.append(np.argmax(backend.decode(ha, ta[-1]), -1).astype(np.int32))
        tb.append(np.argmax(backend.decode(hb, tb[-1]), -1).astype(np.int32))
    assert ha.graph is not None and hb.graph is not None
    assert ha.graph is not hb.graph
    np.testing.assert_array_equal(np.stack(ta, 1), alone[0])
    np.testing.assert_array_equal(np.stack(tb, 1), alone[1])


@pytest.mark.cuda
def test_capture_from_a_worker_thread(cuda):
    """The token server's worker captures and replays while the main
    thread launches a CNN forward on another stream."""
    import threading

    from repro_torch.engine import InferenceSession, SessionConfig
    from repro_torch.serve import LMTokenServer, ServerConfig
    backend = _lm_backend("gemma3-4b", cuda)
    prompts = _prompts(4, 2)
    want, _ = _eager_generate(backend, prompts, 12)
    cnn = InferenceSession(PAPER_CNNS["ball"](0), config=SessionConfig(
        backend="cuda"))
    frames = np.zeros((8,) + tuple(cnn.input_shape), np.float32)
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            cnn.predict(frames)

    other = threading.Thread(target=busy)
    other.start()
    try:
        with LMTokenServer(backend, config=ServerConfig(
                workers=1, max_batch=2, batch_deadline_ms=500.0,
                request_timeout_ms=None)) as srv:
            futs = [srv.submit(p, max_new=12) for p in prompts]
            got = np.stack([f.result(timeout=300) for f in futs])
    finally:
        stop.set()
        other.join()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_threads_capture_and_replay_through_one_backend(cuda):
    """Six threads generate through one graphed backend at once, each
    handle capturing its own graph: every thread gets its run alone."""
    import threading
    backend = _lm_backend("gemma3-4b", cuda)
    prompts = [_prompts(10 + s, 2) for s in range(6)]
    want = [_graphed_generate(backend, p, 8)[0] for p in prompts]
    got = [None] * len(prompts)

    def run(i):
        got[i] = _graphed_generate(backend, prompts[i], 8)[0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
