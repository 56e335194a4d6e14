"""The port on the card: each CUDA kernel against its plain version, and
the kernel path against the plain executor.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: conv fp32 1e-5 (fp32 sums in another order), bf16 3e-2 (the
output rounds to bf16), pool exact; whole nets rtol 1e-4 / atol 1e-5,
the tolerance of ``tests/test_pallas_cnn_path.py``.  TF32 is switched
off, since cuDNN's default keeps about three digits.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes, torch_exec
from repro_torch.kernels import conv2d as conv_mod
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
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NETS = {**PAPER_CNNS, **EXTRA_CNNS}


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


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
