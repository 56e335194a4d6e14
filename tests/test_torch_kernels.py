"""The port's kernel entry points against the JAX package's Pallas kernels.

On the CPU, ``repro_torch.kernels.ops`` runs the plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs come from a numpy seed and go to
both.  Tolerances are those of ``tests/test_kernels.py``: conv fp32
1e-5, bf16 3e-2 (bf16 rounds at other places in the two frameworks),
pool exact.  The CUDA kernels themselves are held against the plain
versions by the ``cuda``-marked tests of ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch.core.graph import _conv_pads
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_cuda import CONV_CASES, CUDA_CONV_CASES, POOL_CASES

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act", CONV_CASES)
def test_conv2d_matches_pallas(n, h, w, ci, co, kh, kw, stride, padding, act,
                               dtype):
    xj, xt = _both(_rnd(0, (n, h, w, ci)), dtype)
    wj, wt = _both(_rnd(1, (kh, kw, ci, co), 0.2), dtype)
    b = _rnd(2, (co,))
    kw_args = dict(strides=(stride, stride), padding=padding, act=act)
    want = jops.conv2d(xj, wj, jnp.asarray(b), **kw_args)
    got = tops.conv2d(xt, wt, torch.from_numpy(b), **kw_args)
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_conv2d_blocked_cout_seam():
    """The JAX kernel tiled over c_out (block_cout=4) equals the port's
    untiled conv: no seam at the lane-block boundary."""
    x, w, b = _rnd(0, (1, 8, 8, 4)), _rnd(1, (3, 3, 4, 8), 0.2), _rnd(2, (8,))
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       padding="same", block_cout=4)
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), padding="same")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,size,stride", POOL_CASES)
def test_maxpool_matches_pallas(shape, size, stride, dtype):
    xj, xt = _both(_rnd(3, shape), dtype)
    want = jops.maxpool2d(xj, size=size, strides=stride)
    got = tops.maxpool2d(xt, size=size, strides=stride)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         CUDA_CONV_CASES)
def test_plain_conv2d_matches_library_conv(n, h, w, ci, co, kh, kw, stride,
                                           padding, act):
    """The per-tap products of the plain version against ``F.conv2d`` on
    the CPU (pads from the graph's TF-style split, applied by ``F.pad``)."""
    x = torch.from_numpy(_rnd(0, (n, h, w, ci)))
    wt = torch.from_numpy(_rnd(1, (kh, kw, ci, co), 0.2))
    b = torch.from_numpy(_rnd(2, (co,)))
    got = tref.conv2d_ref(x, wt, b, strides=(stride, stride), padding=padding)
    pt, pb, pl, pr = _conv_pads((h, w, ci), kh, kw, (stride, stride), padding)
    want = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)),
                    wt.permute(3, 2, 0, 1), b, stride=stride)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,size,stride", POOL_CASES)
def test_plain_maxpool2d_matches_library_pool(shape, size, stride):
    x = torch.from_numpy(_rnd(3, shape))
    got = tref.maxpool2d_ref(x, size=size, strides=stride)
    want = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride or size)
    assert torch.equal(got, want.permute(0, 2, 3, 1))


def test_build_without_nvcc_raises_with_its_path(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "bin" / "nvcc")):
        build.build()


def test_library_name_is_keyed_by_the_sources():
    name = build.library_path().name
    assert name.startswith("libkernels-") and name.endswith(".so")
    assert build.library_path() == build.library_path()


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.conv2d import conv2d_cuda
    from repro_torch.kernels.maxpool2d import maxpool2d_cuda
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv2d_cuda(x, torch.zeros(3, 3, 2, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        maxpool2d_cuda(x)
