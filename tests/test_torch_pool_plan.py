"""The plan of the maxpool2d kernel (``csrc/maxpool2d.cu``), checked on the CPU.

``pool_plan`` chooses the kernel's instantiation, vector width and grid.
For every pool of the four optimized nets and every pool case of the
card tests it must take the compiled taps where they exist, the widest
vector that C's bytes and the data's alignment allow, and a launch CUDA
accepts.  ``replay`` walks the kernel's thread map with numpy
(block and thread coordinates to channel vector, output pixel and rows,
the row loop, the guards) and must store each output vector exactly
once; its max over the taps, in the storage type, must equal the plain
version's output exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes
from repro_torch.core.graph import MaxPool
from repro_torch.kernels import maxpool2d as pool_mod
from repro_torch.kernels import ref
from repro_torch.kernels.cases import EDGE_POOL_CASES
from test_torch_cuda import POOL_CASES, ROBOT_POOL_CASES

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
MAIN_BATCH = {"robot": 64, "ball": 8, "pedestrian": 8, "residual": 8}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _net_cases():
    """((n, h, w, c), size, strides) of every valid MaxPool of the
    optimized nets, at the main path's batch, at 1 and at 256."""
    out = []
    for name, f in NETS.items():
        g = passes.optimize(f(0), simd_multiple=4)
        smap = g.shape_map()
        for l in g.layers:
            if isinstance(l, MaxPool) and l.padding == "valid":
                h, w, c = smap[l.inputs[0]]
                for n in (MAIN_BATCH[name], 1, 256):
                    out.append(((n, h, w, c), tuple(l.size),
                                tuple(l.strides)))
    return out


NET_CASES = _net_cases()
CARD_CASES = POOL_CASES + ROBOT_POOL_CASES + EDGE_POOL_CASES
PLAN_CASES = NET_CASES + CARD_CASES


def _plan(shape, size, strides, dtype, align=16):
    n, h, w, c = shape
    sh, sw = strides or size
    return pool_mod.pool_plan(n, h, w, c, *size, sh, sw, DTYPES[dtype], align)


def test_every_net_pool_is_covered():
    # 1 ball pool, 3 pedestrian, 2 robot (residual has none), three batches
    assert len(NET_CASES) == 6 * 3


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,size,strides", PLAN_CASES)
def test_pool_plan_launches_what_cuda_takes(shape, size, strides, dtype):
    n, h, w, c = shape
    sh, sw = strides or size
    p = _plan(shape, size, strides, dtype)
    elem = 4 if dtype == "float32" else 2
    assert (p.oh, p.ow) == ((h - size[0]) // sh + 1, (w - size[1]) // sw + 1)
    key = tuple(size) + (sh, sw)
    if key in pool_mod.POOL_VARIANTS:
        assert pool_mod.POOL_VARIANTS[p.variant] == key
    else:
        assert p.variant == 0
    # the widest vector C's bytes allow
    assert p.vec in (16, 8, 4, 2) and p.vec >= elem
    assert p.nv * p.vec == c * elem
    assert all((c * elem) % v for v in (16, 8, 4) if v > p.vec)
    # CUDA's limits, and the grid covers vectors, pixels and (with the
    # row loop) rows
    assert 1 <= p.threads <= pool_mod.MAX_THREADS and p.bz <= 64
    assert p.gy <= 65535 and p.gz <= 65535
    assert (p.gz - 1) * p.bx < p.nv <= p.gz * p.bx
    assert (p.gx - 1) * p.by < p.ow <= p.gx * p.by
    assert p.gy * p.bz >= min(n * p.oh, 65535 * p.bz)
    assert p.index64 == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_robot_pools_take_the_compiled_2x2_with_16_byte_vectors(dtype):
    robot = [c for c in NET_CASES if c[0][0] == 256 and c[0][3] == 8
             and c[0][1] in (60, 30)]
    assert len(robot) == 2
    for case in robot:
        p = _plan(*case, dtype)
        assert (p.variant, p.vec) == (1, 16)
        # a warp's 32 lanes are neighbouring vectors of the output
        assert p.bx == p.nv and p.by == p.ow


@pytest.mark.parametrize("align,vec", [(16, 16), (8, 8), (4, 4)])
def test_pool_plan_narrows_the_vector_to_the_alignment(align, vec):
    assert _plan((2, 8, 8, 8), (2, 2), None, "float32", align).vec == vec
    assert _plan((2, 8, 8, 8), (2, 2), None, "bfloat16", align).vec == vec


def test_pool_plan_takes_64_bit_indices_past_2_to_the_31():
    """A tensor of 2**31 elements or more takes the 64-bit instantiation
    (runtime taps) instead of raising."""
    p = pool_mod.pool_plan(8, 2 ** 14, 2 ** 14, 2, 2, 2, 2, 2)
    assert (p.index64, p.variant) == (1, 0)
    assert p.gy == 65535 and p.gy * p.bz < p.n * p.oh  # the row loop runs
    small = pool_mod.pool_plan(2, 2 ** 15, 2 ** 14 - 1, 2, 2, 2, 2, 2)
    assert (small.index64, small.variant) == (0, 1)


@pytest.mark.parametrize("shape", [(256, 61, 81, 8), (2, 3, 3, 8)])
def test_pool_plan_compiles_3x3_stride_2_windows(shape):
    """3x3/2 takes its compiled taps, on rows of many outputs and of
    one, with a thread an output."""
    p = pool_mod.pool_plan(*shape, 3, 3, 2, 2)
    assert pool_mod.POOL_VARIANTS[p.variant] == (3, 3, 2, 2)
    assert (p.gx - 1) * p.by < p.ow <= p.gx * p.by
    assert p.threads == p.bx * p.by * p.bz <= pool_mod.MAX_THREADS


def test_kernel_arguments_carry_the_plan():
    plan, args = pool_mod._planned(2, 9, 9, 4, 3, 3, 2, 2, torch.float32, 16)
    assert plan == pool_mod.pool_plan(2, 9, 9, 4, 3, 3, 2, 2)
    for f in pool_mod.PLAN_FIELDS:
        assert getattr(args, f) == getattr(plan, f)
    assert (args.n, args.h, args.w, args.c, args.kh, args.kw, args.sh,
            args.sw, args.oh, args.ow) == (2, 9, 9, 4, 3, 3, 2, 2, 4, 4)


def thread_map(p):
    """(row, ow, v) of every output vector the threads of plan ``p``
    store, one entry a store, as the kernel's indexing makes them."""
    i, j, l, x, y, z = (a.ravel() for a in np.meshgrid(
        np.arange(p.gx), np.arange(p.gy), np.arange(p.gz), np.arange(p.bx),
        np.arange(p.by), np.arange(p.bz), indexing="ij"))
    v = l * p.bx + x
    live = v < p.nv
    i, j, v, y, z = i[live], j[live], v[live], y[live], z[live]
    rows, out = p.n * p.oh, []
    for t in range(-(-rows // (p.gy * p.bz))):
        row = (j + t * p.gy) * p.bz + z
        ow = i * p.by + y
        keep = (row < rows) & (ow < p.ow)
        out.append(np.stack([row[keep], ow[keep], v[keep]], 1))
    return np.concatenate(out)


def replay(x, size, strides, p):
    """The kernel's output on x (numpy, the storage type's values in
    fp32): each stored vector the max of its taps, NaN-propagating."""
    n, h, w, c = x.shape
    kh, kw = size
    sh, sw = strides or size
    epv = c // p.nv  # elements a vector
    xv = x.reshape(n, h, w, p.nv, epv)
    stores = thread_map(p)
    row, ow, v = stores.T
    img, oh = row // p.oh, row % p.oh
    m = None
    for a in range(kh):
        for b in range(kw):
            t = xv[img, oh * sh + a, ow * sw + b, v]
            m = t if m is None else np.maximum(m, t)
    y = np.full((n, p.oh, p.ow, p.nv, epv), np.nan, np.float32)
    writes = np.zeros((n, p.oh, p.ow, p.nv), np.int32)
    y[img, oh, ow, v] = m
    np.add.at(writes, (img, oh, ow, v), 1)
    assert (writes == 1).all(), "an output vector stored other than once"
    return y.reshape(n, p.oh, p.ow, c)


@pytest.mark.parametrize("shape,size,strides", NET_CASES)
def test_thread_map_stores_every_net_output_once(shape, size, strides):
    p = _plan(shape, size, strides, "float32")
    row, ow, v = thread_map(p).T
    seen = np.zeros((p.n * p.oh, p.ow, p.nv), np.int32)
    np.add.at(seen, (row, ow, v), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,size,strides", CARD_CASES)
def test_replayed_kernel_equals_plain_pool(shape, size, strides, dtype):
    td = DTYPES[dtype]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(
        np.float32)).to(td)
    got = replay(x.float().numpy(), size, strides,
                 _plan(shape, size, strides, dtype))
    want = ref.maxpool2d_ref(x, size=size, strides=strides)
    assert torch.equal(torch.from_numpy(got).to(td), want)
