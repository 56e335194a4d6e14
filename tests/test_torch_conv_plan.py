"""The tiling of the conv2d kernel (``csrc/conv2d.cu``), checked on the CPU.

``conv_plan`` chooses the kernel's instantiation, tile and chunks.  For
every Conv2D of the four optimized nets and every conv case of the card
tests it must take the compile-time taps where they exist and the plan is
whole, fit in a Hopper block's 227 KB of shared memory, and cover
the output's channels, rows and columns exactly once; shapes whose full
output row does not fit get column tiles and filter chunks, and the
plans of the nets' layers stay as they were before those existed.
``emulate`` replays the kernel's indexing with numpy (the strip with its
zero padding, column tiles and chunks, the flattened positions and their
clamp, the filter layout, the dropped columns) and must give the plain
version's output at fp32 1e-5, or on the wide and deep shapes at
``conv_tol`` (rtol 1e-5, an atol that grows as the products a sum
takes); strip values the kernel never writes are NaN there, so a read
of one shows.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes
from repro_torch.core.graph import Conv2D
from repro_torch.kernels import conv2d as conv_mod
from repro_torch.kernels import ref
from repro_torch.kernels.cases import BIG_CONV_CASES, conv_tol
from test_torch_cuda import CUDA_CONV_CASES

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
MAIN_BATCH = {"robot": 64, "ball": 8, "pedestrian": 8, "residual": 8}


def _net_cases():
    """(n, h, w, ci, co, kh, kw, strides, padding) of every Conv2D of the
    optimized nets, at the main path's batch, at 1 (a served frame) and
    at 256 (the timed forward)."""
    out = []
    for name, f in NETS.items():
        g = passes.optimize(f(0), simd_multiple=4)
        smap = g.shape_map()
        for l in g.layers:
            if isinstance(l, Conv2D):
                h, w, ci = smap[l.inputs[0]]
                for n in (MAIN_BATCH[name], 1, 256):
                    out.append((n, h, w, ci, l.c_out, l.kh, l.kw,
                                tuple(l.strides), l.padding))
    return out


NET_CASES = _net_cases()
PLAN_CASES = NET_CASES + [(n, h, w, ci, co, kh, kw, (s, s), pad)
                          for n, h, w, ci, co, kh, kw, s, pad, _
                          in CUDA_CONV_CASES + BIG_CONV_CASES]
# every net layer's plan before column tiles and chunks existed: the
# ConvPlan fields from n to smem_bytes, by (n, h, w, ci, co, kh, kw,
# stride, padding)
PINNED_PLANS = {
    (8, 16, 16, 1, 8, 5, 5, 2, "same"):
        (8, 8, 8, 1, 1, 2, 8, 4, 8, 1, 32, 1, 8, 1, 19, 19, 4, 4, 5, 117, 5072),
    (1, 16, 16, 1, 8, 5, 5, 2, "same"):
        (1, 8, 8, 1, 1, 2, 8, 4, 8, 1, 32, 1, 8, 1, 19, 19, 4, 4, 5, 117, 5072),
    (256, 16, 16, 1, 8, 5, 5, 2, "same"):
        (256, 8, 8, 1, 1, 2, 8, 4, 8, 1, 32, 4, 2, 1, 19, 19, 4, 4, 11, 231, 6896),
    (8, 4, 4, 8, 12, 3, 3, 1, "valid"):
        (8, 2, 2, 0, 0, 1, 12, 4, 12, 1, 32, 1, 2, 1, 4, 4, 8, 12, 3, 14, 4128),
    (1, 4, 4, 8, 12, 3, 3, 1, "valid"):
        (1, 2, 2, 0, 0, 1, 12, 4, 12, 1, 32, 1, 2, 1, 4, 4, 8, 12, 3, 14, 4128),
    (256, 4, 4, 8, 12, 3, 3, 1, "valid"):
        (256, 2, 2, 0, 0, 1, 12, 4, 12, 1, 32, 1, 2, 1, 4, 4, 8, 12, 3, 14, 4128),
    (8, 2, 2, 12, 2, 2, 2, 1, "valid"):
        (8, 1, 1, 0, 0, 4, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 12, 12, 2, 5, 1008),
    (1, 2, 2, 12, 2, 2, 2, 1, "valid"):
        (1, 1, 1, 0, 0, 4, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 12, 12, 2, 5, 1008),
    (256, 2, 2, 12, 2, 2, 2, 1, "valid"):
        (256, 1, 1, 0, 0, 4, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 12, 12, 2, 5, 1008),
    (8, 36, 18, 1, 12, 3, 3, 1, "same"):
        (8, 36, 18, 1, 1, 1, 12, 4, 12, 1, 32, 1, 36, 1, 20, 20, 4, 4, 3, 62, 2720),
    (1, 36, 18, 1, 12, 3, 3, 1, "same"):
        (1, 36, 18, 1, 1, 1, 12, 4, 12, 1, 32, 1, 36, 1, 20, 20, 4, 4, 3, 62, 2720),
    (256, 36, 18, 1, 12, 3, 3, 1, "same"):
        (256, 36, 18, 1, 1, 1, 12, 4, 12, 1, 96, 18, 2, 1, 20, 20, 4, 4, 20, 402, 8160),
    (8, 18, 9, 12, 32, 3, 3, 1, "same"):
        (8, 18, 9, 1, 1, 1, 8, 4, 32, 1, 32, 1, 18, 1, 11, 11, 12, 12, 3, 35, 15504),
    (1, 18, 9, 12, 32, 3, 3, 1, "same"):
        (1, 18, 9, 1, 1, 1, 8, 4, 32, 1, 32, 1, 18, 1, 11, 11, 12, 12, 3, 35, 15504),
    (256, 18, 9, 12, 32, 3, 3, 1, "same"):
        (256, 18, 9, 1, 1, 1, 8, 4, 32, 1, 32, 9, 2, 1, 11, 11, 12, 12, 11, 123, 19728),
    (8, 9, 4, 32, 64, 3, 3, 1, "same"):
        (8, 9, 4, 1, 1, 1, 8, 4, 32, 2, 32, 1, 9, 1, 6, 6, 32, 36, 3, 20, 39744),
    (1, 9, 4, 32, 64, 3, 3, 1, "same"):
        (1, 9, 4, 1, 1, 1, 8, 4, 32, 2, 32, 1, 9, 1, 6, 6, 32, 36, 3, 20, 39744),
    (256, 9, 4, 32, 64, 3, 3, 1, "same"):
        (256, 9, 4, 1, 1, 1, 8, 4, 32, 2, 32, 9, 1, 1, 6, 6, 32, 36, 11, 68, 46656),
    (8, 4, 2, 64, 2, 4, 2, 1, "valid"):
        (8, 1, 1, 0, 0, 3, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 64, 68, 4, 9, 10640),
    (1, 4, 2, 64, 2, 4, 2, 1, "valid"):
        (1, 1, 1, 0, 0, 3, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 64, 68, 4, 9, 10640),
    (256, 4, 2, 64, 2, 4, 2, 1, "valid"):
        (256, 1, 1, 0, 0, 3, 4, 8, 4, 1, 32, 1, 1, 1, 2, 2, 64, 68, 4, 9, 10640),
    (64, 60, 80, 3, 8, 3, 3, 1, "same"):
        (64, 60, 80, 1, 1, 1, 8, 4, 8, 1, 128, 12, 5, 2, 82, 82, 4, 4, 14, 1150, 19552),
    (1, 60, 80, 3, 8, 3, 3, 1, "same"):
        (1, 60, 80, 1, 1, 1, 8, 4, 8, 1, 32, 1, 60, 1, 82, 82, 4, 4, 3, 248, 5120),
    (256, 60, 80, 3, 8, 3, 3, 1, "same"):
        (256, 60, 80, 1, 1, 1, 8, 4, 8, 1, 128, 30, 2, 5, 82, 82, 4, 4, 32, 2626, 43168),
    (64, 30, 40, 8, 12, 3, 3, 1, "same"):
        (64, 30, 40, 1, 1, 1, 12, 4, 12, 1, 64, 6, 5, 1, 42, 42, 8, 12, 8, 338, 19680),
    (1, 30, 40, 8, 12, 3, 3, 1, "same"):
        (1, 30, 40, 1, 1, 1, 12, 4, 12, 1, 32, 1, 30, 1, 42, 42, 8, 12, 3, 128, 9600),
    (256, 30, 40, 8, 12, 3, 3, 1, "same"):
        (256, 30, 40, 1, 1, 1, 12, 4, 12, 1, 160, 15, 2, 1, 42, 42, 8, 12, 17, 716, 37824),
    (64, 30, 40, 12, 8, 3, 3, 1, "same"):
        (64, 30, 40, 1, 1, 1, 8, 4, 8, 1, 64, 6, 5, 1, 42, 42, 12, 12, 8, 338, 19680),
    (1, 30, 40, 12, 8, 3, 3, 1, "same"):
        (1, 30, 40, 1, 1, 1, 8, 4, 8, 1, 32, 1, 30, 1, 42, 42, 12, 12, 3, 128, 9600),
    (256, 30, 40, 12, 8, 3, 3, 1, "same"):
        (256, 30, 40, 1, 1, 1, 8, 4, 8, 1, 160, 15, 2, 1, 42, 42, 12, 12, 17, 716, 37824),
    (64, 15, 20, 8, 16, 3, 3, 1, "same"):
        (64, 15, 20, 1, 1, 1, 8, 4, 16, 1, 32, 3, 5, 1, 22, 22, 8, 12, 5, 112, 9984),
    (1, 15, 20, 8, 16, 3, 3, 1, "same"):
        (1, 15, 20, 1, 1, 1, 8, 4, 16, 1, 32, 1, 15, 1, 22, 22, 8, 12, 3, 68, 7872),
    (256, 15, 20, 8, 16, 3, 3, 1, "same"):
        (256, 15, 20, 1, 1, 1, 8, 4, 16, 1, 32, 5, 3, 1, 22, 22, 8, 12, 7, 156, 12096),
    (64, 15, 20, 16, 20, 3, 3, 1, "same"):
        (64, 15, 20, 1, 1, 1, 12, 4, 24, 1, 32, 3, 5, 1, 22, 22, 16, 20, 5, 112, 22784),
    (1, 15, 20, 16, 20, 3, 3, 1, "same"):
        (1, 15, 20, 1, 1, 1, 12, 4, 24, 1, 32, 1, 15, 1, 22, 22, 16, 20, 3, 68, 19264),
    (256, 15, 20, 16, 20, 3, 3, 1, "same"):
        (256, 15, 20, 1, 1, 1, 12, 4, 24, 1, 32, 5, 3, 1, 22, 22, 16, 20, 7, 156, 26304),
    (8, 16, 16, 3, 8, 3, 3, 1, "same"):
        (8, 16, 16, 1, 1, 1, 8, 4, 8, 1, 32, 1, 16, 1, 18, 18, 4, 4, 3, 56, 2048),
    (1, 16, 16, 3, 8, 3, 3, 1, "same"):
        (1, 16, 16, 1, 1, 1, 8, 4, 8, 1, 32, 1, 16, 1, 18, 18, 4, 4, 3, 56, 2048),
    (256, 16, 16, 3, 8, 3, 3, 1, "same"):
        (256, 16, 16, 1, 1, 1, 8, 4, 8, 1, 32, 6, 3, 1, 18, 18, 4, 4, 8, 146, 3488),
    (8, 16, 16, 8, 8, 1, 1, 1, "valid"):
        (8, 16, 16, 0, 0, 5, 8, 4, 8, 1, 32, 1, 16, 1, 16, 16, 8, 12, 1, 16, 1024),
    (1, 16, 16, 8, 8, 1, 1, 1, "valid"):
        (1, 16, 16, 0, 0, 5, 8, 4, 8, 1, 32, 1, 16, 1, 16, 16, 8, 12, 1, 16, 1024),
    (256, 16, 16, 8, 8, 1, 1, 1, "valid"):
        (256, 16, 16, 0, 0, 5, 8, 4, 8, 1, 32, 8, 2, 1, 16, 16, 8, 12, 8, 128, 6400),
    (8, 16, 16, 8, 4, 1, 1, 1, "valid"):
        (8, 16, 16, 0, 0, 5, 4, 8, 4, 1, 32, 1, 16, 1, 16, 16, 8, 12, 1, 16, 896),
    (1, 16, 16, 8, 4, 1, 1, 1, "valid"):
        (1, 16, 16, 0, 0, 5, 4, 8, 4, 1, 32, 1, 16, 1, 16, 16, 8, 12, 1, 16, 896),
    (256, 16, 16, 8, 4, 1, 1, 1, "valid"):
        (256, 16, 16, 0, 0, 5, 4, 8, 4, 1, 32, 8, 2, 1, 16, 16, 8, 12, 8, 128, 6272),
    (8, 16, 16, 8, 4, 3, 3, 1, "same"):
        (8, 16, 16, 1, 1, 1, 4, 8, 4, 1, 32, 1, 16, 1, 18, 18, 8, 12, 3, 56, 3840),
    (1, 16, 16, 8, 4, 3, 3, 1, "same"):
        (1, 16, 16, 1, 1, 1, 4, 8, 4, 1, 32, 1, 16, 1, 18, 18, 8, 12, 3, 56, 3840),
    (256, 16, 16, 8, 4, 3, 3, 1, "same"):
        (256, 16, 16, 1, 1, 1, 4, 8, 4, 1, 32, 8, 2, 1, 18, 18, 8, 12, 10, 182, 9888),
    (8, 1, 1, 8, 4, 1, 1, 1, "valid"):
        (8, 1, 1, 0, 0, 5, 4, 8, 4, 1, 32, 1, 1, 1, 1, 1, 8, 12, 1, 1, 176),
    (1, 1, 1, 8, 4, 1, 1, 1, "valid"):
        (1, 1, 1, 0, 0, 5, 4, 8, 4, 1, 32, 1, 1, 1, 1, 1, 8, 12, 1, 1, 176),
    (256, 1, 1, 8, 4, 1, 1, 1, "valid"):
        (256, 1, 1, 0, 0, 5, 4, 8, 4, 1, 32, 1, 1, 1, 1, 1, 8, 12, 1, 1, 176),
}


def test_every_net_conv_is_covered():
    # 5 robot layers, 4 pedestrian, 3 ball, 5 residual, at three batches
    assert len(NET_CASES) == 17 * 3


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,strides,padding", PLAN_CASES)
def test_conv_plan_tiles(n, h, w, ci, co, kh, kw, strides, padding):
    p = conv_mod.conv_plan(n, h, w, ci, co, kh, kw, strides, padding)
    key = (kh, kw) + tuple(strides)
    if key in conv_mod.TAP_VARIANTS and p.col_tiles == p.chunks == 1:
        assert conv_mod.TAP_VARIANTS[p.variant] == key
    else:
        assert p.variant == 0
    assert p.smem_bytes <= 227 * 1024
    assert p.smem_bytes == 4 * (p.strip_pix * p.cip + p.khc * p.kwc * p.cc
                                * p.cot)
    # channel tiles cover CO exactly once
    assert p.cot % p.c == 0 and p.cot % 4 == 0
    assert (p.co_tiles - 1) * p.cot < co <= p.co_tiles * p.cot
    # row and column tiles cover OH and OW exactly once, and the passes
    # every position
    assert (p.row_tiles - 1) * p.th < p.oh <= p.row_tiles * p.th
    assert (p.col_tiles - 1) * p.tw < p.ow <= p.col_tiles * p.tw
    assert p.passes * p.p * p.lanes >= p.th * p.wq
    assert p.lanes % 32 == 0 and 32 <= p.threads <= conv_mod.MAX_THREADS
    assert p.p == conv_mod.PIXELS[p.c]
    # chunks cover the input channels and the filter's rows and columns
    assert p.cc % 4 == 0 and p.ci4 == -(-ci // 4) * 4
    assert (p.c_chunks - 1) * p.cc < p.ci4 <= p.c_chunks * p.cc
    assert (p.h_chunks - 1) * p.khc < kh <= p.h_chunks * p.khc
    assert (p.w_chunks - 1) * p.kwc < kw <= p.w_chunks * p.kwc
    # the strip: every read in reach, a warp's pixels on distinct banks
    assert p.wq * strides[1] == p.wp * strides[0] and p.wq >= p.tw
    assert p.wp >= (p.tw - 1) * strides[1] + p.kwc
    assert p.strip_rows == (p.th - 1) * strides[0] + p.khc
    assert p.strip_pix >= max(p.strip_rows * p.wp, (p.th * p.wq - 1)
                              * strides[1] + (p.khc - 1) * p.wp + p.kwc)
    assert p.cip % 4 == 0 and (p.cip // 4) % 2 == 1 and p.cip >= p.cc
    # two blocks on each of the 132 SMs, where the shape has the rows
    assert p.grid[0] * p.grid[1] >= min(2 * conv_mod.SMS,
                                        n * p.oh * p.co_tiles)


@pytest.mark.parametrize("case", list(PINNED_PLANS))
def test_conv_plan_keeps_the_plans_that_fit_whole(case):
    """A net layer's plan is the one it had before column tiles and
    chunks: the same fields, one column tile of the full width, one
    chunk; so the layers' kernel launches are as they were."""
    n, h, w, ci, co, kh, kw, s, pad = case
    p = conv_mod.conv_plan(n, h, w, ci, co, kh, kw, (s, s), pad)
    assert dataclasses.astuple(p)[:21] == PINNED_PLANS[case]
    assert (p.tw, p.col_tiles, p.chunks) == (p.ow, 1, 1)
    assert (p.cc, p.khc, p.kwc) == (p.ci4, kh, kw)


def test_robot_layers_take_the_3x3_instantiation_at_batch_256():
    robot = [c for c in NET_CASES if c[0] == 256 and c[4] in (8, 12, 16, 20)
             and c[1] in (60, 30, 15)]
    assert len(robot) == 5
    for case in robot:
        p = conv_mod.conv_plan(*case)
        assert conv_mod.TAP_VARIANTS[p.variant] == (3, 3, 1, 1)


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         BIG_CONV_CASES)
def test_conv_plan_fits_what_a_full_row_does_not(n, h, w, ci, co, kh, kw,
                                                 stride, padding, act):
    """Shapes the TPU kernel computes whose full-width output row and
    filters exceed 227 KB: column tiles, then filter chunks, within the
    shared memory a block has."""
    st = (stride, stride)
    whole = list(conv_mod._tiles(n, h, w, ci, co, kh, kw, st, padding))
    assert not whole
    p = conv_mod.conv_plan(n, h, w, ci, co, kh, kw, st, padding)
    assert p.smem_bytes <= conv_mod.SMEM_BYTES
    assert p.col_tiles > 1 or p.chunks > 1
    assert p.variant == 0  # the general kernel takes its taps at run time
    if p.chunks > 1:
        # no column tile fits the whole filter
        assert not list(conv_mod._tiles(n, h, w, ci, co, kh, kw, st, padding,
                                        widths=[1]))
    if (p.khc, p.kwc) != (kh, kw):
        assert p.cc == 4  # filter rows or columns split only at 4 channels


def test_kernel_arguments_carry_the_plan():
    """The ctypes arguments the C entry reads: its struct's 38 four-byte
    fields, the shape and the plan as ``conv_plan`` made them."""
    plan, args = conv_mod._planned(2, 13, 17, 3, 8, 3, 3, (1, 1), "same",
                                   "leaky_relu", 0.1)
    assert ctypes.sizeof(args) == 38 * 4
    assert plan == conv_mod.conv_plan(2, 13, 17, 3, 8, 3, 3, (1, 1), "same")
    for f in conv_mod.PLAN_FIELDS:
        assert getattr(args, f) == getattr(plan, f)
    assert (args.n, args.h, args.w, args.ci, args.co, args.kh, args.kw,
            args.sh, args.sw, args.pt, args.pl, args.oh, args.ow,
            args.act) == (2, 13, 17, 3, 8, 3, 3, 1, 1, 1, 1, 13, 17, 2)
    assert args.alpha == pytest.approx(0.1)


def emulate(x, w, b, strides, padding, act, alpha=0.1):
    """The kernel's arithmetic block by block, in numpy fp32."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    sh, sw = strides
    p = conv_mod.conv_plan(n, h, wd, ci, co, kh, kw, strides, padding)
    y = np.full((n, p.oh, p.ow, co), np.nan, np.float32)
    writes = np.zeros(y.shape, np.int32)
    q = np.arange(p.passes * p.p * p.lanes)
    qc = np.minimum(q, p.th * p.wq - 1)
    r, col = q // p.wq, q % p.wq
    wfull = np.zeros((kh, kw, p.c_chunks * p.cc, co), np.float32)
    wfull[:, :, :ci] = w
    # chunks: filter rows and columns outside, input channels inside
    chunks = [(hc * p.khc, wc * p.kwc, cc * p.cc)
              for hc in range(p.h_chunks) for wc in range(p.w_chunks)
              for cc in range(p.c_chunks)]
    for img in range(n):
        for rt in range(p.row_tiles):
            r0 = rt * p.th
            rows = min(p.th, p.oh - r0)
            for ct in range(p.col_tiles):
                c0 = ct * p.tw
                cols = min(p.tw, p.ow - c0)
                for cot in range(p.co_tiles):
                    co0 = cot * p.cot
                    hi = min(co, co0 + p.cot)
                    acc = np.zeros((q.size, p.cot), np.float32)
                    for i0, j0, ch0 in chunks:
                        khn = min(p.khc, kh - i0)
                        kwn = min(p.kwc, kw - j0)
                        strip = np.full((p.strip_pix, p.cip), np.nan,
                                        np.float32)
                        pix = np.arange(p.strip_rows * p.wp)
                        ih = r0 * sh - p.pt + i0 + pix // p.wp
                        iw = c0 * sw - p.pl + j0 + pix % p.wp
                        inside = ((ih >= 0) & (ih < h) & (iw >= 0)
                                  & (iw < wd))
                        strip[pix, :p.cc] = 0.0
                        nci = min(p.cc, ci - ch0)
                        strip[pix[inside], :nci] = x[img, ih[inside],
                                                     iw[inside],
                                                     ch0:ch0 + nci]
                        wt = np.zeros((khn, kwn, p.cc, p.cot), np.float32)
                        wt[..., :hi - co0] = wfull[i0:i0 + khn, j0:j0 + kwn,
                                                   ch0:ch0 + p.cc, co0:hi]
                        for i in range(khn):
                            for j in range(kwn):
                                xs = strip[qc * sw + i * p.wp + j, :p.cc]
                                acc += xs @ wt[i, j]
                    out = acc + np.pad(b[co0:hi], (0, p.cot - (hi - co0)))
                    if act == "relu":
                        out = np.where(out > 0, out, 0.0)
                    elif act == "leaky_relu":
                        out = np.where(out > 0, out, alpha * out)
                    keep = (r < rows) & (col < cols)
                    y[img, r0 + r[keep], c0 + col[keep], co0:hi] = out[
                        keep, :hi - co0]
                    writes[img, r0 + r[keep], c0 + col[keep], co0:hi] += 1
    assert (writes == 1).all(), "an output written other than once"
    return y


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         CUDA_CONV_CASES + BIG_CONV_CASES)
def test_emulated_tiling_matches_plain_conv(n, h, w, ci, co, kh, kw, stride,
                                            padding, act):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    wt = (rng.normal(size=(kh, kw, ci, co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    got = emulate(x, wt, b, (stride, stride), padding, act)
    want = ref.conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt),
                          torch.from_numpy(b), strides=(stride, stride),
                          padding=padding, act=act).numpy()
    assert not np.isnan(got).any()
    case = (n, h, w, ci, co, kh, kw, stride, padding, act)
    rtol, atol = (conv_tol(kh, kw, ci) if case in BIG_CONV_CASES
                  else (1e-5, 1e-5))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
