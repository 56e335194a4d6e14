"""The tiling of the conv2d kernel (``csrc/conv2d.cu``), checked on the CPU.

``conv_plan`` chooses the kernel's instantiation and tile.  For every
Conv2D of the four optimized nets and every conv case of the card tests it
must take the compile-time taps where they exist, fit in a Hopper block's
227 KB of shared memory, and cover the output's channels and rows exactly
once.  ``emulate`` replays the kernel's indexing with numpy (the strip
with its zero padding, the flattened positions and their clamp, the
filter layout, the dropped columns) and must give the plain version's
output at fp32 1e-5; strip values the kernel never writes are NaN there,
so a read of one shows.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import passes
from repro_torch.core.graph import Conv2D
from repro_torch.kernels import conv2d as conv_mod
from repro_torch.kernels import ref
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
                          in CUDA_CONV_CASES]


def test_every_net_conv_is_covered():
    # 5 robot layers, 4 pedestrian, 3 ball, 5 residual, at three batches
    assert len(NET_CASES) == 17 * 3


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,strides,padding", PLAN_CASES)
def test_conv_plan_tiles(n, h, w, ci, co, kh, kw, strides, padding):
    p = conv_mod.conv_plan(n, h, w, ci, co, kh, kw, strides, padding)
    key = (kh, kw) + tuple(strides)
    if key in conv_mod.TAP_VARIANTS:
        assert conv_mod.TAP_VARIANTS[p.variant] == key
    else:
        assert p.variant == 0
    assert p.smem_bytes <= 227 * 1024
    assert p.smem_bytes == 4 * (p.strip_pix * p.cip + kh * kw * p.ci4 * p.cot)
    # channel tiles cover CO exactly once
    assert p.cot % p.c == 0 and p.cot % 4 == 0
    assert (p.co_tiles - 1) * p.cot < co <= p.co_tiles * p.cot
    # row tiles cover OH exactly once, and the passes every position
    assert (p.row_tiles - 1) * p.th < p.oh <= p.row_tiles * p.th
    assert p.passes * p.p * p.lanes >= p.th * p.wq
    assert p.lanes % 32 == 0 and 32 <= p.threads <= conv_mod.MAX_THREADS
    assert p.p == conv_mod.PIXELS[p.c]
    # the strip: every read in reach, a warp's pixels on distinct banks
    assert p.wq * strides[1] == p.wp * strides[0] and p.wq >= p.ow
    assert p.strip_rows == (p.th - 1) * strides[0] + kh
    assert p.strip_pix >= max(p.strip_rows * p.wp, (p.th * p.wq - 1)
                              * strides[1] + (kh - 1) * p.wp + kw)
    assert p.cip % 4 == 0 and (p.cip // 4) % 2 == 1 and p.cip >= ci
    # two blocks on each of the 132 SMs, where the shape has the rows
    assert p.grid[0] * p.grid[1] >= min(2 * conv_mod.SMS,
                                        n * p.oh * p.co_tiles)


def test_robot_layers_take_the_3x3_instantiation_at_batch_256():
    robot = [c for c in NET_CASES if c[0] == 256 and c[4] in (8, 12, 16, 20)
             and c[1] in (60, 30, 15)]
    assert len(robot) == 5
    for case in robot:
        p = conv_mod.conv_plan(*case)
        assert conv_mod.TAP_VARIANTS[p.variant] == (3, 3, 1, 1)


def test_conv_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError, match="shared memory"):
        conv_mod.conv_plan(1, 4, 4000, 16, 8, 3, 3, (1, 1), "same")


def test_kernel_arguments_carry_the_plan():
    """The ctypes arguments the C entry reads: its struct's 30 four-byte
    fields, the shape and the plan as ``conv_plan`` made them."""
    plan, args = conv_mod._planned(2, 13, 17, 3, 8, 3, 3, (1, 1), "same",
                                   "leaky_relu", 0.1)
    assert ctypes.sizeof(args) == 30 * 4
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
    taps = [(i, j) for i in range(kh) for j in range(kw)]
    for img in range(n):
        for rt in range(p.row_tiles):
            r0 = rt * p.th
            rows = min(p.th, p.oh - r0)
            strip = np.full((p.strip_pix, p.cip), np.nan, np.float32)
            pix = np.arange(p.strip_rows * p.wp)
            ih = r0 * sh - p.pt + pix // p.wp
            iw = pix % p.wp - p.pl
            inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
            strip[pix, :p.ci4] = 0.0
            strip[pix[inside], :ci] = x[img, ih[inside], iw[inside]]
            for ct in range(p.co_tiles):
                co0 = ct * p.cot
                wt = np.zeros((kh * kw, p.ci4, p.cot), np.float32)
                hi = min(co, co0 + p.cot)
                wt[:, :ci, :hi - co0] = w.reshape(kh * kw, ci, co)[
                    :, :, co0:hi]
                acc = np.zeros((q.size, p.cot), np.float32)
                for t, (i, j) in enumerate(taps):
                    xs = strip[qc * sw + i * p.wp + j, :p.ci4]
                    acc += xs @ wt[t]
                out = acc + np.pad(b[co0:hi], (0, p.cot - (hi - co0)))
                if act == "relu":
                    out = np.where(out > 0, out, 0.0)
                elif act == "leaky_relu":
                    out = np.where(out > 0, out, alpha * out)
                r, col = q // p.wq, q % p.wq
                keep = (r < rows) & (col < p.ow)
                y[img, r0 + r[keep], col[keep], co0:hi] = out[keep,
                                                              :hi - co0]
                writes[img, r0 + r[keep], col[keep], co0:hi] += 1
    assert (writes == 1).all(), "an output written other than once"
    return y


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,padding,act",
                         CUDA_CONV_CASES)
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
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
