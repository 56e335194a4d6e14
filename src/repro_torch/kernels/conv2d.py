"""Wrapper of the hand-written Hopper conv2d kernel (``csrc/conv2d.cu``).

Replaces the JAX package's Pallas TPU kernel ``_conv_kernel`` /
``conv2d_pallas`` (``kernels/conv2d.py``): NHWC x HWIO convolution plus
bias and none / relu / leaky_relu, fp32 accumulation, output in
``x.dtype``.  "same" padding is split the TensorFlow way.

A block computes ``th`` output rows by ``tw`` output columns (the full
output width where such a row fits) and ``cot`` output channels of one
image.  It stages the input strip under those pixels, halo and zero
padding included, and its filters in shared memory as fp32 (by
``cp.async`` where fp32); each thread then accumulates ``p`` output
pixels by ``c`` output channels in registers, with the filter taps
compiled in for the shapes of the four nets.  Every other shape takes a
general kernel with runtime taps, which also covers column tiles where
a full output row does not fit and, where a narrow tile's strip and
filters still do not fit, walks the filter in chunks of input channels
(and, for very large windows, of filter rows or columns), so every
shape the TPU kernel takes gets a plan.  :func:`conv_plan` chooses the
instantiation, the tile and the chunks; it is pure Python, so the CPU
tests check it.  The TPU kernel's ``block_cout`` lane tiling becomes the
block's channel tile.  What bounds each layer, and why the kernel stays
in fp32 on the CUDA cores, is in the note at the top of the source.

``launches`` counts the kernel launches of this process; it is a plain
integer, read and reset by ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch

from ..core.graph import _conv_pads
from .build import (check_launch, check_no_grad, check_operand,
                    current_stream, kernel_library)

ACTIVATIONS = {None: 0, "relu": 1, "leaky_relu": 2}
DTYPES = (torch.float32, torch.bfloat16)

# (kh, kw, sh, sw) compiled into the kernel, by the variant index the C
# entry dispatches on; every other shape takes variant 0, whose taps and
# strides are runtime values.  3x3: robot, pedestrian, ball, residual;
# 5x5 at stride 2: ball's first layer; 4x2: pedestrian's head; 2x2:
# ball's head; 1x1: residual's pointwise layers.
TAP_VARIANTS = ((0, 0, 0, 0), (3, 3, 1, 1), (5, 5, 2, 2), (4, 2, 1, 1),
                (2, 2, 1, 1), (1, 1, 1, 1))
# output channels a thread accumulates -> output pixels it accumulates
# (32 or 48 fp32 accumulators; 16 channels took about 200 registers and
# ran slower than two groups of 8)
PIXELS = {4: 8, 8: 4, 12: 4}
MAX_THREADS = 256      # the kernel's __launch_bounds__
MAX_COT = 32           # output channels a block holds at most
SMEM_BYTES = 232_448   # shared memory a block can use on Hopper (227 KB)
SMS = 132              # the H100 SXM's SMs; plans aim at 2 blocks on each
# clocks between a thread's dependent-free fused multiply-adds when few
# warps share a scheduler
FMA_CLOCKS = 4
# per-block staging cost, in fused multiply-adds per staged value
# (a global load, a conversion and a shared store, with their indexing)
STAGE_COST = 4

launches = 0
_count_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/conv2d.cu`` covers one convolution.

    The grid is (n * row_tiles * col_tiles, co_tiles); a block has
    ``threads`` = (cot / c) channel groups of ``lanes`` threads and covers
    ``th`` output rows by ``tw`` output columns.  Output pixel (r, col) of
    a tile is position q = r * wq + col of the tile's flattened rows,
    whose input window starts at strip pixel q * sw; columns from the
    tile's width to wq are computed and dropped.  A thread holds
    positions lane + k * lanes, k < p, of each of ``passes`` passes.

    Where the strip and the filters do not fit at once, the block walks
    chunks: ``khc`` filter rows by ``kwc`` filter columns by ``cc`` input
    channels, staging each chunk's strip and filters in turn while its
    sums stay in registers.  Variant 0 (runtime taps) runs the general
    kernel; the compiled variants run the compiled-tap kernel, and their
    plans are whole: one column tile and one chunk."""
    n: int
    oh: int
    ow: int
    pt: int             # zero rows above the image
    pl: int             # zero columns left of it
    variant: int        # index into TAP_VARIANTS
    c: int              # output channels a thread accumulates
    p: int              # output pixels a thread accumulates per pass
    cot: int            # output channels of a block (a multiple of c)
    co_tiles: int
    lanes: int          # threads of a channel group (a multiple of 32)
    th: int             # output rows of a block
    row_tiles: int
    passes: int
    wp: int             # strip width (the padded input width at full width)
    wq: int             # flattened output positions a row takes
    ci4: int            # input channels rounded up to 4
    cip: int            # floats a strip pixel takes in shared memory
    strip_rows: int
    strip_pix: int      # strip pixels allocated (the reads' reach)
    smem_bytes: int
    tw: int             # output columns of a block
    col_tiles: int
    cc: int             # input channels of a chunk (a multiple of 4)
    c_chunks: int
    khc: int            # filter rows of a chunk
    h_chunks: int
    kwc: int            # filter columns of a chunk
    w_chunks: int

    @property
    def threads(self) -> int:
        return self.cot // self.c * self.lanes

    @property
    def chunks(self) -> int:
        return self.c_chunks * self.h_chunks * self.w_chunks

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.n * self.row_tiles * self.col_tiles, self.co_tiles)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _divisions(m: int):
    """The distinct sizes ceil(m / k) for k = 1 .. m, largest first: the
    tile or chunk sizes that split ``m`` into k nearly equal parts."""
    return sorted({_ceil(m, k) for k in range(1, m + 1)}, reverse=True)


def _channel_options(co: int):
    """(c, channel groups) a block may take for ``co`` outputs, best
    first: up to 12 channels one thread holds them all, above that the
    c of 8 or 12 that pads the fewest channels (then the larger), then
    narrower tiles for shapes whose filters would not fit."""
    if co <= 12:
        first = (_ceil(co, 4) * 4, 1)
    else:
        first = min(((c, min(_ceil(co, c), MAX_COT // c)) for c in (12, 8)),
                    key=lambda o: (_ceil(co, o[0] * o[1]) * o[0] * o[1],
                                   -o[0]))
    return [first] + [(c, 1) for c in (12, 8, 4)
                      if c < first[0] * first[1] and (c, 1) != first]


def _clocks(blocks: int, threads: int, smem: int, acc: int, fmas: int,
            staged: int) -> Tuple[float, float]:
    """A rough clock count of one SM for a tile, and the warp
    instructions it issues: the clocks are the larger of the warp
    instructions all its blocks issue (four a clock, fused multiply-adds
    of dropped positions included, ``STAGE_COST`` a staged value) and one
    thread's chain of fused multiply-adds, at ``FMA_CLOCKS`` each, once
    for every wave of resident blocks."""
    regs = 2 * acc + 40
    resident = max(1, min(32, 2048 // threads, SMEM_BYTES // smem,
                          65536 // (threads * regs)))
    waves = _ceil(blocks, SMS * resident)
    issued = blocks / SMS * threads / 32 * (fmas + STAGE_COST * staged
                                            / threads)
    return max(issued / 4, waves * fmas * FMA_CLOCKS), issued


def _tiles(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int,
           strides: Tuple[int, int], padding: str, widths=None, chunk=None):
    """Every tile of x (n,h,w,ci) and w (kh,kw,ci,co) that fits in shared
    memory and has the fewest rows for its count of row tiles, as
    (option, rank, fields): ``option`` indexes :func:`_channel_options`,
    ``rank`` orders an option's tiles by the model (blocks up to two an
    SM, then :func:`_clocks`), ``fields`` are the ConvPlan's.  ``widths``
    are the tile widths to try (default: the full output width) and
    ``chunk`` the (cc, khc, kwc) a chunk takes (default: all of them)."""
    sh, sw = (int(s) for s in strides)
    pt, pb, pl, pr = _conv_pads((h, w, ci), kh, kw, (sh, sw), padding)
    oh = (h + pt + pb - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} larger than input {h}x{w}")
    ci4 = _ceil(ci, 4) * 4
    cc, khc, kwc = chunk or (ci4, kh, kw)
    key = (kh, kw, sh, sw)
    compiled = TAP_VARIANTS.index(key) if key in TAP_VARIANTS else 0
    # an odd count of 16-byte chunks a pixel: a warp's float4 reads of
    # 32 neighbouring pixels hit every bank once (stride 1)
    cip = cc if (cc // 4) % 2 else cc + 4
    splits = (_ceil(ci4, cc), _ceil(kh, khc), _ceil(kw, kwc))
    chunks = splits[0] * splits[1] * splits[2]
    taps = khc * kwc
    heights = sorted({_ceil(oh, rt) for rt in range(1, oh + 1)})
    for option, (c, groups) in enumerate(_channel_options(co)):
        cot = c * groups
        co_tiles = _ceil(co, cot)
        p = PIXELS[c]
        for tw in widths or (ow,):
            col_tiles = _ceil(ow, tw)
            # a plan that is not whole takes the general kernel, whose
            # taps are runtime values
            variant = compiled if col_tiles == chunks == 1 else 0
            # a full-width strip spans the padded row; a column tile's
            # its own columns and their halo
            wp = (w + pl + pr if (tw, kwc) == (ow, kw)
                  else (tw - 1) * sw + kwc)
            while wp * sh % sw:
                wp += 1      # q * sw must land on the strip's rows
            wq = wp * sh // sw
            for th in heights:
                strip_rows = (th - 1) * sh + khc
                reach = (th * wq - 1) * sw + (khc - 1) * wp + kwc
                strip_pix = max(strip_rows * wp, reach)
                smem = 4 * (strip_pix * cip + taps * cc * cot)
                if smem > SMEM_BYTES:
                    break
                row_tiles = _ceil(oh, th)
                blocks = n * row_tiles * col_tiles * co_tiles
                for lanes in range(32, MAX_THREADS // groups + 1, 32):
                    passes = _ceil(th * wq, p * lanes)
                    # a chunked block stages each chunk again each pass
                    stages = chunks * passes if chunks > 1 else 1
                    clocks, issued = _clocks(
                        blocks, groups * lanes, smem, c * p,
                        passes * p * c * chunks * taps * cc,
                        stages * (strip_rows * wp * cc + taps * cc * cot))
                    yield option, (-min(blocks, 2 * SMS), clocks, issued,
                                   -th, -tw), (
                        n, oh, ow, pt, pl, variant, c, p, cot, co_tiles,
                        lanes, th, row_tiles, passes, wp, wq, ci4, cip,
                        strip_rows, strip_pix, smem, tw, col_tiles, cc,
                        splits[0], khc, splits[1], kwc, splits[2])


def _best(tiles) -> Optional[ConvPlan]:
    """Of the first channel option with a tile, the tile the model ranks
    first; None where there is no tile."""
    tiles = list(tiles)
    if not tiles:
        return None
    first = min(option for option, _, _ in tiles)
    return ConvPlan(*min((rank, fields) for option, rank, fields in tiles
                         if option == first)[1])


def _chunks(ci4: int, kh: int, kw: int):
    """The (cc, khc, kwc) chunks to try where the whole filter does not
    fit, fewest chunks first: input channels in fewer, larger chunks,
    then (at 4 channels) filter rows, then (a row at a time) filter
    columns."""
    for cc in _divisions(ci4 // 4)[1:]:
        yield 4 * cc, kh, kw
    for khc in _divisions(kh)[1:]:
        yield 4, khc, kw
    for kwc in _divisions(kw)[1:]:
        yield 4, 1, kwc


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int,
              strides: Tuple[int, int] = (1, 1),
              padding: str = "valid") -> ConvPlan:
    """The variant and tile ``csrc/conv2d.cu`` runs for x (n,h,w,ci) and
    w (kh,kw,ci,co), taking the first of these that fits in shared
    memory: full-width row tiles; column tiles; column tiles over chunks
    of the filter (:func:`_chunks`).  Within each, the tile
    :func:`_best` picks.  One filter column of 4 input channels for 4
    outputs always fits, so every shape gets a plan."""
    args = (n, h, w, ci, co, kh, kw, strides, padding)
    plan = _best(_tiles(*args))  # raises where the window exceeds x
    if plan is None:
        _, _, pl, pr = _conv_pads((h, w, ci), kh, kw, strides, padding)
        widths = _divisions((w + pl + pr - kw) // strides[1] + 1)
        plan = _best(_tiles(*args, widths=widths[1:]))
        for chunk in ([] if plan else _chunks(_ceil(ci, 4) * 4, kh, kw)):
            plan = _best(_tiles(*args, widths=widths, chunk=chunk))
            if plan:
                break
    return plan


# the plan's fields that follow alpha in ConvArgs
PLAN_FIELDS = ("variant", "c", "cot", "lanes", "th", "row_tiles", "passes",
               "wp", "wq", "ci4", "cip", "strip_rows", "strip_pix",
               "co_tiles", "smem_bytes", "tw", "col_tiles", "cc", "c_chunks",
               "khc", "h_chunks", "kwc", "w_chunks")


class ConvArgs(ctypes.Structure):
    """Field for field the struct ConvArgs of ``csrc/conv2d.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "h", "w", "ci", "co", "kh", "kw", "sh", "sw", "pt", "pl", "oh",
        "ow", "act")] + [("alpha", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in PLAN_FIELDS]


@functools.lru_cache(maxsize=None)
def _planned(n: int, h: int, w: int, ci: int, co: int, kh: int, kw: int,
             strides: Tuple[int, int], padding: str, act: Optional[str],
             alpha: float) -> Tuple[ConvPlan, ConvArgs]:
    """The plan and arguments of one call shape, made once: a call then
    costs the host a dictionary lookup and the launch."""
    plan = conv_plan(n, h, w, ci, co, kh, kw, strides, padding)
    return plan, ConvArgs(n, h, w, ci, co, kh, kw, *strides, plan.pt,
                          plan.pl, plan.oh, plan.ow, ACTIVATIONS[act], alpha,
                          *(getattr(plan, f) for f in PLAN_FIELDS))


def conv2d_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                strides: Tuple[int, int] = (1, 1), padding: str = "valid",
                act: Optional[str] = None,
                alpha: float = 0.1) -> torch.Tensor:
    """x (N,H,W,CI) fp32|bf16, w (KH,KW,CI,CO) in x's type, b (CO,) fp32,
    all contiguous on one CUDA device.  Launches on the current stream."""
    global launches
    check_no_grad("conv2d", x, w, b)
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if padding not in ("same", "valid"):
        raise ValueError(f"padding {padding!r}")
    check_operand(x, "x", 4, DTYPES)
    check_operand(w, "w", 4, (x.dtype,), x.device)
    check_operand(b, "b", 1, (torch.float32,), x.device)
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    if wci != ci or b.shape[0] != co:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not match")
    plan, args = _planned(n, h, wd, ci, co, kh, kw,
                          tuple(int(s) for s in strides), padding, act,
                          float(alpha))
    y = torch.empty((n, plan.oh, plan.ow, co), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y
    lib = kernel_library()
    fn = (lib.conv2d_nhwc_bf16 if x.dtype == torch.bfloat16
          else lib.conv2d_nhwc_f32)
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            ctypes.addressof(args), current_stream(x.device))
    check_launch(rc, "conv2d")
    with _count_lock:
        launches += 1
    return y
