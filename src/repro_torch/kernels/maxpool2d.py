"""Wrapper of the hand-written Hopper maxpool2d kernel
(``csrc/maxpool2d.cu``).

Replaces the JAX package's Pallas TPU kernel ``_pool_kernel`` /
``maxpool2d_pallas`` (``kernels/maxpool2d.py``): NHWC max pool, valid
padding, static window, stride defaulting to the window, exact in fp32
and bf16.  Bound by its bytes on the card, so the kernel is one
streaming pass: a thread owns one vector of channels (16 bytes where C
allows) of one output pixel, issues all its tap loads before any max,
and stores with streaming stores.  :func:`pool_plan` chooses the
instantiation (the 2x2/2 and 3x3/2 windows compiled in, or taps at run
time), the vector width and the grid;
it is pure Python, so the CPU tests check it and replay its thread map.
The TPU kernel's ``block_c`` lane tiling becomes the vector a thread
owns.

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

from .build import (check_launch, check_no_grad, check_operand,
                    current_stream, kernel_library)

DTYPES = (torch.float32, torch.bfloat16)

# (kh, kw, sh, sw) compiled into the kernel, by the variant index the C
# entry dispatches on; every other window takes variant 0, whose taps and
# strides are runtime values.  2x2/2: every pool of the four nets; 3x3/2:
# the JAX suite's.
POOL_VARIANTS = ((0, 0, 0, 0), (2, 2, 2, 2), (3, 3, 2, 2))
MAX_THREADS = 256       # the kernel's __launch_bounds__
MAX_BZ = 64             # CUDA's limit on blockDim.z
MAX_GRID_YZ = 65535     # CUDA's limit on gridDim.y and gridDim.z
INDEX32 = 2 ** 31       # tensors this large take the 64-bit instantiation

launches = 0
_count_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """How ``csrc/maxpool2d.cu`` covers one pool.

    A block has (bx, by, bz) threads and the grid (gx, gy, gz) blocks.
    Thread (x, y, z) of block (i, j, l) owns channel vector
    v = l * bx + x (v < nv) of output pixel ow = i * by + y (ow < OW) of
    output rows (j + t * gy) * bz + z, t = 0, 1, ... (rows < N * OH); a
    row is (n, oh) = divmod(row, OH)."""
    n: int
    oh: int
    ow: int
    c: int
    variant: int        # index into POOL_VARIANTS
    vec: int            # bytes of a channel vector: 16, 8, 4 or 2
    nv: int             # vectors a pixel holds
    bx: int
    by: int
    bz: int
    gx: int
    gy: int
    gz: int
    index64: int        # 1 where the tensors need 64-bit indices

    @property
    def threads(self) -> int:
        return self.bx * self.by * self.bz

    @property
    def block(self) -> Tuple[int, int, int]:
        return (self.bx, self.by, self.bz)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.gx, self.gy, self.gz)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def pool_plan(n: int, h: int, w: int, c: int, kh: int, kw: int, sh: int,
              sw: int, dtype: torch.dtype = torch.float32,
              align: int = 16) -> PoolPlan:
    """The plan for x (n,h,w,c) of ``dtype``, window (kh, kw), strides
    (sh, sw), whose data pointers are ``align``-byte aligned (a power of
    two): the widest vector that C's bytes and the alignment allow; the
    compiled taps where they exist; a block of up to 256 threads that
    spans a pixel's vectors, then a row's pixels, then rows."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not in {DTYPES}")
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} larger than input {h}x{w}")
    size = torch.finfo(dtype).bits // 8
    vec = next(v for v in (16, 8, 4, 2)
               if v >= size and (c * size) % v == 0 and align % v == 0)
    nv = c * size // vec
    index64 = int(n * h * w * c >= INDEX32)
    key = (kh, kw, sh, sw)
    variant = (POOL_VARIANTS.index(key) if key in POOL_VARIANTS
               and not index64 else 0)
    bx = min(nv, MAX_THREADS)
    by = min(ow, MAX_THREADS // bx)
    bz = max(1, min(MAX_THREADS // (bx * by), n * oh, MAX_BZ))
    return PoolPlan(n, oh, ow, c, variant, vec, nv, bx, by, bz,
                    _ceil(ow, by), min(_ceil(n * oh, bz), MAX_GRID_YZ),
                    _ceil(nv, bx), index64)


# the plan's fields that follow the shape in PoolArgs
PLAN_FIELDS = ("variant", "vec", "nv", "bx", "by", "bz", "gx", "gy", "gz",
               "index64")


class PoolArgs(ctypes.Structure):
    """Field for field the struct PoolArgs of ``csrc/maxpool2d.cu``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "h", "w", "c", "kh", "kw", "sh", "sw", "oh", "ow")
        + PLAN_FIELDS]


@functools.lru_cache(maxsize=None)
def _planned(n: int, h: int, w: int, c: int, kh: int, kw: int, sh: int,
             sw: int, dtype: torch.dtype,
             align: int) -> Tuple[PoolPlan, PoolArgs]:
    """The plan and arguments of one call shape, made once."""
    plan = pool_plan(n, h, w, c, kh, kw, sh, sw, dtype, align)
    return plan, PoolArgs(n, h, w, c, kh, kw, sh, sw, plan.oh, plan.ow,
                          *(getattr(plan, f) for f in PLAN_FIELDS))


def maxpool2d_cuda(x: torch.Tensor, *, size: Tuple[int, int] = (2, 2),
                   strides: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
    """x (N,H,W,C) fp32|bf16, contiguous on a CUDA device.  Launches on
    the current stream."""
    global launches
    check_no_grad("maxpool2d", x)
    check_operand(x, "x", 4, DTYPES)
    n, h, w, c = x.shape
    kh, kw = (int(s) for s in size)
    sh, sw = (int(s) for s in (strides or size))
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} larger than input {h}x{w}")
    y = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptr = x.data_ptr() | y.data_ptr()
    align = 16 if ptr % 16 == 0 else ptr & -ptr  # the lowest set bit
    plan, args = _planned(n, h, w, c, kh, kw, sh, sw, x.dtype, align)
    lib = kernel_library()
    fn = (lib.maxpool2d_nhwc_bf16 if x.dtype == torch.bfloat16
          else lib.maxpool2d_nhwc_f32)
    rc = fn(x.data_ptr(), y.data_ptr(), ctypes.addressof(args),
            current_stream(x.device))
    check_launch(rc, "maxpool2d")
    with _count_lock:
        launches += 1
    return y
