"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one
shared library with a plain C interface::

    build/repro_torch_kernels/libkernels-<hash>.so

``<hash>`` covers every source, header and flag, so an edit rebuilds and
an unchanged tree reuses the library.  The directory lies under the
repository's ``build/``, which git ignores.  A missing ``nvcc`` raises
with the path that was tried; nothing falls back.  The bf16
flash-attention kernel takes its wgmma atoms from CuTe, whose headers
are found under ``$CUTLASS_HOME/include`` (by default
``/usr/local/cutlass``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CUTLASS_INCLUDE = Path(os.environ.get("CUTLASS_HOME")
                       or "/usr/local/cutlass") / "include"
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", f"-I{CUTLASS_INCLUDE}")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "conv2d_nhwc_f32": [_P] * 6,  # x, w, b, y, &ConvArgs, stream
    "conv2d_nhwc_bf16": [_P] * 6,
    "maxpool2d_nhwc_f32": [_P] * 4,  # x, y, &PoolArgs, stream
    "maxpool2d_nhwc_bf16": [_P] * 4,
    "flash_attention_f32": [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I] * 4
    + [_F, _P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I] * 4
    + [_F, _P],
    "flash_attention_f32_tiles": [_I, _P, _P],  # d, &block_q, &key_tile
    # q, k, v, o, &pos, scratch; b, s, hkv, g, dh; q's, k's and v's
    # strides; ring, windowed, window; pos, scale, chunk; stream
    "decode_attention_bf16": [_P] * 6 + [_I] * 5 + [_L] * 8 + [_I] * 3
    + [_L, _F, _I, _P],
    "linear_scan_f32": [_P] * 7 + [_I] * 5 + [_P],
    "linear_scan_bf16": [_P] * 7 + [_I] * 5 + [_P],
}


def nvcc_path() -> Path:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return Path(home) / "bin" / "nvcc"


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkernels-{_digest()}.so"


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen([str(c) for c in cmd], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    bad = [(cmd, p.returncode, out) for cmd, p, out in zip(cmds, procs, outs)
           if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"$ {' '.join(map(str, c))}\n(exit {rc})\n{out}"
            for c, rc, out in bad))
    return "".join(outs)


def build() -> Path:
    """Compile and link the kernels unless this exact build exists;
    returns the library's path.  The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = nvcc_path()
    if not nvcc.exists():
        raise FileNotFoundError(
            f"nvcc not found at {nvcc}: the port's CUDA kernels are built "
            f"from source (set CUDA_HOME to the CUDA toolkit)")
    tmp = BUILD_DIR / f"tmp-{so.stem}-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [tmp / (s.stem + ".o") for s in srcs]
    log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)])
    part = tmp / so.name
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", part, *objs]])
    so.with_suffix(".log").write_text(log)
    os.replace(part, so)  # atomic: a reader never sees a partial library
    for o in objs:
        o.unlink()
    tmp.rmdir()
    return so


_lock = threading.Lock()
_library = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``argtypes``/``restype`` of every C entry (int = cudaError_t)."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _library
    with _lock:
        if _library is None:
            _library = declare(ctypes.CDLL(str(build())))
    return _library


def check_no_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` where autograd would record ``kernel``'s
    call: grad mode on and an input that requires grad.  The CUDA kernels
    have no backward, so their output would carry no ``grad_fn`` and the
    loss would train with these inputs silently cut off from it.  Serving
    runs under ``no_grad`` / ``inference_mode``, or on tensors that
    require no grad, and never meets this."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            f"requires grad under grad mode; train through the "
            f"differentiable policy KernelPolicy(\"flash_jax\", "
            f"\"chunked\") (repro_torch.models.TRAIN_KERNELS), or call "
            f"the kernel under torch.no_grad()")


def check_operand(t: torch.Tensor, name: str, ndim: int, dtypes,
                  device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given rank,
    one of ``dtypes``, on ``device`` (when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def current_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the handle the C entries
    take."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
