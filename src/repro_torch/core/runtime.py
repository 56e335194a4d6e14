"""Compile-and-load harness for NNCG-generated C (the port's copy of the
JAX package's ``core/runtime.py``).

The paper's deployment story: the generated file has no dependencies
beyond ``math.h``/``libm`` (plus SSE intrinsics when enabled), so any
ANSI C compiler — native or cross — produces the executable.  Here we
compile a shared object with the host ``cc`` and bind it via ctypes so
the engine, tests and benchmarks can call it directly.

The ``.so`` cache lives in a directory of the port's own
(``<tmp>/nncg_cache/c_torch``), and :func:`compile_c` writes the ``.c``
and ``.so`` under unique temporary names and ``os.replace``s them into
place, so a process that builds a source another process or thread is
building at the same time never loads a half-written ``.so``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cgen import ISAS, QISAS, CodegenOptions
from .codegen import compile as compile_graph
from .graph import CNNGraph
from .schedule import Schedule

_CACHE_DIR = os.path.join(tempfile.gettempdir(), "nncg_cache", "c_torch")

# observability for the engine's caching tests/telemetry: how often the
# C compiler actually ran vs. the content-hash .so cache answering
COMPILE_STATS = {"cc_invocations": 0, "so_cache_hits": 0}
_STATS_LOCK = threading.Lock()  # builders may run on several threads


def _cc() -> str:
    return os.environ.get("CC", "cc")


_CC_FINGERPRINTS: dict = {}


def cc_fingerprint() -> str:
    """First line of ``$CC --version``, cached per resolved compiler.

    Part of every content-cache key (.so cache here, tuning cache in
    the engine): a compiler change must invalidate measured artifacts.
    """
    cc = _cc()
    if cc not in _CC_FINGERPRINTS:
        out = (subprocess.run([cc, "--version"], capture_output=True,
                              text=True, timeout=10).stdout
               if shutil.which(cc) else "")
        _CC_FINGERPRINTS[cc] = out.splitlines()[0].strip() if out else cc
    return _CC_FINGERPRINTS[cc]


def _write_atomic(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a unique temporary name in the
    same directory and ``os.replace``: a reader sees the whole file or
    none."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=os.path.basename(path) + ".")
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def compile_c(source: str, *, simd: str = "sse",
              extra_flags: Sequence[str] = (),
              key_extra: str = "") -> str:
    """Compile C source to a shared object; returns the .so path.

    The output is cached by content hash over (source, simd, flags,
    compiler), so an identical build never re-invokes the compiler and
    a toolchain change never serves a stale binary.  ``key_extra``
    folds additional provenance (e.g. the schedule digest) into the
    key; the source hash already subsumes it, but an explicit key keeps
    cache entries self-describing if codegen ever becomes ambiguous.

    The compiler writes a unique temporary ``.so``, which is then
    ``os.replace``d onto the cached name (the ``.c`` likewise): two
    builders of one source each compile, and either's complete file
    ends up in place.  A failed build raises with the compiler's stderr.
    """
    os.makedirs(_CACHE_DIR, exist_ok=True)
    key = hashlib.sha256(
        (source + repr(simd) + repr(tuple(extra_flags)) + key_extra
         + cc_fingerprint()).encode()
    ).hexdigest()[:16]
    so_path = os.path.join(_CACHE_DIR, f"nncg_{key}.so")
    if os.path.exists(so_path):
        with _STATS_LOCK:
            COMPILE_STATS["so_cache_hits"] += 1
        return so_path
    c_path = os.path.join(_CACHE_DIR, f"nncg_{key}.c")
    fd, tmp_c = tempfile.mkstemp(dir=_CACHE_DIR, prefix=f"nncg_{key}.",
                                 suffix=".c")
    with os.fdopen(fd, "w") as f:
        f.write(source)
    tmp_so = tmp_c[:-2] + ".so"
    flags = ["-O3", "-fPIC", "-shared", "-std=c99"]
    if simd in ISAS:
        flags.extend(ISAS[simd].cc_flags)
    elif simd in QISAS:
        flags.extend(QISAS[simd].cc_flags)
    cmd = [_cc(), *flags, *extra_flags, tmp_c, "-o", tmp_so, "-lm"]
    t0 = time.time()
    with _STATS_LOCK:
        COMPILE_STATS["cc_invocations"] += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"cc failed ({' '.join(cmd)}):\n{proc.stderr[:4000]}")
    compile_s = time.time() - t0
    os.replace(tmp_so, so_path)
    os.replace(tmp_c, c_path)
    _write_atomic(so_path + ".meta",
                  f"compile_s={compile_s:.3f} bytes={len(source)}\n")
    return so_path


@dataclass
class CompiledNet:
    """A callable wrapping the generated ``void f(const float*, float*)``.

    Also binds the reentrant ``<func>_ws(x, out, workspace)`` entry point
    when present: every call site supplies its own workspace, so the same
    .so can run one image per thread (``predict_batch(threads=k)``).

    ``precision`` makes the binding dtype-aware: an int8 build's
    workspace is a ``signed char`` arena (``workspace_bytes``), a float
    build's a float one (``workspace_floats``); the public x/out
    interface is float32 either way."""

    so_path: str
    func_name: str
    in_size: int
    out_size: int
    c_source_bytes: int
    batch_func_name: Optional[str] = None
    workspace_floats: int = 0
    arena_bytes: int = 0
    arena_buffer_sum_bytes: int = 0
    per_layer_live_bytes: Optional[dict] = None
    precision: str = "fp32"          # 'fp32' | 'int8'
    workspace_bytes: int = 0         # int8 builds: workspace in bytes
    simd: str = "sse"                # the variant actually compiled
                                     # (post CPU-feature fallback)
    # layer-pipelined builds (schedule.nstages > 1)
    pipeline_func_name: Optional[str] = None
    stage_func_names: Tuple[str, ...] = ()
    iface_elems: Tuple[int, ...] = ()
    arena_elems: int = 0             # per-stage private arena size
    schedule_digest: str = ""
    # (Adds, pools, Concat edges) the deployed schedule fused — the
    # net object self-describes which epilogues run at producer store
    # sites without re-deriving the schedule from the graph
    fused_counts: Tuple[int, int, int] = (0, 0, 0)

    @property
    def nstages(self) -> int:
        return max(len(self.stage_func_names), 1)

    @property
    def has_fusion(self) -> bool:
        return any(self.fused_counts)

    def __post_init__(self):
        lib = ctypes.CDLL(self.so_path)
        FLOATP = ctypes.POINTER(ctypes.c_float)
        self._fn = getattr(lib, self.func_name)
        self._fn.restype = None
        self._fn.argtypes = [FLOATP, FLOATP]
        self._batch_fn = None
        if self.batch_func_name and hasattr(lib, self.batch_func_name):
            self._batch_fn = getattr(lib, self.batch_func_name)
            self._batch_fn.restype = None
            self._batch_fn.argtypes = [FLOATP, FLOATP, ctypes.c_int]
        self._ws_fn = None
        # the workspace pointer type follows the build's precision
        self._ws_ctype = (ctypes.c_byte if self.precision == "int8"
                          else ctypes.c_float)
        if hasattr(lib, self.func_name + "_ws"):
            self._ws_fn = getattr(lib, self.func_name + "_ws")
            self._ws_fn.restype = None
            self._ws_fn.argtypes = [FLOATP, FLOATP,
                                    ctypes.POINTER(self._ws_ctype)]
        # reentrant batch entry: a whole batch in ONE foreign call on a
        # caller workspace — the serving worker-pool hot path
        self._batch_ws_fn = None
        if hasattr(lib, self.func_name + "_batch_ws"):
            self._batch_ws_fn = getattr(lib, self.func_name + "_batch_ws")
            self._batch_ws_fn.restype = None
            self._batch_ws_fn.argtypes = [FLOATP, FLOATP, ctypes.c_int,
                                          ctypes.POINTER(self._ws_ctype)]
        # pipelined builds: one function per stage + sequential driver
        self._stage_fns = []
        for sym in self.stage_func_names:
            fn = getattr(lib, sym)
            fn.restype = None
            # (in, out, ws) — element types vary per stage boundary;
            # bind as void* and pass raw buffer addresses
            fn.argtypes = [ctypes.c_void_p] * 3
            self._stage_fns.append(fn)
        self._pipeline_fn = None
        if self.pipeline_func_name:
            self._pipeline_fn = getattr(lib, self.pipeline_func_name)
            self._pipeline_fn.restype = None
            self._pipeline_fn.argtypes = [FLOATP, FLOATP,
                                          ctypes.POINTER(self._ws_ctype),
                                          ctypes.c_int]

    def _alloc_workspace(self) -> np.ndarray:
        if self.precision == "int8":
            return np.empty(max(self.workspace_bytes, 1), dtype=np.int8)
        return np.empty(max(self.workspace_floats, 1), dtype=np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        assert x.size == self.in_size, (x.size, self.in_size)
        out = np.empty(self.out_size, dtype=np.float32)
        self._fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def predict_batch(self, x: np.ndarray,
                      threads: Optional[int] = None) -> np.ndarray:
        """Run N images; returns ``(N, out_size)``.

        ``threads=None``/``1`` uses the generated C batch loop (one
        foreign call).  ``threads=k`` partitions the batch over k Python
        threads, each driving the reentrant ``<func>_ws`` entry with its
        own workspace — ctypes releases the GIL during the call, so this
        is true parallelism on the same .so.

        A layer-pipelined build (``nstages > 1``) streams the batch
        through :class:`PipelineRunner` instead when ``threads`` is not
        given: stage ``s`` of frame ``i`` overlaps stage ``s-1`` of
        frame ``i+1`` on separate cores."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        assert x.size % self.in_size == 0, (x.size, self.in_size)
        n = x.size // self.in_size
        out = np.empty(n * self.out_size, dtype=np.float32)
        if self._stage_fns and n > 1 and threads is None:
            PipelineRunner(self).run(x, out, n)
        elif threads is not None and threads > 1 \
                and self._ws_fn is not None and n > 1:
            self._predict_batch_threaded(x, out, n, threads)
        elif self._batch_fn is not None:
            self._batch_fn(
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_int(n))
        else:
            flat = x.reshape(n, self.in_size)
            for b in range(n):
                out[b * self.out_size:(b + 1) * self.out_size] = self(flat[b])
        return out.reshape(n, self.out_size)

    def _predict_batch_threaded(self, x: np.ndarray, out: np.ndarray,
                                n: int, threads: int) -> None:
        FLOATP = ctypes.POINTER(ctypes.c_float)
        k = min(threads, n)
        xf = x.reshape(-1)
        # contiguous chunk per thread: with the reentrant batch entry
        # each thread is ONE foreign call for its whole chunk
        bounds = [(n * t) // k for t in range(k + 1)]

        def run(t: int) -> None:
            ws = self._alloc_workspace()
            wp = ws.ctypes.data_as(ctypes.POINTER(self._ws_ctype))
            lo, hi = bounds[t], bounds[t + 1]
            if self._batch_ws_fn is not None:
                xi = xf[lo * self.in_size:hi * self.in_size]
                oi = out[lo * self.out_size:hi * self.out_size]
                self._batch_ws_fn(xi.ctypes.data_as(FLOATP),
                                  oi.ctypes.data_as(FLOATP),
                                  ctypes.c_int(hi - lo), wp)
                return
            for b in range(lo, hi):
                xi = xf[b * self.in_size:(b + 1) * self.in_size]
                oi = out[b * self.out_size:(b + 1) * self.out_size]
                self._ws_fn(xi.ctypes.data_as(FLOATP),
                            oi.ctypes.data_as(FLOATP), wp)

        with ThreadPoolExecutor(max_workers=k) as ex:
            list(ex.map(run, range(k)))

    def time_per_call_us(self, x: np.ndarray, iters: int = 2000,
                         warmup: int = 50) -> float:
        x = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty(self.out_size, dtype=np.float32)
        xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        fn = self._fn
        for _ in range(warmup):
            fn(xp, op)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(xp, op)
        return (time.perf_counter() - t0) / iters * 1e6


class PipelineRunner:
    """Stream frames through a layer-pipelined build, one thread per
    stage.

    Stage ``s`` of frame ``i`` runs concurrently with stage ``s-1`` of
    frame ``i+1``: each stage boundary has two interface buffers
    (double buffering, ``free``/``full`` semaphore pair) and each stage
    thread owns a private arena, so a frame flows buffer-to-buffer
    without ever blocking the stage behind it for more than one frame.
    ctypes releases the GIL around each stage call — the overlap is
    real core parallelism on the same .so."""

    def __init__(self, net: CompiledNet):
        if not net._stage_fns:
            raise ValueError("not a pipelined build (nstages == 1)")
        self.net = net

    def run(self, x: np.ndarray, out: np.ndarray, n: int) -> None:
        net = self.net
        S = len(net._stage_fns)
        dt = np.int8 if net.precision == "int8" else np.float32
        bufs = [np.empty((2, max(sz, 1)), dtype=dt)
                for sz in net.iface_elems]
        wss = [np.empty(max(net.arena_elems, 1), dtype=dt)
               for _ in range(S)]
        free = [threading.Semaphore(2) for _ in range(S - 1)]
        full = [threading.Semaphore(0) for _ in range(S - 1)]
        xf = x.reshape(-1)
        in_n, out_n = net.in_size, net.out_size
        abort = threading.Event()

        def wake_neighbours(s: int) -> None:
            # for good: each neighbour then finds ``abort`` set and stops
            if s > 0:
                free[s - 1].release(n + 2)
            if s < S - 1:
                full[s].release(n + 2)

        def worker(s: int) -> None:
            fn = net._stage_fns[s]
            ws_p = wss[s].ctypes.data
            for i in range(n):
                if s > 0:
                    full[s - 1].acquire()
                if s < S - 1:
                    free[s].acquire()
                if abort.is_set():
                    wake_neighbours(s)
                    return
                src = (xf[i * in_n:(i + 1) * in_n] if s == 0
                       else bufs[s - 1][i & 1])
                dst = (out[i * out_n:(i + 1) * out_n] if s == S - 1
                       else bufs[s][i & 1])
                fn(src.ctypes.data, dst.ctypes.data, ws_p)
                if s > 0:
                    free[s - 1].release()
                if s < S - 1:
                    full[s].release()

        def on_done(s: int, fut) -> None:
            if fut.exception() is not None:  # a stage failed: stop them all
                abort.set()
                wake_neighbours(s)

        with ThreadPoolExecutor(max_workers=S) as ex:
            futs = [ex.submit(worker, s) for s in range(S)]
            for s, fut in enumerate(futs):
                fut.add_done_callback(lambda f, s=s: on_done(s, f))
        for fut in futs:
            fut.result()  # re-raises the first failed stage's error


def build(graph: CNNGraph, opts: Optional[CodegenOptions] = None,
          extra_flags: Sequence[str] = (),
          schedule: Optional[Schedule] = None) -> CompiledNet:
    """graph -> C -> .so -> callable.

    ``schedule=None`` uses the default (epilogue fusion on, single
    stage); pass ``make_schedule(g, nstages=k)`` for the pipelined
    build."""
    opts = opts or CodegenOptions()
    actual = resolve_float_simd(opts.simd)
    if actual != opts.simd:
        opts = replace(opts, simd=actual)
    gs = compile_graph(graph, opts, schedule=schedule)
    so = compile_c(gs.source, simd=opts.simd, extra_flags=extra_flags,
                   key_extra="sched:" + gs.schedule.digest())
    return CompiledNet(
        so_path=so,
        func_name=gs.func_name,
        in_size=gs.in_elems,
        out_size=gs.out_elems,
        c_source_bytes=len(gs.source),
        batch_func_name=gs.entry_batch,
        workspace_floats=gs.workspace_elems,
        arena_bytes=gs.arena_bytes,
        arena_buffer_sum_bytes=gs.arena_buffer_sum_bytes,
        per_layer_live_bytes=gs.per_layer_live_bytes,
        simd=opts.simd,
        pipeline_func_name=gs.entry_pipeline,
        stage_func_names=gs.stage_entries,
        iface_elems=gs.iface_elems,
        arena_elems=gs.arena_elems,
        schedule_digest=gs.schedule.digest(),
        fused_counts=(len(gs.schedule.fused_adds),
                      len(gs.schedule.fused_pools),
                      len(gs.schedule.fused_concats)),
    )


def build_quantized(qgraph, opts: Optional[CodegenOptions] = None,
                    extra_flags: Sequence[str] = (),
                    schedule: Optional[Schedule] = None) -> CompiledNet:
    """Calibrated int8 graph -> C -> .so -> callable (float32 in/out).

    ``qgraph`` is a :class:`repro_torch.core.quantize.QuantizedGraph`; the
    compiled net's workspace is the byte-planned int8 arena (~4x
    smaller than the float build's).  The requested kernel variant is
    resolved against the host's CPU features first (walking the QISA
    fallback chain), so e.g. an AVX-512-VNNI .so is never built — let
    alone loaded — on a non-VNNI host; ``CompiledNet.simd`` reports
    what actually ran."""
    opts = opts or CodegenOptions()
    actual = resolve_int8_simd(opts.simd)
    if actual != opts.simd:
        opts = replace(opts, simd=actual)
    gs = compile_graph(qgraph, opts, schedule=schedule)
    so = compile_c(gs.source, simd=opts.simd, extra_flags=extra_flags,
                   key_extra="sched:" + gs.schedule.digest())
    return CompiledNet(
        so_path=so,
        func_name=gs.func_name,
        in_size=gs.in_elems,
        out_size=gs.out_elems,
        c_source_bytes=len(gs.source),
        batch_func_name=gs.entry_batch,
        workspace_floats=0,
        arena_bytes=gs.arena_bytes,
        arena_buffer_sum_bytes=gs.arena_buffer_sum_bytes,
        per_layer_live_bytes=gs.per_layer_live_bytes,
        precision="int8",
        workspace_bytes=gs.workspace_elems,
        simd=opts.simd,
        pipeline_func_name=gs.entry_pipeline,
        stage_func_names=gs.stage_entries,
        iface_elems=gs.iface_elems,
        arena_elems=gs.arena_elems,
        schedule_digest=gs.schedule.digest(),
        fused_counts=(len(gs.schedule.fused_adds),
                      len(gs.schedule.fused_pools),
                      len(gs.schedule.fused_concats)),
    )


# -- runtime CPU-feature detection ----------------------------------------

_CPU_FEATURES: Optional[frozenset] = None
_FEATURE_OVERRIDE: Optional[frozenset] = None


def cpu_features() -> frozenset:
    """The host CPU's feature tokens — the union of every ``flags``
    (x86) / ``Features`` (ARM) line in /proc/cpuinfo, split on
    whitespace.  Token-based on purpose: a substring test would accept
    ``avx512f`` as evidence of ``avx``-anything."""
    if _FEATURE_OVERRIDE is not None:
        return _FEATURE_OVERRIDE
    global _CPU_FEATURES
    if _CPU_FEATURES is None:
        feats = set()
        if os.path.exists("/proc/cpuinfo"):
            with open("/proc/cpuinfo") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    if key.strip().lower() in ("flags", "features"):
                        feats.update(rest.split())
        _CPU_FEATURES = frozenset(feats)
    return _CPU_FEATURES


class force_cpu_features:
    """Test hook: pretend the host advertises exactly ``feats``
    (``None`` restores real detection) inside a ``with`` block.  Lets
    the fallback chain be exercised on any machine without risking an
    actual SIGILL."""

    def __init__(self, feats: Optional[Sequence[str]]):
        self._feats = None if feats is None else frozenset(feats)
        self._prev: Optional[frozenset] = None

    def __enter__(self) -> None:
        global _FEATURE_OVERRIDE
        self._prev = _FEATURE_OVERRIDE
        _FEATURE_OVERRIDE = self._feats

    def __exit__(self, *exc) -> bool:
        global _FEATURE_OVERRIDE
        _FEATURE_OVERRIDE = self._prev
        return False


def _machine_arch() -> str:
    m = platform.machine().lower()
    return "arm" if ("arm" in m or "aarch" in m) else "x86"


def host_supports_ssse3() -> bool:
    return "ssse3" in cpu_features()


def host_supports_avx2() -> bool:
    feats = cpu_features()
    return "avx2" in feats and "fma" in feats


def best_isa() -> str:
    """Pick the widest supported vector mode (paper: 'extension of NNCG
    to other instruction sets like AVX can be realized rapidly')."""
    if host_supports_avx2():
        return "avx"
    if host_supports_ssse3():
        return "sse"
    return "structured"


def resolve_float_simd(requested: str) -> str:
    """Clamp a float-build SIMD request to what the host can run."""
    if requested == "avx" and not host_supports_avx2():
        requested = "sse"
    if requested == "sse" and not host_supports_ssse3():
        requested = "structured"
    return requested


def int8_simd_supported(name: str) -> bool:
    """True when the host can execute int8 kernel variant ``name``."""
    q = QISAS.get(name)
    if q is None:
        return True  # generic / structured: plain C, runs anywhere
    if q.arch != _machine_arch():
        return False
    feats = cpu_features()
    return all(f in feats for f in q.cpu_flags)


def resolve_int8_simd(requested: str) -> str:
    """Walk the QISA fallback chain down to the best variant the host
    advertises support for (SIGILL guard for every int8 build)."""
    name = requested
    while not int8_simd_supported(name):
        q = QISAS.get(name)
        name = q.fallback if q is not None and q.fallback else "generic"
    return name


def supported_int8_simds() -> List[str]:
    """Every int8 kernel variant this host can run, best-first."""
    order = ["avx_vnni", "avx_ubs", "avx", "sse", "neon_dot", "neon"]
    return [n for n in order if int8_simd_supported(n)] + ["generic"]
