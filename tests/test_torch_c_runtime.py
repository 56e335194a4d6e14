"""The C the port generates computes what the port computes, on the CPU.

* fp32 C of the four nets (the session's build: the host's widest ISA,
  the static unroll levels, fusion on, one stage) against
  ``torch_exec.forward`` at rtol 1e-3 / atol 1e-5, the reference's bar
  for C against its oracle;
* int8 C against ``torch_exec.forward_quantized`` on the same quantized
  graph: bit for bit on a softmax-free zoo graph with a two-branch
  Concat (every int8 variant, demoted to what the host runs) and on the
  robot, and at rtol 1e-5 / atol 1e-6 with the same argmax on the nets
  whose sinks are Softmax (libm's ``expf`` against PyTorch's);
* the reentrant ``_ws`` entry, ``predict_batch(threads=2)`` and a
  2-stage pipeline equal the plain batch loop bit for bit, fp32 and int8;
* the ``.so`` cache: one compiler run, then hits, in the port's own
  directory; two threads building one source at once both load a whole
  ``.so``;
* the CPU-feature guard demotes as the reference's chains do;
* the generic sources are strict ANSI C89.
"""
import ctypes
import shutil
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import runtime as jruntime
from repro.core.graph import (Add, AvgPool, CNNGraph, Concat, Conv2D,
                              DepthwiseConv2D, GlobalAvgPool, Input, MaxPool)
from repro_torch.configs.cnn_paper import EXTRA_CNNS, PAPER_CNNS
from repro_torch.core import cgen, codegen, passes, quantize, runtime
from repro_torch.core import torch_exec
from repro_torch.core.graph import from_reference_graph
from repro_torch.core.schedule import make_schedule

NETS = {**PAPER_CNNS, **EXTRA_CNNS}
SOFTMAX_NETS = ("ball", "pedestrian", "residual")
STRICT_FLAGS = ["-std=c89", "-pedantic-errors", "-Wall", "-Wextra", "-Werror"]


def _conv(rng, kh, kw, ci, co, **kw_args) -> Conv2D:
    w = rng.normal(0, 0.5, (kh, kw, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return Conv2D(weights=w, bias=b, **kw_args)


def _zoo_graph(seed=1):
    """The reference's int8 zoo graph (``tests/test_quantize.py``): every
    quantizable construct, a two-branch Concat, a relu sink, so the whole
    net is on the exact integer path; carried into the port."""
    rng = np.random.default_rng(seed)
    dw_w = rng.normal(0, 0.5, (3, 3, 8, 1)).astype(np.float32)
    dw_b = rng.normal(0, 0.1, (8,)).astype(np.float32)
    return from_reference_graph(CNNGraph([
        Input(shape=(12, 10, 3), name="in"),
        _conv(rng, 3, 3, 3, 8, padding="same", activation="relu", name="c1"),
        MaxPool(size=(2, 2), padding="same", name="mp"),
        DepthwiseConv2D(weights=dw_w, bias=dw_b, padding="same",
                        activation="leaky_relu", name="dw1"),
        _conv(rng, 1, 1, 8, 8, padding="valid", name="pw"),
        Add(name="add", inputs=["pw", "mp"], activation="relu"),
        _conv(rng, 1, 1, 8, 4, name="b1", inputs=["add"]),
        _conv(rng, 3, 3, 8, 4, padding="same", name="b2", inputs=["add"]),
        Concat(name="cat", inputs=["b1", "b2"]),
        AvgPool(size=(3, 3), strides=(2, 2), padding="same", name="ap"),
        GlobalAvgPool(name="gap"),
        _conv(rng, 1, 1, 8, 5, name="head", activation="relu"),
    ]))


def _frames(shape, n=8, seed=3):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(shape)).astype(np.float32)


def _forward(graph, xs):
    with torch.inference_mode():
        return torch_exec.forward(graph, torch.from_numpy(xs),
                                  torch_exec.extract_params(graph)).numpy()


def _forward_quantized(qg, xs):
    with torch.inference_mode():
        return torch_exec.forward_quantized(qg, torch.from_numpy(xs)).numpy()


def _quantized(graph, n=16, per_channel=False):
    return quantize.quantize(graph, _frames(graph.input_shape, n=n, seed=5),
                             method="minmax", per_channel=per_channel,
                             device="cpu")


# ---------------------------------------------------------------- fp32 ----

@pytest.mark.parametrize("name", sorted(NETS))
def test_fp32_c_matches_the_float_forward(name):
    simd = runtime.best_isa()
    width = cgen.ISAS[simd].width if simd in cgen.ISAS else 4
    g = passes.optimize(NETS[name](0), simd_multiple=width)
    net = runtime.build(g, cgen.CodegenOptions(
        simd=simd, unroll=cgen.choose_levels(g, 20_000)))
    assert net.simd == simd and net.nstages == 1
    xs = _frames(g.input_shape, n=4)
    got = net.predict_batch(xs).reshape((4,) + tuple(g.output_shape))
    np.testing.assert_allclose(got, _forward(g, xs), rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(net(xs[0]), got[0].reshape(-1))


# ---------------------------------------------------------------- int8 ----

@pytest.mark.parametrize("simd", ["generic", "sse", "avx", "avx_ubs",
                                  "avx_vnni"])
def test_int8_c_is_the_int8_reference_on_the_zoo_graph(simd):
    g = passes.optimize(_zoo_graph(), simd_multiple=1)
    qg = _quantized(g)
    net = runtime.build_quantized(qg, cgen.CodegenOptions(simd=simd))
    assert net.simd == runtime.resolve_int8_simd(simd)
    xs = _frames(g.input_shape, n=8, seed=9)
    got = net.predict_batch(xs).reshape((8,) + tuple(g.output_shape))
    np.testing.assert_array_equal(got, _forward_quantized(qg, xs))


def test_int8_c_per_channel_is_the_int8_reference():
    g = passes.optimize(_zoo_graph(3), simd_multiple=1)
    qg = _quantized(g, per_channel=True)
    assert qg.channel_acts
    for simd in ("generic", runtime.supported_int8_simds()[0]):
        net = runtime.build_quantized(qg, cgen.CodegenOptions(simd=simd))
        xs = _frames(g.input_shape, n=6, seed=2)
        np.testing.assert_array_equal(
            net.predict_batch(xs).reshape((6,) + tuple(g.output_shape)),
            _forward_quantized(qg, xs))


@pytest.mark.parametrize("name", sorted(NETS))
def test_int8_c_matches_the_int8_reference_on_the_nets(name):
    g = passes.optimize(NETS[name](0), simd_multiple=1)
    qg = _quantized(g, n=8)
    net = runtime.build_quantized(qg, cgen.CodegenOptions(
        simd=runtime.supported_int8_simds()[0]))
    xs = _frames(g.input_shape, n=6, seed=4)
    got = net.predict_batch(xs).reshape((6,) + tuple(g.output_shape))
    want = _forward_quantized(qg, xs)
    if name in SOFTMAX_NETS:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert (got.reshape(6, -1).argmax(-1)
                == want.reshape(6, -1).argmax(-1)).all()
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------- entry points, pipeline ----

@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_entries_threads_and_pipeline_equal_the_batch_loop(precision):
    g = passes.optimize(NETS["residual"](0),
                        simd_multiple=1 if precision == "int8" else 8)
    qg = _quantized(g, n=4) if precision == "int8" else None
    simd = (runtime.supported_int8_simds()[0] if qg is not None
            else runtime.best_isa())
    opts = cgen.CodegenOptions(simd=simd, unroll=None)

    def build(stages):
        sched = make_schedule(g, nstages=stages)
        return (runtime.build_quantized(qg, opts, schedule=sched)
                if qg is not None else runtime.build(g, opts, schedule=sched))

    one, two = build(1), build(2)
    assert (one.nstages, two.nstages) == (1, 2)
    assert one.precision == two.precision == precision
    xs = _frames(g.input_shape, n=7, seed=6)
    want = one.predict_batch(xs)
    np.testing.assert_array_equal(one.predict_batch(xs, threads=2), want)
    np.testing.assert_array_equal(one.predict_batch(xs, threads=3), want)
    ws = one._alloc_workspace()
    assert ws.dtype == (np.int8 if precision == "int8" else np.float32)
    floatp = ctypes.POINTER(ctypes.c_float)
    for i in (0, 6):  # the reentrant entry on a caller's workspace
        out = np.empty(one.out_size, np.float32)
        one._ws_fn(xs[i].ctypes.data_as(floatp), out.ctypes.data_as(floatp),
                   ws.ctypes.data_as(ctypes.POINTER(one._ws_ctype)))
        np.testing.assert_array_equal(out, want[i])
    # the 2-stage build streams the batch through PipelineRunner
    np.testing.assert_array_equal(two.predict_batch(xs), want)
    np.testing.assert_array_equal(two.predict_batch(xs[:1]), want[:1])
    np.testing.assert_array_equal(two.predict_batch(xs, threads=2), want)


# --------------------------------------------------------- .so cache ----

def _unique_source() -> str:
    g = passes.optimize(NETS["ball"](0), simd_multiple=4)
    return codegen.compile(g, cgen.CodegenOptions(
        simd="generic", unroll=None,
        func_name=f"nncg_{uuid.uuid4().hex[:12]}")).source


def test_compile_runs_cc_once_then_hits_the_port_cache():
    src = _unique_source()
    before = dict(runtime.COMPILE_STATS)
    so = runtime.compile_c(src, simd="generic")
    assert runtime.COMPILE_STATS["cc_invocations"] == \
        before["cc_invocations"] + 1
    for _ in range(2):
        assert runtime.compile_c(src, simd="generic") == so
    assert runtime.COMPILE_STATS["cc_invocations"] == \
        before["cc_invocations"] + 1
    assert runtime.COMPILE_STATS["so_cache_hits"] == \
        before["so_cache_hits"] + 2
    cache = Path(runtime._CACHE_DIR)
    assert cache.parts[-2:] == ("nncg_cache", "c_torch")
    assert Path(so).parent == cache
    assert Path(so).parent != Path(jruntime._CACHE_DIR)
    assert Path(so).with_suffix(".c").read_text() == src
    # a new key (another flag) compiles again
    assert runtime.compile_c(src, simd="generic", extra_flags=("-O2",)) != so


def test_two_threads_building_one_source_load_a_whole_so():
    """Both builders compile to temporary names and ``os.replace`` onto
    the cached one, so each loads a complete ``.so`` and no temporary
    file stays behind."""
    g = passes.optimize(NETS["ball"](0), simd_multiple=4)
    opts = cgen.CodegenOptions(simd="generic", unroll=None,
                               func_name=f"nncg_{uuid.uuid4().hex[:12]}")
    start = threading.Barrier(2)
    nets = [None, None]

    def build(i):
        start.wait()
        nets[i] = runtime.build(g, opts)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(n is not None for n in nets)
    assert nets[0].so_path == nets[1].so_path
    xs = _frames(g.input_shape, n=3)
    np.testing.assert_array_equal(nets[0].predict_batch(xs),
                                  nets[1].predict_batch(xs))
    key = Path(nets[0].so_path).stem
    left = sorted(p.name for p in Path(runtime._CACHE_DIR).glob(key + "*"))
    assert left == [key + ".c", key + ".so", key + ".so.meta"], left


def test_a_failed_build_raises_with_the_compiler_stderr():
    with pytest.raises(RuntimeError, match="cc failed") as err:
        runtime.compile_c(f"int broken_{uuid.uuid4().hex} = ;\n",
                          simd="generic")
    assert "error" in str(err.value)


# ---------------------------------------------------- CPU-feature guard ----

FEATURE_SETS = [
    [], ["ssse3"], ["ssse3", "avx2"], ["ssse3", "avx2", "fma"],
    ["ssse3", "avx2", "fma", "avx512bw", "avx512vl"],
    ["ssse3", "avx2", "fma", "avx_vnni"],
    ["ssse3", "avx2", "fma", "avx512bw", "avx512vl", "avx512_vnni"],
    ["asimd", "asimddp"], ["avx512f"]]


@pytest.mark.parametrize("feats", FEATURE_SETS, ids=lambda f: "+".join(f)
                         or "none")
def test_feature_guard_demotes_as_the_reference_does(feats):
    with runtime.force_cpu_features(feats), \
            jruntime.force_cpu_features(feats):
        assert runtime.cpu_features() == frozenset(feats)
        assert runtime.best_isa() == jruntime.best_isa()
        assert runtime.supported_int8_simds() == \
            jruntime.supported_int8_simds()
        for simd in ("generic", "structured", "sse", "avx"):
            assert runtime.resolve_float_simd(simd) == \
                jruntime.resolve_float_simd(simd)
        for simd in [*cgen.QISAS, "generic"]:
            assert runtime.resolve_int8_simd(simd) == \
                jruntime.resolve_int8_simd(simd)
            assert runtime.int8_simd_supported(simd) == \
                jruntime.int8_simd_supported(simd)
    assert runtime.cpu_features() == jruntime.cpu_features()


def test_feature_guard_chains():
    """avx_vnni -> avx -> sse -> generic on x86, neon_dot -> neon ->
    generic on ARM; a demoted build reports what it compiled."""
    chain = ["avx_vnni", "avx_ubs", "avx", "sse", "neon_dot", "neon"]
    with runtime.force_cpu_features(["ssse3"]):
        x86 = runtime._machine_arch() == "x86"
        assert runtime.resolve_int8_simd("avx_vnni") == (
            "sse" if x86 else "generic")
        assert runtime.resolve_float_simd("avx") == "sse"
        g = passes.optimize(_zoo_graph(), simd_multiple=1)
        net = runtime.build_quantized(_quantized(g, n=4),
                                      cgen.CodegenOptions(simd="avx_vnni"))
        assert net.simd == runtime.resolve_int8_simd("avx_vnni")
    with runtime.force_cpu_features([]):
        for simd in chain:
            assert runtime.resolve_int8_simd(simd) == "generic"
        assert runtime.resolve_float_simd("avx") == "structured"
        assert runtime.best_isa() == "structured"
    assert runtime.resolve_int8_simd("avx_vnni") in \
        runtime.supported_int8_simds()


# ------------------------------------------------------------ ANSI C89 ----

def _strict_compile(src: str, tmp_path, tag: str) -> None:
    cc = shutil.which("gcc") or shutil.which("cc")
    assert cc is not None, "no C compiler on this host"
    c_path = tmp_path / f"{tag}.c"
    c_path.write_text(src)
    proc = subprocess.run([cc, *STRICT_FLAGS, "-c", str(c_path), "-o",
                           str(tmp_path / f"{tag}.o")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, f"{tag}:\n{proc.stderr[:4000]}"


@pytest.mark.parametrize("case", ["ball-unrolled", "residual-rolled",
                                  "residual-pipe2", "ball-int8",
                                  "residual-int8-pipe2", "zoo-int8-pc"])
def test_generic_sources_are_strict_c89(case, tmp_path):
    name, _, kind = case.partition("-")
    int8 = "int8" in kind
    graph = _zoo_graph() if name == "zoo" else NETS[name](0)
    g = passes.optimize(graph, simd_multiple=1)
    unit = _quantized(g, n=4, per_channel=kind.endswith("pc")) if int8 else g
    sched = make_schedule(g, nstages=2 if "pipe2" in kind else 1)
    src = codegen.compile(unit, cgen.CodegenOptions(
        simd="generic", unroll=0 if kind == "unrolled" else None),
        schedule=sched).source
    assert "JAX" not in src
    _strict_compile(src, tmp_path, case)
