"""The port's code-generator tools (``tools/*_torch.py``) against the JAX
package's (``tools/dump_ir.py``, ``strict_c89.py``, ``cross_check.py``).

Both sets are loaded by file path.  Float text must equal the
reference tool's byte for byte but for the banner's first line of
rendered C (``NNCG-JAX`` there, ``NNCG (PyTorch port; ...)`` here).  The
port calibrates int8 on its own, and its qparams differ from the
reference's on some nets by float summation order, so int8 text is held
to the reference's through the reference's quantized graph carried
across with ``from_reference_qgraph``.  The port's own calibrated builds
are held by what the tools gate on: the strict C89 compile, and the
host's ``generic`` lane of ``cross_check_torch`` run bit for bit
against ``forward_quantized`` on the CPU.
"""
import contextlib
import functools
import importlib.util
import io
import platform
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import cgen as jcgen
from repro.core import codegen as jcodegen
from repro.core import passes as jpasses
from repro.core import quantize as jq
from repro.data.pipeline import camera_frame_batch
from repro_torch.core import passes as tpasses
from repro_torch.core.quantize import from_reference_qgraph
from repro_torch.core.schedule import make_schedule

ROOT = Path(__file__).resolve().parents[1]
REF_BANNER = "/* Generated by NNCG-JAX (repro of Urbann et al., 2020)"
PORT_BANNER = "/* Generated by NNCG (PyTorch port; repro of Urbann et al., 2020)"
NETS = ("ball", "pedestrian", "robot", "residual")
CC = shutil.which("gcc") or shutil.which("cc")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_DUMP, PORT_DUMP = _load("dump_ir"), _load("dump_ir_torch")
REF_STRICT, PORT_STRICT = _load("strict_c89"), _load("strict_c89_torch")
REF_CROSS, PORT_CROSS = _load("cross_check"), _load("cross_check_torch")


def _first_diff(ref: str, port: str) -> str:
    for i, (a, b) in enumerate(zip(ref.splitlines(), port.splitlines())):
        if a != b:
            return f"line {i + 1}:\n  ref:  {a[:200]}\n  port: {b[:200]}"
    return f"lengths {len(ref)} and {len(port)}"


def _assert_same_text(ref: str, port: str) -> None:
    """Equal but for the banner: where the reference's text holds its
    banner, the port's holds its own at the same offset."""
    if REF_BANNER in ref:
        i = ref.index(REF_BANNER)
        assert port.startswith(PORT_BANNER, i), port[i:i + 80]
        rest = port[i + len(PORT_BANNER):]
        assert "JAX" not in port[:i] + rest and "jax" not in rest
        port = port[:i] + REF_BANNER + rest
    assert port == ref, _first_diff(ref, port)


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


# ------------------------------------------------------------ dump_ir ----

DUMP_CASES = [[net, *mode, *fusion] for net in NETS
              for mode in ([], ["--bodies"], ["--c"])
              for fusion in ([], ["--no-fusion"])] + [
    ["ball", "--simd", "sse", "--stages", "2", *mode]
    for mode in ([], ["--bodies"], ["--c"])]


@pytest.mark.parametrize("argv", DUMP_CASES, ids=" ".join)
def test_dump_ir_float_is_the_reference_text(argv):
    _assert_same_text(_stdout(REF_DUMP.main, argv),
                      _stdout(PORT_DUMP.main, argv))


@functools.lru_cache(maxsize=None)
def _dump_qgraph(net: str, per_channel: bool):
    """The quantized graph ``dump_ir.py --int8`` lowers: percentile on
    16 camera frames of seed 0."""
    g = jpasses.optimize(REF_DUMP.NETS[net]())
    calib = camera_frame_batch(16, g.input_shape, seed=0)
    return jq.quantize(g, np.asarray(calib), method="percentile",
                       per_channel=per_channel)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("net", NETS)
def test_dump_ir_int8_is_the_reference_text(net, per_channel):
    """The reference's text against the port's ``dump`` of the carried
    quantized graph, as IR and as C; then the port's CLI with its own
    calibration on the CPU lowers as many nests."""
    flags = ["--int8"] + (["--per-channel"] if per_channel else [])
    pqg = from_reference_qgraph(_dump_qgraph(net, per_channel))
    sched = make_schedule(tpasses.optimize(PORT_DUMP.NETS[net]()))
    ref_ir = _stdout(REF_DUMP.main, [net, *flags])
    _assert_same_text(ref_ir, PORT_DUMP.dump(pqg, sched))
    _assert_same_text(_stdout(REF_DUMP.main, [net, *flags, "--c"]),
                      PORT_DUMP.dump(pqg, sched, c=True))
    own = _stdout(PORT_DUMP.main, [net, *flags, "--device", "cpu"])
    nests = own.count("\n  nest ")
    assert nests == ref_ir.count("\n  nest ") > 0
    assert own.splitlines()[1].startswith("Program nncg_net [int8]")


def test_dump_ir_int8_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PORT_DUMP.main(["ball", "--int8"])


# --------------------------------------------------------- strict_c89 ----

def test_strict_c89_cases_are_the_reference_cases():
    assert PORT_STRICT.STRICT_FLAGS == REF_STRICT.STRICT_FLAGS
    assert PORT_CROSS.STRICT_FLAGS == REF_CROSS.STRICT_FLAGS
    assert [(c[0], c[1].__name__, *c[2:]) for c in PORT_STRICT.CASES] == \
        [(c[0], c[1].__name__, *c[2:]) for c in REF_STRICT.CASES]
    ref, port = REF_STRICT.pool_concat_dag(), PORT_STRICT.pool_concat_dag()
    _assert_same_layers(ref, port)


def _assert_same_layers(ref, port) -> None:
    assert [type(l).__name__ for l in port.layers] == \
        [type(l).__name__ for l in ref.layers]
    for rl, pl in zip(ref.layers, port.layers):
        assert (pl.name, list(pl.inputs)) == (rl.name, list(rl.inputs))
        for f in ("weights", "bias"):
            if hasattr(rl, f):
                assert np.array_equal(getattr(pl, f), getattr(rl, f)), \
                    (rl.name, f)


@functools.lru_cache(maxsize=None)
def _strict_qgraph(tag: str):
    """The reference tool's quantized graph of an int8 case."""
    _, builder, _, method, _, _ = REF_STRICT.CASES[_case_index(tag)]
    g = jpasses.optimize(builder(), simd_multiple=1)
    method, _, pc = method.partition(":")
    xs = np.random.default_rng(0).normal(
        size=(8,) + tuple(g.input_shape)).astype(np.float32)
    return jq.quantize(g, xs, method=method, per_channel=pc == "pc")


def _case_index(tag: str) -> int:
    return [c[0] for c in REF_STRICT.CASES].index(tag)


@pytest.mark.parametrize("tag", [c[0] for c in REF_STRICT.CASES])
def test_strict_c89_case_compiles_and_is_the_reference_source(tag,
                                                              tmp_path):
    """The port tool's own build of the case compiles under the strict
    flags with this host's compiler; its source equals the reference
    tool's (int8: on the reference's quantized graph, carried)."""
    _, builder, unroll, method, nstages, fusion = \
        PORT_STRICT.CASES[_case_index(tag)]
    pg = PORT_STRICT.case_graph(tag, builder)
    own = PORT_STRICT.compile_unit(
        PORT_STRICT.case_unit(pg, method, "cpu"), unroll, nstages, fusion)
    assert CC is not None, "no C compiler on this host"
    proc = PORT_STRICT.strict_compile(CC, own, tag, str(tmp_path))
    assert proc.returncode == 0, proc.stderr[:4000]

    ref_builder = REF_STRICT.CASES[_case_index(tag)][1]
    jg = jpasses.optimize(ref_builder(), simd_multiple=1)
    ref = REF_STRICT._compile_unit(jg, unroll, method, nstages, fusion)
    unit = pg if method is None else from_reference_qgraph(
        _strict_qgraph(tag))
    if method is not None and method.endswith(":pc"):
        assert unit.channel_acts
    _assert_same_text(ref, PORT_STRICT.compile_unit(unit, unroll, nstages,
                                                    fusion))


def test_strict_c89_cli_passes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "tools/strict_c89_torch.py", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert [ln.split(":")[1].strip() for ln in lines] == \
        [c[0] for c in REF_STRICT.CASES]
    assert all(": OK (" in ln for ln in lines)


def test_strict_c89_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PORT_STRICT.main([])


# -------------------------------------------------------- cross_check ----

CROSS_NETS = ("zoo", "camera", "poolcat")
REF_CROSS_NETS = {"zoo": REF_CROSS._kernel_zoo,
                  "camera": REF_CROSS._camera_conv_net,
                  "poolcat": REF_CROSS._pool_concat_net}


def test_cross_check_nets_are_the_reference_nets():
    assert PORT_CROSS.ARM_VARIANTS == REF_CROSS.ARM_VARIANTS
    assert PORT_CROSS._HARNESS == REF_CROSS._HARNESS
    port = PORT_CROSS.nets()
    assert tuple(port) == CROSS_NETS
    for name in CROSS_NETS:
        _assert_same_layers(REF_CROSS_NETS[name](), port[name])


@functools.lru_cache(maxsize=None)
def _cross_qgraph(name: str):
    """The reference tool's quantized graph and frames of one net."""
    g = jpasses.optimize(REF_CROSS_NETS[name](), simd_multiple=1)
    xs = np.random.default_rng(3).normal(
        size=(8,) + tuple(g.input_shape)).astype(np.float32)
    return jq.quantize(g, xs, per_channel=name == "poolcat"), xs


@pytest.mark.parametrize("simd", REF_CROSS.ARM_VARIANTS)
@pytest.mark.parametrize("name", CROSS_NETS)
def test_cross_check_source_is_the_reference_source(name, simd):
    """Source plus harness, as the reference tool writes it for the
    cross compiler, on the carried quantized graph."""
    jqg, xs = _cross_qgraph(name)
    _, _, own_xs = PORT_CROSS.prepare(name, PORT_CROSS.nets()[name])
    assert np.array_equal(own_xs, xs)
    in_n = int(np.prod(jqg.graph.input_shape))
    out_n = int(np.prod(jqg.graph.shape_map()[jqg.graph.sink.name]))
    opts = jcgen.CodegenOptions(simd=simd)
    ref = jcodegen.compile(jqg, opts).source + REF_CROSS._HARNESS.format(
        in_n=in_n, out_n=out_n, func=opts.func_name)
    _assert_same_text(ref, PORT_CROSS.harnessed_source(
        from_reference_qgraph(jqg), simd, in_n, out_n))


@pytest.mark.parametrize("name", CROSS_NETS)
def test_cross_check_host_lane_is_bit_exact(name, tmp_path):
    """The ``generic`` lane natively: this host's compiler, no emulator,
    the port's own quantized graph, ``forward_quantized`` on the CPU."""
    assert CC is not None, "no C compiler on this host"
    _, qg, xs = PORT_CROSS.prepare(name, PORT_CROSS.nets()[name])
    results = PORT_CROSS.check_net(name, qg, xs, cc=CC, run=[],
                                   variants=["generic"], tmp=str(tmp_path),
                                   link=(), arch=platform.machine())
    assert [tag for tag, _, _ in results] == [
        f"{name}/generic", f"{name}/strict-c89({platform.machine()})"]
    assert all(ok for _, ok, _ in results), results
    assert "BIT-EXACT (8 images" in results[0][2]


def test_cross_check_reports_a_missing_toolchain(capsys, tmp_path):
    missing = str(tmp_path / "aarch64-linux-gnu-gcc")
    assert PORT_CROSS.main(["--cc", missing]) == 2
    err = capsys.readouterr().err
    assert "cross_check: toolchain missing (cc=None" in err
