"""The port's C code generator against the JAX package's: the same graph
gives the same C, byte for byte.

The reference graph is optimized by the reference's passes at the ISA's
width; the port's graph is ``from_reference_graph`` of the raw graph,
optimized by the port's passes.  Both go through ``codegen.compile``
with the same options and the same schedule, and the sources must be
equal but for the banner's first line, which names the generator
(``NNCG-JAX`` there, ``NNCG (PyTorch port; ...)`` here).  Beside the
source, every plan figure of ``GeneratedSource`` (workspace, arena and
live bytes, entry symbols) and the schedule's digest must be equal.

fp32: the four nets x simd ``generic`` / ``structured`` / ``sse`` /
``avx`` x unroll 0 / ``choose_levels`` x fusion on / off x 1 or 2
stages.  int8: the reference's ``QuantizedGraph`` of each net carried
across by ``from_reference_qgraph``, x every ``QISAS`` key plus
``generic`` x per-channel off / on x the fusion-kind subsets the int8
autotuner times (all, Adds only, none).  Generation needs no host
support for the ISA, so every case runs on any host.
"""
import functools

import numpy as np
import pytest

from repro.configs import cnn_paper as jnets
from repro.core import cgen as jcgen
from repro.core import codegen as jcodegen
from repro.core import passes as jpasses
from repro.core import quantize as jq
from repro.core import schedule as jschedule
from repro_torch.core import cgen as tcgen
from repro_torch.core import codegen as tcodegen
from repro_torch.core import passes as tpasses
from repro_torch.core import schedule as tschedule
from repro_torch.core.graph import from_reference_graph
from repro_torch.core.quantize import from_reference_qgraph

NETS = ("ball", "pedestrian", "robot", "residual")
JAX_NETS = {**jnets.PAPER_CNNS, **jnets.EXTRA_CNNS}
REF_BANNER = "/* Generated by NNCG-JAX (repro of Urbann et al., 2020)"
PORT_BANNER = "/* Generated by NNCG (PyTorch port; repro of Urbann et al., 2020)"
FUSION_KINDS = {"all": ("add", "pool", "concat"), "adds": ("add",),
                "none": ()}
PLAN_FIELDS = ("func_name", "precision", "simd", "codegen_version", "entry",
               "entry_ws", "entry_batch", "entry_batch_ws", "entry_pipeline",
               "stage_entries", "workspace_elems", "elem_bytes",
               "arena_elems", "iface_elems", "in_elems", "out_elems",
               "arena_bytes", "arena_buffer_sum_bytes", "peak_live_bytes",
               "per_layer_live_bytes")


@functools.lru_cache(maxsize=None)
def _graphs(name: str, width: int):
    """(reference graph, port graph), each optimized by its own passes."""
    raw = JAX_NETS[name](0)
    return (jpasses.optimize(raw, simd_multiple=width),
            tpasses.optimize(from_reference_graph(raw), simd_multiple=width))


@functools.lru_cache(maxsize=None)
def _qgraphs(name: str, per_channel: bool):
    """(reference qgraph, the port's carried copy), calibrated by the
    reference on 8 camera-like frames."""
    from repro.data.pipeline import camera_frame_batch
    jg, _ = _graphs(name, 1)
    cal = camera_frame_batch(8, tuple(jg.input_shape), seed=0)
    jqg = jq.quantize(jg, cal, per_channel=per_channel)
    return jqg, from_reference_qgraph(jqg)


def _assert_same(ref, port) -> None:
    """Equal sources but for the banner's first line, equal plans and
    schedule digests."""
    ref_head, ref_rest = ref.source.split("\n", 1)
    port_head, port_rest = port.source.split("\n", 1)
    assert ref_head.startswith(REF_BANNER), ref_head
    assert port_head == PORT_BANNER + ref_head[len(REF_BANNER):]
    assert "JAX" not in port.source and "jax" not in port.source
    assert port_rest == ref_rest
    for f in PLAN_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.schedule.digest() == ref.schedule.digest()
    assert port.schedule.describe() == ref.schedule.describe()


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("unroll", ["levels", 0])
@pytest.mark.parametrize("simd", ["generic", "structured", "sse", "avx"])
@pytest.mark.parametrize("name", NETS)
def test_fp32_source_is_the_reference_source(name, simd, unroll, fusion,
                                             stages):
    width = jcgen.ISAS[simd].width if simd in jcgen.ISAS else 4
    jg, pg = _graphs(name, width)
    if unroll == "levels":
        levels = jcgen.choose_levels(jg, 20_000)
        assert tcgen.choose_levels(pg, 20_000) == levels
    else:
        levels = unroll
    jsched = jschedule.make_schedule(jg, nstages=stages, fusion=fusion)
    psched = tschedule.make_schedule(pg, nstages=stages, fusion=fusion)
    ref = jcodegen.compile(jg, jcgen.CodegenOptions(simd=simd, unroll=levels),
                           schedule=jsched)
    port = tcodegen.compile(pg, tcgen.CodegenOptions(simd=simd,
                                                     unroll=levels),
                            schedule=psched)
    _assert_same(ref, port)
    assert port.nstages == stages


@pytest.mark.parametrize("kinds", sorted(FUSION_KINDS))
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("simd", sorted(jcgen.QISAS) + ["generic"])
@pytest.mark.parametrize("name", NETS)
def test_int8_source_is_the_reference_source(name, simd, per_channel, kinds):
    assert sorted(tcgen.QISAS) == sorted(jcgen.QISAS)
    jqg, pqg = _qgraphs(name, per_channel)
    k = FUSION_KINDS[kinds]
    jsched = jschedule.make_schedule(jqg.graph, nstages=1, fusion=bool(k),
                                     kinds=k or ("add",))
    psched = tschedule.make_schedule(pqg.graph, nstages=1, fusion=bool(k),
                                     kinds=k or ("add",))
    ref = jcodegen.compile(jqg, jcgen.CodegenOptions(simd=simd),
                           schedule=jsched)
    port = tcodegen.compile(pqg, tcodegen.CodegenOptions(simd=simd),
                            schedule=psched)
    _assert_same(ref, port)
    assert port.precision == "int8"


@pytest.mark.parametrize("name", NETS)
def test_static_choices_are_the_reference_choices(name):
    """The static heuristics the session and autotuner start from: the
    unroll levels at several budgets, every layer's variant list, the
    term estimates, the fusion candidates' digests and the int8
    ``vpmaddubsw`` eligibility."""
    jg, pg = _graphs(name, 8)
    for budget in (2_000, 20_000, 200_000):
        assert tcgen.choose_levels(pg, budget) == jcgen.choose_levels(
            jg, budget)
    jmap, pmap = jg.shape_map(), pg.shape_map()
    for jl, pl in zip(jg.layers, pg.layers):
        jin = jmap[jl.inputs[0]] if jl.inputs else None
        pin = pmap[pl.inputs[0]] if pl.inputs else None
        assert tcgen.enumerate_variants(pl, pin) == \
            jcgen.enumerate_variants(jl, jin)
        for level in (0, 1, 2, None):
            assert tcgen.estimate_terms(pl, pin, level) == \
                jcgen.estimate_terms(jl, jin, level)
    for stages in (1, 2, 3):
        for k in FUSION_KINDS.values():
            js = jschedule.make_schedule(jg, nstages=stages, fusion=bool(k),
                                         kinds=k or ("add",))
            ps = tschedule.make_schedule(pg, nstages=stages, fusion=bool(k),
                                         kinds=k or ("add",))
            assert ps.digest() == js.digest()
    jqg, pqg = _qgraphs(name, False)
    assert tcgen.maddubsw_any_eligible(pqg) == \
        jcgen.maddubsw_any_eligible(jqg)


def test_generated_values_are_the_reference_values():
    """``FUSION_KINDS``, ``CODEGEN_VERSION``, the term budget and every
    ISA descriptor are the reference's; ``flit`` prints what the
    reference prints."""
    from repro.core import numerics as jnum
    from repro_torch.core import numerics as tnum
    assert tcgen.CODEGEN_VERSION == jcgen.CODEGEN_VERSION == 8
    assert tcgen.TERM_BUDGET_DEFAULT == jcgen.TERM_BUDGET_DEFAULT
    assert tschedule.FUSION_KINDS == jschedule.FUSION_KINDS
    for name, isa in jcgen.ISAS.items():
        assert tcgen.ISAS[name].__dict__ == isa.__dict__
    for name, isa in jcgen.QISAS.items():
        assert tcgen.QISAS[name].__dict__ == isa.__dict__
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(size=200).astype(np.float32),
        np.float32([0.0, -0.0, 1e-45, 3.4028235e38, 1.17549435e-38, 0.1])])
    for v in vals:
        assert tnum.flit(v) == jnum.flit(v)
