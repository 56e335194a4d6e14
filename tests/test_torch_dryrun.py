"""The port's dry-run (``python -m repro_torch.launch.dryrun``), each cell a
process of its own on the ``fake`` backend's process group, its state on
``meta`` (no allocation).

The cells of ``tests/test_dryrun.py`` on a (2, 4) mesh (h2o-danube-3-4b
``train_4k``, deepseek-moe-16b ``decode_32k``, zamba2-2.7b ``long_500k``,
hubert-xlarge ``prefill_32k``) and gemma3-4b ``train_4k`` with
``--multipod`` on (2, 2, 2), at the cells' widths, batches and sequence
lengths with the depth cut to the prologue and one group of the layer
pattern (``--set n_layers=``): the port traces every layer in Python, so
its time grows with depth, which the JAX package's compiled scan does
not.  The probe runs deepseek-moe-16b ``train_4k`` (one and two layers):
``g2`` costs more than ``g1``.  ``argument_bytes`` is the sum of rank 0's
blocks of the arguments that ``param_specs`` and ``batch_specs`` imply.
"""
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro_torch.configs.lm_archs import ARCHS, SHAPES
from repro_torch.launch.mesh import DEFAULT_AXES
from repro_torch.launch.sharding import (batch_specs, local_shape,
                                         param_specs, spec_leaves)
from repro_torch.launch.specs import batch_shapes
from repro_torch.models.stack import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one_group(arch):
    cfg = ARCHS[arch]
    return len(cfg.prologue) + len(cfg.pattern)


CELLS = {  # name -> (arch, shape, mesh, extra arguments)
    "h2o-danube-3-4b-train_4k": ("h2o-danube-3-4b", "train_4k", "2,4", ()),
    "deepseek-moe-16b-decode_32k": ("deepseek-moe-16b", "decode_32k", "2,4",
                                    ()),
    "zamba2-2.7b-long_500k": ("zamba2-2.7b", "long_500k", "2,4", ()),
    "hubert-xlarge-prefill_32k": ("hubert-xlarge", "prefill_32k", "2,4", ()),
    "multipod": ("gemma3-4b", "train_4k", "2,2,2", ("--multipod",)),
    "probe": ("deepseek-moe-16b", "train_4k", "2,4", ("--probe",)),
}


def _run(name, out):
    arch, shape, mesh, extra = CELLS[name]
    cut = () if "--probe" in extra else (
        "--set", f"n_layers={_one_group(arch)}")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out), *extra, *cut]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    tag = "probe" if "--probe" in extra else (
        "multipod" if "--multipod" in extra else "pod")
    with open(os.path.join(str(out), f"{arch}__{shape}__{tag}.json")) as f:
        d = json.load(f)
    assert d["ok"], d.get("traceback")
    return d


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(_run, name, out) for name in CELLS}
        return {name: f.result() for name, f in futs.items()}


@pytest.mark.parametrize("name", list(CELLS)[:4])
def test_dryrun_cells_debug_mesh(name, cells):
    d = cells[name]
    assert d["mesh"] == [2, 4] and d["axes"] == ["data", "model"]
    full = d["full"]
    assert full["flops"] > 0
    assert full["memory"]["argument_bytes"] > 0
    assert full["memory"]["output_bytes"] > 0
    assert full["trace_s"] >= 0
    for key in ("compile_s", "hlo_bytes", "utilization_ops"):
        assert key not in full
    assert full["collectives"]["total_bytes"] == sum(
        full["collectives"]["bytes_by_kind"].values())


def test_dryrun_multipod_axis(cells):
    d = cells["multipod"]
    assert d["axes"] == ["pod", "data", "model"] and d["multi_pod"]
    assert d["full"]["collectives"]["total_bytes"] > 0
    # the gradients' mean over the data axes: all-reduces over pod and data
    assert d["full"]["collectives"]["count_by_kind"]["all-reduce"] > 0


def test_dryrun_probe_extrapolation(cells):
    d = cells["probe"]
    assert d["g2"]["flops"] > d["g1"]["flops"] > 0


def test_argument_bytes_are_the_local_blocks(cells):
    """hubert-xlarge's prefill: rank 0's blocks of the parameters under
    ``param_specs`` plus its block of the batch under ``batch_specs``."""
    import dataclasses
    arch, shape, _, _ = CELLS["hubert-xlarge-prefill_32k"]
    cfg = dataclasses.replace(ARCHS[arch], n_layers=_one_group(arch))
    axes = DEFAULT_AXES[2]
    mesh = type("Mesh", (), {"axis_names": axes,
                             "shape": dict(zip(axes, (2, 4)))})
    sh = SHAPES[shape]
    batch = batch_shapes(cfg, sh["kind"], sh["global_batch"], sh["seq_len"])
    specs = batch_specs(mesh, cfg, batch)
    params = init_params(cfg, device="meta")
    blocks = [(t, s) for (_, t), s in spec_leaves(
        params, param_specs(mesh, params))]
    blocks += [(t, specs[k]) for k, t in batch.items()]
    want = sum(math.prod(local_shape(mesh, t.shape, s)) * t.element_size()
               for t, s in blocks)
    assert cells["hubert-xlarge-prefill_32k"]["full"]["memory"][
        "argument_bytes"] == want
