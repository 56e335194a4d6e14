"""``BENCHMARK.json`` and the files the harness finds by name."""
import dataclasses
import json
import re

import pytest

from conftest import ROOT
from portbench.harness.bench import Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[sec]:
            assert NAME.match(e["name"]), e["name"]
    configs = {c["name"] for c in SPEC["configs"]}
    assert {w["config"] for w in SPEC["workloads"]} == configs
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    bench = Bench(ROOT)
    c = bench.cell(cell)
    assert c["config"]["as_run"]["name"] == c["entry"]["name"]
    assert c["mix"]["clients"] == c["mix"]["server"]["max_batch"]
    assert c["mix"]["server"]["request_timeout_ms"] is None
    assert c["limits"]["compare"]
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:  # each moves a metric the cell reports
        assert m["moves"] in e2e
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_reader_found_by_name_without_its_suffix():
    bench = Bench(ROOT)
    assert bench.reader("mfu.chat").__module__.endswith("mfu")
    assert bench.reader("model.prefill_ms.chat").__module__.endswith(
        "model_prefill_ms")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.chat")


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configuration_is_served_as_its_file_states(config):
    """The file's ``as_run`` group is what the program serves: its ARCHS
    entry with those fields, registered under the configuration's name;
    ``reduced`` is the file's own, and no MoE call drops a slot."""
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.models.moe import capacity
    from portbench.harness.cell import program_config
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    conf = json.loads((ROOT / entry["file"]).read_text())
    archs = dict(ARCHS)
    cfg = program_config(conf, archs)
    assert archs[config] is cfg and config not in ARCHS
    got = dataclasses.asdict(cfg)
    assert {k: got[k] for k in conf["as_run"]} == conf["as_run"]
    assert conf["reduced"] == entry["reduced"]
    assert set(conf["reduced"]) <= set(conf["departures"])
    assert conf["family"] == got["family"]
    assert (ROOT / "portbench" / "reference" / f"{conf['family']}.py").exists()
    if cfg.n_experts:
        for s in (1, 16, 64, 4096, 16384, 20480):
            assert capacity(s, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor) >= s
