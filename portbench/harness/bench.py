"""Discovery by name.  ``BENCHMARK.json`` names a cell's configuration,
traffic and metrics; everything else is found in files of their own:

* ``portbench/configs/<config>.json`` — the configuration (its
  ``family`` names the reference, ``portbench/reference/<family>.py``);
* ``portbench/mixes/<traffic>.json`` — the traffic mix;
* ``portbench/limits/<cell>.json`` — the limits of the cell's check;
* ``portbench/metrics/<metric>.py`` — a metric's reader, ``read(run)``,
  found by the metric's whole name, or else by its name with trailing
  ``.<part>`` suffixes taken off (``mfu.chat`` -> ``mfu.py``); a reader
  may keep data beside it in ``portbench/metrics/<reader>/``.
"""
from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def use_checkout_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache the process might write, at fixed
    paths inside the checkout (the program builds its kernel library
    under ``build/repro_torch_kernels`` already)."""
    build = Path(root) / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.pkg = self.root / "portbench"

    def cell(self, name: str) -> dict:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        entry = configs[w["config"]]
        return dict(
            name=name, chips=w["chips"], entry=entry,
            config=load_json(self.root / entry["file"]),
            mix=load_json(self.pkg / "mixes" / f"{w['traffic']}.json"),
            limits=load_json(self.pkg / "limits" / f"{name}.json"),
            end_to_end=self.metrics("end_to_end", name),
            per_layer=self.metrics("per_layer", name))

    def metrics(self, section: str, cell: str) -> list:
        """The metrics of ``section`` that the cell reports: those that
        list it, and those with no list whose moved metric it reports."""
        e2e = {m["name"] for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]}
        out = []
        for m in self.spec[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric: str):
        """The ``read`` function of the metric's reader module."""
        parts = metric.split(".")
        for n in range(len(parts), 0, -1):
            path = self.pkg / "metrics" / (".".join(parts[:n]) + ".py")
            if path.exists():
                spec = importlib.util.spec_from_file_location(
                    "portbench_metric_" + path.stem.replace(".", "_"), path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for metric {metric!r} under "
                                f"{self.pkg / 'metrics'}")

    def reader_data(self, reader: str) -> Path:
        return self.pkg / "metrics" / reader
