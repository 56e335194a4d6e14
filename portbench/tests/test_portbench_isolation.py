"""Nothing the benchmark runs loads JAX or the JAX package (``repro``);
the reference loads nothing of the program either.  Module names are
compared by their whole top-level name: ``repro_torch`` is not
``repro``."""
import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

PKG = ROOT / "portbench"
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    names = set(_imports(ROOT / path))
    assert not names & NEVER, (path, names & NEVER)
    if path.startswith("portbench/reference/"):
        assert "repro_torch" not in names, path


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib',"
         " 'flax', 'repro', 'repro_torch'})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_neither_jax_nor_the_program():
    assert _loaded("import portbench.reference.common, "
                   "portbench.reference.moe") == []


def test_a_run_loads_no_jax():
    code = ("import sys, time\nsys.path.insert(0, 'portbench/tests')\n"
            "from conftest import smoke_cell\n"
            "from portbench.harness.bench import Bench\n"
            "from portbench.harness.cell import run_cell, forbidden_modules\n"
            "out = run_cell(Bench(), smoke_cell('deepseek-moe-16b-port.chat'), "
            "7, 1.0, False, t_process=time.perf_counter(), device='cpu', "
            "smoke=True, log=lambda *a, **k: None)\n"
            "assert out['correct'] and forbidden_modules() == []")
    assert _loaded(code) == ["repro_torch"]


def _bench(cwd, prelude=""):
    code = (prelude + "import runpy, sys\nsys.argv = ['portbench/run.py', "
            "'--workload', 'deepseek-moe-16b-port.chat', '--seed', '3000000001', "
            "'--seconds', '1']\nrunpy.run_path('portbench/run.py', "
            "run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _bench(ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "is_available() is false" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: no program,
    so no result, even where a card is reported."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(tmp_path, "import torch\n"
                 "torch.cuda.is_available = lambda: True\n"
                 "torch.cuda.device_count = lambda: 1\n")
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "src/repro_torch" in out.stderr
