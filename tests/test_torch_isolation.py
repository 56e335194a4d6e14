"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``, and no ``except``
in the port falls back from a kernel to its plain version."""
import ast
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax|from\s+jax)\b|\brepro\.", re.M)


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.core.torch_exec" in mods
    assert "repro_torch.serve.server" in mods
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'chip_smoke', 'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "assert callable(smoke.main)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'repro'\n"
        "             or k.startswith(('jax.', 'repro.')))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_fails_without_a_card():
    """No card, no result: a non-zero exit and no ``ok`` line."""
    out = subprocess.run(
        [sys.executable, "-c", "import runpy, torch\n"
         "torch.cuda.is_available = lambda: False\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "is_available() is false" in out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), *PORT.rglob("*.cuh"),
     *ROOT.glob("examples/*_torch.py"), ROOT / "tools" / "time_lm_torch.py",
     ROOT / "chip_smoke.py"]))
def test_no_source_names_jax_or_repro(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0) for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def _handlers(path):
    tree = ast.parse(path.read_text())
    return ([n for n in ast.walk(tree) if isinstance(n, ast.Try)],
            [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)])


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_no_except_falls_back_to_the_plain_path(path):
    """The kernel layers and executors hold no ``try`` at all; elsewhere
    no handler names a plain version, an executor or the CPU."""
    tries, handlers = _handlers(ROOT / path)
    if "/kernels/" in path or "/core/" in path:
        assert not tries, f"{path}: try at line {tries[0].lineno}"
    for h in handlers:
        names = {n.id for n in ast.walk(h) if isinstance(n, ast.Name)} | {
            n.attr for n in ast.walk(h) if isinstance(n, ast.Attribute)}
        text = ast.unparse(h)
        assert not {"ref", "conv2d_ref", "maxpool2d_ref", "forward",
                    "forward_kernels", "predict_batch"} & names, text
        assert "cpu" not in text, text
