"""The port's serving examples run to their end on the CPU: each as its
own process with ``--device cpu``, under a timeout of 120 s, exit 0 and
its closing OK line, with neither JAX nor the JAX package imported."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
RUN = (
    "import runpy, sys\n"
    "sys.argv = [sys.argv[1], '--device', 'cpu']\n"
    "try:\n"
    "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    assert not e.code, e.code\n"
    "bad = sorted(k for k in sys.modules if k in ('jax', 'repro')\n"
    "             or k.startswith(('jax.', 'repro.')))\n"
    "assert not bad, bad\n")


@pytest.mark.parametrize("name", ["serve_lm_torch", "serve_cnn_torch"])
def test_example_runs_on_the_cpu(name):
    out = subprocess.run(
        [sys.executable, "-c", RUN, str(ROOT / "examples" / f"{name}.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.rstrip().endswith(f"{name}: OK"), out.stdout[-2000:]
