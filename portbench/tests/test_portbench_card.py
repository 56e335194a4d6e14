"""On the card (``-m cuda``; skips elsewhere): one short run of
deepseek-moe-16b-port.chat at the cell's own size, whose check passes, and the
float8 control on the same batches, which fails one of the cell's
limits."""
import time

import pytest

from conftest import ROOT
from portbench.harness.bench import Bench
from portbench.harness.cell import run_cell


@pytest.mark.cuda
def test_cell_passes_and_its_control_fails(card):
    bench = Bench(ROOT)
    cell = bench.cell("deepseek-moe-16b-port.chat")
    out = run_cell(bench, cell, 3000009001, 4.0, False,
                   t_process=time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    n = out["numbers"]
    assert any(n["control_" + k] > v["limit"]
               for k, v in cell["limits"]["compare"].items()), n
