"""The benchmark's tests run on the CPU (the card tests skip there):
``python -m pytest -q portbench/tests`` from the repository's root."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """Skips where there is no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def smoke_cell(name: str, **mix):
    """``name``'s cell with a tiny mix for a run at the ``.smoke()`` size
    on the CPU: two clients, 16-token prompts, 4 new tokens."""
    from portbench.harness.bench import Bench
    cell = Bench(ROOT).cell(name)
    small = dict(clients=2, prompt_tokens=16, max_new=4, check_batches=2)
    small.update(mix)
    cell["mix"] = dict(cell["mix"], **small, server=dict(
        cell["mix"]["server"], max_batch=small["clients"]))
    cell["limits"] = dict(cell["limits"], min_tokens_checked=1)
    return cell
