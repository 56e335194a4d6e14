"""Time the PyTorch port's fp32 flash-attention route on the card at the
LM main path's attention layers.

The layers, checks, timings and bounds are ``chip_smoke.py``'s phase 10
(``flash_main_layers``, ``time_flash_fp32``): gemma3-4b's global and
local layers, deepseek-moe-16b and zamba2-2.7b's shared block, each at
batch 4 x 1536 tokens, q, k and v as the model hands them over ((B,T,H,D)
activations viewed as (B,H,T,D)), random from seed 0.  Each layer's
kernel is held at 2e-5 against its plain version and at 1e-4 against
SDPA in fp32 before it is timed beside both.  It prints one JSON line
per layer and a last one with the times per prefill (a layer's time
times the layers of its arch that run it).

The package timed is the ``repro_torch`` that ``PYTHONPATH`` names
first (``chip_smoke.py`` is this file's tree's), so two trees are
compared within one machine session by running this file once with each
tree's ``src`` (parent, change, change, parent)::

    PYTHONPATH=src python3 tools/time_flash_torch.py --label change

Needs one CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PER_PREFILL = ("ms", "plain_ms", "library_ms", "bound_ms",
               "fp32_fma_bound_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # the tree PYTHONPATH names, imported before chip_smoke.py puts this
    # tree's src first on sys.path
    import repro_torch  # noqa: F401
    from repro_torch.configs.lm_archs import ARCHS
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    per_prefill = {}
    for layer, (arch, (hq, hkv, d), window, n_layers) in (
            chip_smoke.flash_main_layers(ARCHS).items()):
        q, k, v = (torch.from_numpy(rng.normal(size=(
            chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT, h, d)).astype(
                np.float32)).to(dev).transpose(1, 2) for h in (hq, hkv, hkv))
        row = chip_smoke.time_flash_fp32(torch, q, k, v, window)
        print(json.dumps(dict(label=args.label, layer=layer,
                              per_prefill=n_layers, **row)), flush=True)
        totals = per_prefill.setdefault(arch, dict.fromkeys(PER_PREFILL, 0.0))
        for key in PER_PREFILL:
            totals[key] += n_layers * row[key]
        del q, k, v
    print(json.dumps({"label": args.label, "per_prefill": per_prefill}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
