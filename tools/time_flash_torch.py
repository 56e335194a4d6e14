"""Time the PyTorch port's flash-attention routes, fp32 and bf16, on the
card at the LM main path's attention layers.

The layers, checks, timings and bounds are ``chip_smoke.py``'s phase 10
(``flash_main_layers``, ``time_flash_fp32``): gemma3-4b's global and
local layers, deepseek-moe-16b and zamba2-2.7b's shared block, each at
batch 4 x 1536 tokens, q, k and v as the model hands them over ((B,T,H,D)
activations viewed as (B,H,T,D)), random from seed 0.  Each layer's
kernel is held at 2e-5 against its plain version and at 1e-4 against
SDPA in fp32 before it is timed beside both; then the bf16 route on the
same inputs rounded to bf16, held at 3e-2 against its plain version and
timed beside SDPA in bf16.  It prints one JSON line per layer and route
and a last one with the times per prefill (a layer's time times the
layers of its arch that run it) of each route.

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
    per_prefill = {"float32": {}, "bfloat16": {}}
    for layer, (arch, (hq, hkv, d), window, n_layers) in (
            chip_smoke.flash_main_layers(ARCHS).items()):
        q, k, v = (torch.from_numpy(rng.normal(size=(
            chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT, h, d)).astype(
                np.float32)).to(dev).transpose(1, 2) for h in (hq, hkv, hkv))
        rows = {"float32": chip_smoke.time_flash_fp32(torch, q, k, v, window),
                "bfloat16": time_flash_bf16(torch, chip_smoke, *(
                    a.to(torch.bfloat16) for a in (q, k, v)), window)}
        for dtype, row in rows.items():
            print(json.dumps(dict(label=args.label, layer=layer,
                                  per_prefill=n_layers, **row)), flush=True)
            totals = per_prefill[dtype].setdefault(
                arch, {key: 0.0 for key in PER_PREFILL if key in row})
            for key in totals:
                totals[key] += n_layers * row[key]
        del q, k, v
    print(json.dumps({"label": args.label, "per_prefill": per_prefill}),
          flush=True)
    return 0


def time_flash_bf16(torch, chip_smoke, q, k, v, window) -> dict:
    """The bf16 route at one causal layer, q, k and v bf16 (B,H,T,D)
    views: held at 3e-2 against its plain version, then ``graph_ms`` of
    the kernel, the plain version and SDPA in bf16, and the bound of its
    operations at the bf16 tensor-core rate."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.ref import attention_ref
    b, hq, t, d = q.shape
    qi = torch.arange(t, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = (kj <= qi) & ((qi - kj) < (window or t))

    def kernel():
        return flash_mod.flash_attention_cuda(q, k, v, window=window)

    def library():
        if window is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    o = kernel()
    err = chip_smoke.compare(o, attention_ref(q, k, v, window=window), 3e-2,
                             3e-2, f"bf16 flash_attention {tuple(q.shape)} "
                                   f"window {window}")
    ops = 4 * b * hq * d * int(mask.sum())
    row = dict(q=list(q.shape), k=list(k.shape), dtype="bfloat16",
               window=window, max_abs_err=err,
               ms=chip_smoke.graph_ms(torch, kernel),
               plain_ms=chip_smoke.graph_ms(
                   torch, lambda: attention_ref(q, k, v, window=window),
                   reps=3),
               library_ms=chip_smoke.graph_ms(torch, library))
    row["bound_ms"] = chip_smoke.bound(chip_smoke.nbytes(q, k, v, o), ops,
                                       chip_smoke.BF16_OPS_PER_S)[0]
    return row


if __name__ == "__main__":
    sys.exit(main())
