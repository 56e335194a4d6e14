"""Time the PyTorch port's LM prefill and decode on the card.

For each ``--arch`` at full width in bf16 (random weights from seed 0,
as ``chip_smoke.py``'s ``lm_main`` draws them), this builds the
``"cuda-lm"`` session under the kernel policy and under the plain one,
warms both up, then runs ``--repeats`` greedy generations of
``chip_smoke.py``'s main traffic (batch 4, prompts of 1536, 16 new
tokens) through each and prints one JSON line per arch: every prefill's
and decode's seconds and tokens/s, and their medians.

The package timed is the ``repro_torch`` that ``PYTHONPATH`` names
first, so two trees are compared within one machine session by running
this file once with each tree's ``src`` (for example parent, change,
change, parent)::

    PYTHONPATH=src python3 tools/time_lm_torch.py --label change \\
        --arch gemma3-4b --arch rwkv6-7b

Needs one CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BATCH, PROMPT, CONTEXT, NEW = 4, 1536, 2048, 16


def timed_generate(torch, np, sess, prompts, max_new):
    """Seconds of the prefill and of the ``max_new - 1`` decode steps
    (each ends on the host), as ``chip_smoke.py`` times them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, handle = sess.prefill(prompts)
    t1 = time.perf_counter()
    tok = np.argmax(logits, axis=-1).astype(np.int32)
    for _ in range(max_new - 1):
        tok = np.argmax(sess.decode(handle, tok), axis=-1).astype(np.int32)
    return t1 - t0, time.perf_counter() - t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.engine import LMConfig, LMSession, SessionConfig
    from repro_torch.models.stack import init_params

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    pins = {"kernels": {}, "plain": dict(attn_variant="reference",
                                         scan_variant="chunked")}
    for arch in args.arch:
        cfg = ARCHS[arch]
        params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        sessions = {name: LMSession(config=SessionConfig(
            backend="cuda-lm", lm=LMConfig(
                arch=arch, smoke=False, max_context=CONTEXT,
                decode_batch=BATCH, **p)),
            params=params) for name, p in pins.items()}
        prompts = np.random.default_rng(21).integers(
            0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(np.int32)
        for sess in sessions.values():
            sess.generate(prompts[:, :128], 2)
        runs = {name: [] for name in sessions}
        for _ in range(args.repeats):
            for name, sess in sessions.items():
                runs[name].append(timed_generate(torch, np, sess, prompts,
                                                 NEW))
        out = {"label": args.label, "arch": arch, "torch": torch.__version__,
               "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW}
        for name, rs in runs.items():
            pre = [r[0] for r in rs]
            dec = [r[1] for r in rs]
            out[name] = dict(
                prefill_s=pre, decode_s=dec,
                prefill_tok_s_median=BATCH * PROMPT / statistics.median(pre),
                decode_tok_s=[BATCH * (NEW - 1) / d for d in dec],
                decode_tok_s_median=BATCH * (NEW - 1) / statistics.median(
                    dec))
        print(json.dumps(out), flush=True)
        del sessions, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
