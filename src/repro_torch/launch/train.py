"""End-to-end training (the port of the JAX package's
``launch/train.py``, deliverable (b): the ~100M-parameter run).

One device, the card unless ``--device`` names another: deterministic
data, AdamW with a warmup + cosine schedule, atomic checkpoints and
resume from the newest one.  ``--preempt-at N`` exits with code 17 after
N steps, to exercise the resume path; a resumed run consumes exactly the
stream the uninterrupted run would have, so it ends in the same state.
The parameters are drawn on the CPU from ``--seed`` and then moved, so
every device starts from the same weights.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..checkpoint.checkpoint import latest_step, restore, save
from ..configs.lm_archs import ARCHS
from ..core.torch_exec import resolve_device
from ..core.tree import leaves, tree_map
from ..data.pipeline import Prefetcher, TokenStreamConfig, token_stream
from ..models import make_train_step
from ..models.config import ModelConfig
from ..models.stack import init_params
from ..optim import AdamW, warmup_cosine

# a ~100M dense model for end-to-end training
LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab_size=8192, pattern="A",
    dtype="float32", remat="none")


def get_cfg(name: str, smoke: bool) -> ModelConfig:
    if name == "lm-100m":
        return LM_100M
    cfg = ARCHS[name]
    return cfg.smoke() if smoke else cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config for a full-size arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--preempt-at", type=int, default=0,
                    help="simulate preemption: exit(17) after N steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_cfg(args.arch, args.smoke)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    step_fn = make_train_step(cfg, opt)

    params = tree_map(lambda p: p.to(dev), init_params(
        cfg, torch.Generator().manual_seed(args.seed), "cpu"))
    n_params = sum(p.numel() for p in leaves(params))
    state = (params, opt.init(params),
             torch.zeros((), dtype=torch.int32, device=dev))
    start = 0

    ckpt_dir = args.ckpt_dir or os.path.join("results", "ckpt", cfg.name)
    last = latest_step(ckpt_dir)
    if last is not None:
        state = restore(ckpt_dir, last, state, device=dev)
        start = last
        print(f"[train] resumed from step {last}", flush=True)

    tc = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    data = Prefetcher(token_stream(tc, start_step=start))

    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={args.batch}x{args.seq}, steps {start}->{args.steps}, "
          f"device {dev}", flush=True)
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0 or step == start:
            dt = time.time() - t0
            print(f"[train] step {step+1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt/(step-start+1):.2f}s/step)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(ckpt_dir, step + 1, state)
            print(f"[train] checkpoint @ {step+1}", flush=True)
        if args.preempt_at and (step + 1) == args.preempt_at:
            print("[train] simulated preemption!", flush=True)
            sys.exit(17)

    if latest_step(ckpt_dir) != args.steps:
        save(ckpt_dir, args.steps, state)
    out = {"arch": cfg.name, "params": n_params,
           "first_loss": losses[0] if losses else None,
           "last_loss": losses[-1] if losses else None,
           "loss_curve": losses[:: max(1, len(losses) // 50)]}
    print("[train] done:", json.dumps({k: v for k, v in out.items()
                                       if k != "loss_curve"}), flush=True)
    return out


if __name__ == "__main__":
    main()
