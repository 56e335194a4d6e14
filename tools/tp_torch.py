"""The port's dense layers split over ``model`` on N cards: an LM at full
width with its depth cut, served on a (1, N) mesh, against one card
serving it whole.

    torchrun --nproc-per-node 4 tools/tp_torch.py \\
        [--arch qwen1.5-110b] [--layers 8] [--out tp_torch.json]

Each rank joins the NCCL group ``torchrun`` starts and takes the card of
its ``LOCAL_RANK``.  The weights are bf16, random from ``--seed``, drawn
whole on each rank's card and placed by
:class:`~repro_torch.launch.sharding.MeshPar`'s rules: each rank keeps
its blocks and the whole tree is freed before any step (the port has no
block-wise initialization yet, so the whole tree must fit one card
once).  The meshed ``"cuda-lm"`` backend then serves ``chip_smoke.py``'s
LM traffic (batch 4, prompts of 1536, 16 new tokens): a warm-up
generation, then ``--repeats`` timed ones (prefill seconds, each decode
step's: step 1 eager, step 2 the CUDA graph's capture, then replays).
Per rank it records the bytes of the parameters it holds (the leaves of
the split dense layers apart, against their whole bytes), the largest
dense leaf a step reads, its peak memory over the timed runs, the
collectives of one prefill and of one decode step (the eager first) by
kind and bytes, the flash-attention launches of a prefill, and under the
profiler (``chip_smoke.device_busy``) one prefill and ten replays of a
captured decode step: the card's busy ms, the top kernels and the NCCL
kernels' ms.  Rank 0 then runs the dry-run of the same two cells
(``python -m repro_torch.launch.dryrun`` in a process that sees no
card) and, once the meshed backend is gone on every rank, the unmeshed
backend on its own card with the same weights (drawn again from the
seed): the same traffic, and the relative L2 of the meshed logits
against its own.

Prints each card's name and power limit (``nvidia-smi``) first and the
record, one JSON object, last; writes the record to ``--out`` too when
given.  Needs
one card a rank, and one card that holds the whole cut model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timed_generate(torch, np, backend, prompts, new):
    """(prefill s, each decode step's s, each step's logits, tokens) of
    one greedy generation, each call ended on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, handle = backend.prefill(prompts)
    pre = time.perf_counter() - t0
    outs, steps = [logits], []
    for _ in range(new - 1):
        tok = np.argmax(outs[-1], axis=-1).astype(np.int32)
        t1 = time.perf_counter()
        outs.append(backend.decode(handle, tok))
        steps.append(time.perf_counter() - t1)
    return pre, steps, np.stack(outs), np.argmax(np.stack(outs), -1)


def profiled(torch, fn):
    """``chip_smoke.device_busy`` of ``fn``: busy and wall ms, the top
    device kernels, and the NCCL kernels' summed ms."""
    from chip_smoke import device_busy
    busy, wall, kernels = device_busy(torch, fn, top=10 ** 6)
    return dict(busy_ms=busy, wall_ms=wall, top_kernels=kernels[:8],
                nccl_ms=sum(ms for name, ms, _ in kernels
                            if "nccl" in name.lower()))


def serve(torch, np, backend, prompts, args, flash_mod):
    """The warm-up, one counted prefill and decode step, the timed
    generations, then one profiled prefill and ten profiled replays of a
    captured decode step: the backend's record."""
    backend.generate(prompts[:, :128], 3)  # first calls and a capture
    torch.cuda.synchronize()
    par = backend.par
    counted = {}
    if par is not None:
        par.coll.reset()
    before = flash_mod.launches
    logits, handle = backend.prefill(prompts)
    torch.cuda.synchronize()
    counted["flash_launches_prefill"] = flash_mod.launches - before
    if par is not None:
        counted["collectives_prefill"] = par.coll.summary()
        par.coll.reset()
        backend.decode(handle, np.argmax(logits, -1).astype(np.int32))
        counted["collectives_decode_step"] = par.coll.summary()
    del handle
    torch.cuda.reset_peak_memory_stats()
    runs = [timed_generate(torch, np, backend, prompts, args.new)
            for _ in range(args.repeats)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    b, p = prompts.shape
    pre = [r[0] for r in runs]
    steady = [statistics.median(r[1][2:]) for r in runs]
    counted["profile_prefill"] = profiled(
        torch, lambda: backend.prefill(prompts))
    logits, handle = backend.prefill(prompts)
    tok = np.argmax(logits, -1).astype(np.int32)
    for _ in range(2):  # the eager step and the capture
        backend.decode(handle, tok)

    def replays():
        for _ in range(10):
            backend.decode(handle, tok)
    counted["profile_10_decode_replays"] = profiled(torch, replays)
    return dict(
        counted,
        prefill_s=pre, prefill_tok_s=b * p / statistics.median(pre),
        first_steps_s=[r[1][:2] for r in runs],
        steady_step_ms=[x * 1e3 for x in steady],
        steady_decode_tok_s=b / statistics.median(steady),
        decode=backend.describe().get("decode"),
        peak_memory_gb=peak), runs[-1][2], runs[-1][3]


def rel_l2(np, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def dryrun(arch, layers, world, cells):
    """The dry-run's record of each (shape, batch, seq) cell on the (1,
    world) mesh at ``layers`` layers, in a process that sees no card."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shape, batch, seq in cells:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", f"1,{world}", "--set",
                 f"n_layers={layers}", "--batch", str(batch), "--seq",
                 str(seq), "--out", tmp, "--tag", "tp"], cwd=ROOT,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                     "CUDA_VISIBLE_DEVICES": ""},
                capture_output=True, text=True, timeout=900)
            path = Path(tmp) / f"{arch}__{shape}__tp.json"
            if proc.returncode != 0 or not path.exists():
                raise RuntimeError(f"the dry-run of {shape} failed:\n"
                                   f"{proc.stdout[-2000:]}"
                                   f"{proc.stderr[-3000:]}")
            r = json.loads(path.read_text())
            if not r["ok"]:
                raise RuntimeError(r.get("traceback"))
            out[r["kind"]] = {k: r[k] for k in ("batch", "seq", "mesh")}
            out[r["kind"]].update(r["full"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-110b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=1536)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="a file for the record")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("tp_torch: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]  # the port, chip_smoke
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.engine.backends import CudaLMBackend
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import MeshPar, is_dtensor
    from repro_torch.models.stack import init_params

    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh = make_mesh((1, world))  # the launcher's group; this rank's card
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    if rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        build.build()  # once, before the other ranks load it
    dist.barrier()
    build.kernel_library()

    cfg = dataclasses.replace(ARCHS[args.arch], n_layers=args.layers)
    par = MeshPar(mesh, cfg)
    prompts = np.random.default_rng(21).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt)).astype(np.int32)

    def draw():
        return init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                           dev)

    t0 = time.perf_counter()
    whole = {p: (tuple(t.shape), t.numel() * t.element_size())
             for p, t in leaves_with_paths(init_params(cfg, device="meta"))}
    placed = par.place_params(draw())  # the whole tree is freed here
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    dense = {p for p in whole if par._kept(p, set(), False)}

    def held(tree):
        return {p: (t.to_local() if is_dtensor(t) else t)
                for p, t in leaves_with_paths(tree)}
    blocks = held(placed)
    read = held(par.local_params(placed, args.prompt, cached=True))
    rec = dict(
        rank=rank, device=torch.cuda.get_device_name(dev),
        dense=par.describe()["dense"],
        param_bytes=sum(t.numel() * t.element_size()
                        for t in blocks.values()),
        param_bytes_whole=sum(b for _, b in whole.values()),
        dense_param_bytes=sum(blocks[p].numel() * blocks[p].element_size()
                              for p in dense),
        dense_param_bytes_whole=sum(whole[p][1] for p in dense),
        dense_leaves=len(dense),
        dense_leaves_read_whole=sum(tuple(read[p].shape) == whole[p][0]
                                    for p in dense),
        largest_dense_leaf_read_bytes=max(
            read[p].numel() * read[p].element_size() for p in dense),
        init_and_place_s=build_s)
    backend = CudaLMBackend(cfg, params=placed, device=dev, par=par,
                            max_context=args.prompt + args.new,
                            decode_batch=args.batch)
    served, meshed_logits, meshed_tokens = serve(torch, np, backend, prompts,
                                                 args, flash_mod)
    rec.update(served)
    ranks = [None] * world
    dist.all_gather_object(ranks, rec)
    backend.close()
    del backend, placed, blocks, read
    torch.cuda.empty_cache()
    out = None
    if rank == 0:
        cells = [("prefill_32k", args.batch, args.prompt),
                 ("decode_32k", args.batch, args.prompt + args.new)]
        dry = dryrun(args.arch, args.layers, world, cells)
        one = CudaLMBackend(cfg, params=draw(), device=dev,
                            max_context=args.prompt + args.new,
                            decode_batch=args.batch)
        alone, logits, tokens = serve(torch, np, one, prompts, args,
                                      flash_mod)
        one.close()
        del one
        agree = [bool(np.array_equal(meshed_tokens[:i + 1], tokens[:i + 1]))
                 for i in range(len(tokens))]
        out = dict(
            arch=args.arch, layers=args.layers, mesh=[1, world],
            batch=args.batch, prompt=args.prompt, new_tokens=args.new,
            torch=torch.__version__, ranks=ranks, one_card=alone,
            dryrun=dry,
            prefill_logits_rel_l2=rel_l2(np, meshed_logits[0], logits[0]),
            # each step while the two sessions' tokens so far agree
            step_logits_rel_l2=[rel_l2(np, meshed_logits[i], logits[i])
                                for i in range(len(logits)) if agree[i]],
            tokens_equal=bool(np.array_equal(meshed_tokens, tokens)),
            collectives_match_dryrun=all(
                r["collectives_prefill"]["count_by_kind"]
                == dry["prefill"]["collectives"]["count_by_kind"]
                and r["collectives_decode_step"]["count_by_kind"]
                == dry["decode"]["collectives"]["count_by_kind"]
                for r in ranks))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
    dist.barrier()
    if out is not None:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
