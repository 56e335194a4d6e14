"""The port's dense layers split over ``model`` on N cards: an LM at full
width with its depth cut, served (or, with ``--train``, trained) on a
(1, N) mesh, against one card doing the same whole.

    torchrun --nproc-per-node 4 tools/tp_torch.py \\
        [--arch qwen1.5-110b] [--layers 8] [--out tp_torch.json]
    torchrun --nproc-per-node 4 tools/tp_torch.py --train \\
        [--arch gemma3-4b] [--layers 10] [--out tp_train.json]

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
against its own.  A prefill of 1536 divides the
mesh, so its residual stream runs split over T (sequence parallelism:
the regions' all-gathers and reduce-scatters); decode's T = 1 runs it
whole.

``--train`` (gemma3-4b by default, cut to its prologue and one group of
layers) trains instead: two steps of the meshed train step
(``remat="full"``, the arch's ``grad_accum``) on a global batch of
``--batch`` x 4096 tokens from ``--seed`` (its microbatches split
over T on every rank, the loss read from each rank's vocabulary: the
vocab-parallel cross entropy), then, once the meshed state is gone, the
same steps on one card from the same weights.  Per rank it records the
seconds of each step, the peak memory over the steps (the parameters
placed first), the bytes of the state it holds, a step's collectives by
kind against the dry-run's of the same cell, and ``describe()``; and
the loss, its parts and the grad norm of each step against the one
card's.

Prints each card's name and power limit (``nvidia-smi``) first and the
record, one JSON object, last; writes the record to ``--out`` too when
given.  Needs
one card a rank, and one card that holds the whole cut model (in
training, with its fp32 moments and gradients).
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
# --train: the sequence length and the steps on each side
TRAIN_SEQ, TRAIN_STEPS = 4096, 2


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


def train_run(torch, np, cfg, par, dev, batch, args):
    """``TRAIN_STEPS`` steps of the train step (``par`` None: on
    one card) from the weights drawn from ``args.seed``: each step's
    metrics and seconds, the peak memory over the steps, the state's
    bytes on this card, and on a mesh the last step's collectives and
    ``describe()``."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch.sharding import is_dtensor
    from repro_torch.models import lm
    from repro_torch.models.stack import init_params
    from repro_torch.optim import AdamW, warmup_cosine
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 2, 100))
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         dev)
    if par is None:
        opt_state = opt.init(params)
    else:
        params = par.place_params(params)  # the whole tree is freed here
        opt_state = par.init_optimizer(opt, params)
    state = (params, opt_state, torch.zeros((), dtype=torch.int32,
                                            device=dev))
    del params, opt_state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [t.to_local() if is_dtensor(t) else t for t in leaves(state)]
    held = sum(t.numel() * t.element_size() for t in blocks)
    del blocks
    step = lm.make_train_step(cfg, opt, par=par)
    torch.cuda.reset_peak_memory_stats()
    metrics, secs = [], []
    for _ in range(TRAIN_STEPS):
        if par is not None:
            par.coll.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    tokens = args.batch * TRAIN_SEQ
    rec = dict(step_s=secs, metrics=metrics, state_bytes=held,
               tokens_per_s=tokens / statistics.median(secs),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if par is not None:
        rec.update(collectives_step=par.coll.summary(),
                   describe=par.describe())
    del state
    torch.cuda.empty_cache()
    return rec


def train_main(args, torch, np, dist, world, rank, dev, mesh) -> dict:
    """The ``--train`` record (rank 0's; None on the others)."""
    from repro_torch.configs.lm_archs import ARCHS
    from repro_torch.data.pipeline import TokenStreamConfig, token_batch
    from repro_torch.launch.sharding import MeshPar
    cfg = dataclasses.replace(ARCHS[args.arch], n_layers=args.layers)
    tc = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=args.batch, seed=args.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in token_batch(tc, 0).items()}
    par = MeshPar(mesh, cfg)
    rec = dict(rank=rank, device=torch.cuda.get_device_name(dev),
               dense=par.describe()["dense"],
               **train_run(torch, np, cfg, par, dev, batch, args))
    micro = args.batch // cfg.grad_accum
    rec["logits_bytes_a_microbatch"] = (
        micro * TRAIN_SEQ * cfg.vocab_size * 4
        // (world if rec["describe"]["logits"] == "vocab" else 1))
    ranks = [None] * world
    dist.all_gather_object(ranks, rec)
    if rank != 0:
        dist.barrier()
        return None
    dry = dryrun(args.arch, args.layers, world,
                 [("train_4k", args.batch, TRAIN_SEQ)])["train"]
    one = train_run(torch, np, cfg, None, dev, batch, args)
    dist.barrier()

    def rel(a, b):
        return abs(a - b) / abs(b)
    return dict(
        mode="train", arch=args.arch, layers=args.layers, mesh=[1, world],
        batch=args.batch, seq=TRAIN_SEQ, grad_accum=cfg.grad_accum,
        remat=cfg.remat, dtype=cfg.dtype, torch=torch.__version__,
        ranks=ranks, one_card=dict(one, logits_bytes_a_microbatch=(
            micro * TRAIN_SEQ * cfg.vocab_size * 4)),
        dryrun=dry,
        metrics_rel_diff=[{k: rel(m[k], o[k]) for k in o} for m, o in
                          zip(ranks[0]["metrics"], one["metrics"])],
        collectives_match_dryrun=all(
            r["collectives_step"]["count_by_kind"]
            == dry["collectives"]["count_by_kind"] for r in ranks))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="train on the mesh and on one card, not serve")
    ap.add_argument("--arch", default=None,
                    help="qwen1.5-110b (serving) or gemma3-4b (--train)")
    ap.add_argument("--layers", type=int, default=None,
                    help="8 (serving), or the prologue and one group")
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

    if args.arch is None:
        args.arch = "gemma3-4b" if args.train else "qwen1.5-110b"
    if args.layers is None:
        a = ARCHS[args.arch]
        args.layers = (len(a.prologue) + len(a.pattern) if args.train
                       else 8)
    world = int(os.environ.get("WORLD_SIZE", 1))
    mesh = make_mesh((1, world))  # the launcher's group; this rank's card
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    if rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    if args.train:  # the training policy launches no hand-written kernel
        out = train_main(args, torch, np, dist, world, rank, dev, mesh)
        return _finish(args, dist, out)
    if rank == 0:
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
            mode="serve", arch=args.arch, layers=args.layers,
            mesh=[1, world],
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
    return _finish(args, dist, out)


def _finish(args, dist, out) -> int:
    """Rank 0 writes ``--out`` and prints the record last; every rank
    waits for it."""
    if out is not None and args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    dist.barrier()
    if out is not None:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
