"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step for
rank 0 of a production mesh on one host, and record its FLOPs, argument
bytes and collectives (the port of the JAX package's
``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
      --shape train_4k [--multipod] [--probe] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod]

``--mesh 1,4`` traces a debug mesh, ``--set n_layers=8`` cuts the depth,
and ``--batch`` / ``--seq`` replace the shape's global batch and
sequence length (a cell measured on the card, e.g. by
``tools/tp_torch.py``).

Importing this module sets no environment and starts no process group;
:func:`run_cell` starts the ``fake`` backend's group of ``prod(mesh)``
ranks (collectives return at once and move nothing) and runs the step
on ``meta`` tensors (shapes, no memory), the state placed by the rule
tables.  Training runs through the training policy; prefill and decode
through the plain one (the CUDA kernels take only tensors on the card;
their plain versions are the same functions).  Per variant (``full``, or ``g1`` / ``g2``
with ``--probe``: one and two groups of layers, ``grad_accum=1``) it
records ``flops`` (``FlopCounterMode``, rank 0's, the backward and any
rematerialization included), ``dense`` (``MeshPar.describe()["dense"]``:
how each dense layer kind runs over ``model`` under the default
attention rule), ``memory.argument_bytes`` (the bytes of
rank 0's blocks of the step's arguments) and ``memory.output_bytes``
(of its outputs), ``collectives`` (the port's counted wrappers:
``bytes_by_kind``, ``count_by_kind``, ``total_bytes``) and ``trace_s``.
The reference's ``compile_s``, ``bytes_accessed``, ``hlo_bytes``,
``memory.temp_bytes``, ``memory.generated_code_bytes`` and
``utilization_ops`` come from XLA's compiled module and have no meaning
here: they are left out.  The parameters' FSDP gathers count as
all-gathers on axes of more than one rank.  The dense layers run split
over ``model`` as the port runs them (see
:mod:`repro_torch.launch.sharding`): rank 0's FLOPs are its blocks',
its argument bytes count its blocks of the weights and caches, and the
collectives are the split regions' (under sequence parallelism an
all-gather into each region and a reduce-scatter out of it, else an
all-reduce a row-parallel product; Mamba2's all-to-all), the
vocab-parallel loss's all-reduces of (b, T) vectors, and the sessions'
logits' all-gather.  Attention whose heads do not divide ``model`` and
whose head dim does runs the reference's head-dim rule: a train or
prefill step on each rank's rows of T, its k and v gathered over T; a
decode step on each rank's slice of the head dim, its partial scores
all-reduced.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from ..configs.lm_archs import ARCHS, SHAPES, all_cells, cell_supported
from ..core.tree import leaves
from ..models.config import ModelConfig


def build_step(cfg: ModelConfig, kind: str, batch: int, seq: int, par):
    """The step of a cell: training through the training policy, prefill
    (an encoder's evaluation) and decode through the plain one."""
    from ..models.kernel_policy import PLAIN_KERNELS, TRAIN_KERNELS
    from ..models.lm import (make_decode_step, make_eval_step,
                             make_prefill_step, make_train_step)
    from ..optim import AdamW
    if kind == "train":
        return make_train_step(cfg, AdamW(), TRAIN_KERNELS, par=par)
    if kind == "prefill":
        if cfg.is_encoder:
            import torch
            ev = make_eval_step(cfg, PLAIN_KERNELS, par=par)
            return lambda params, b: ev(params, {**b, "labels": torch.zeros(
                (batch, seq), dtype=torch.int32,
                device=next(iter(b.values())).device)})
        return make_prefill_step(cfg, max_len=seq, kernels=PLAIN_KERNELS,
                                 par=par)
    if kind == "decode":
        return make_decode_step(cfg, PLAIN_KERNELS, par=par)
    raise ValueError(kind)


def _parse_overrides(pairs):
    out = {}
    for kv in pairs or ():
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        out[k] = v
    return out


def _local_bytes(tree) -> int:
    import torch

    from .sharding import is_dtensor
    total = 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue  # a prefill's next position
        t = t.to_local() if is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


def _call_args(kind, args):
    """The step's arguments as it takes them: the batch and the decode
    tokens whole (the step splits them; meta tensors of the whole shape),
    the caches as this rank's blocks, the parameters and optimizer state
    as DTensors."""
    import torch

    from ..core.tree import tree_map
    from .sharding import is_dtensor

    def whole(t):
        return torch.empty(t.shape, dtype=t.dtype,
                           device=t.to_local().device) if is_dtensor(t) else t

    def local(t):
        return t.to_local() if is_dtensor(t) else t
    if kind == "train":
        return (args[0], tree_map(whole, args[1]))
    if kind == "prefill":
        return (args[0], tree_map(whole, args[1]))
    return (args[0], tree_map(local, args[1]), whole(args[2]), args[3])


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             mesh_shape=None, probe: bool = False, mesh_axes=None,
             overrides=None, batch=None, seq=None) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from .mesh import fake_process_group, make_mesh, production_shape
    from .sharding import MeshPar
    from .specs import input_specs

    cfg = ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    seq = sh["seq_len"] if seq is None else seq
    gbatch = sh["global_batch"] if batch is None else batch
    shape = tuple(mesh_shape or production_shape(multi_pod))
    fake_process_group(math.prod(shape))
    mesh = make_mesh(shape, mesh_axes, device_type="cpu")
    result = {"arch": arch, "shape": shape_name, "kind": kind,
              "batch": gbatch, "seq": seq, "mesh": list(shape),
              "axes": list(mesh.mesh_dim_names),
              "multi_pod": multi_pod, "probe": probe, "ok": False}
    t0 = time.time()
    try:
        variants = []
        if probe:
            # two small unrolled variants -> per-group cost by finite
            # difference; grad_accum=1: each sees the whole batch at once
            for g in (1, 2):
                variants.append((f"g{g}", dataclasses.replace(
                    cfg, n_layers=len(cfg.prologue) + len(cfg.pattern) * g,
                    scan_layers=False, grad_accum=1)))
        else:
            variants.append(("full", cfg))
        for tag, vcfg in variants:
            par = MeshPar(mesh, vcfg)
            args = input_specs(vcfg, mesh, kind, gbatch, seq, par=par)
            step = build_step(vcfg, kind, gbatch, seq, par)
            call = _call_args(kind, args)
            par.coll.reset()
            t_trace = time.time()
            with FlopCounterMode(display=False) as fc:
                out = step(*call)
            trace_s = time.time() - t_trace
            result[tag] = {
                "trace_s": round(trace_s, 2),
                "flops": float(fc.get_total_flops()),
                "dense": par.describe()["dense"],
                "memory": {"argument_bytes": _local_bytes(args),
                           "output_bytes": _local_bytes(out)},
                "collectives": par.coll.summary(),
            }
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["total_s"] = round(time.time() - t0, 2)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="two unrolled small variants for cost extrapolation")
    ap.add_argument("--mesh", help="debug mesh shape, e.g. 2,2,2")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", dest="overrides",
                    help="config override, e.g. --set head_dim=128")
    ap.add_argument("--tag", default=None,
                    help="output filename tag (default pod/multipod/probe)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    args = ap.parse_args()

    mesh_shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh \
        else None
    cells = (all_cells() if args.all
             else [(args.arch, args.shape)])
    os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        if not cell_supported(arch, shape):
            print(f"SKIP {arch} x {shape} (unsupported)")
            continue
        tag = args.tag or ("probe" if args.probe else
                           ("multipod" if args.multipod else "pod"))
        path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"have {path}")
            continue
        r = run_cell(arch, shape, multi_pod=args.multipod,
                     mesh_shape=mesh_shape, probe=args.probe,
                     overrides=_parse_overrides(args.overrides),
                     batch=args.batch, seq=args.seq)
        with open(path, "w") as f:
            json.dump(r, f, indent=1)
        status = "OK" if r["ok"] else f"FAIL {r.get('error', '')[:120]}"
        print(f"{arch} x {shape} [{tag}] {status} ({r['total_s']}s)",
              flush=True)
        if r["ok"]:
            key = "full" if not args.probe else "g2"
            m = r[key]["memory"]
            print(f"   flops={r[key]['flops']:.3g} "
                  f"coll={r[key]['collectives']['total_bytes']:.3g}B "
                  f"args={m['argument_bytes']}", flush=True)
        else:
            print(r["traceback"], flush=True)


if __name__ == "__main__":
    main()
