"""Checkpointing with atomic writes, resume and keep-GC (the port's copy
of the JAX package's ``checkpoint/checkpoint.py``).

* **atomic**: written to ``<dir>/tmp.<step>``, then ``os.replace``d to
  ``<dir>/step_<step>``, so a crash mid-write never leaves a partial
  checkpoint where :func:`all_steps` looks;
* **restart**: :func:`latest_step` + :func:`restore` resume exactly;
* **bounded**: all but the newest ``keep`` checkpoints are deleted;
* **elastic**: ``restore(..., shardings=...)`` places every leaf on the
  *current* mesh (:func:`repro_torch.launch.sharding.place`), so a job
  restarted on another number of ranks resumes from the same state.
  ``save`` of a tree of DTensors writes their whole values: every rank
  calls it (the gathers are collectives) and rank 0 writes.

The format is the reference's: one ``arrays.npz`` keyed by each leaf's
path (dict keys, list indices and NamedTuple fields by name, joined by
``/``, as :func:`repro_torch.core.tree.leaves_with_paths` gives them)
plus a ``manifest.json``.  So an fp32 checkpoint written by either
package restores in the other.  numpy has no bfloat16: a bf16 leaf is
stored as its bit pattern in the reference's form, a 2-byte void
(``|V2``) array, and listed under ``"bfloat16"`` in the manifest;
:func:`restore` reads every 2-byte void leaf as bf16 bits, so a bf16
checkpoint of either package restores here bit for bit.  (The
reference's own ``restore`` cannot cast a ``|V2`` leaf and raises on
either package's bf16 files.)
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from ..core.tree import leaves_with_paths, tree_map, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_BITS = np.dtype("V2")  # what numpy writes for a bf16 array


def _whole(leaf):
    """A DTensor's whole value (a collective), other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; returns its
    directory.  DTensor leaves are written whole: in a process group
    every rank calls this, rank 0 writes, and all return once it has."""
    import torch.distributed as dist
    flat = {k: _whole(v) for k, v in leaves_with_paths(tree)}
    final = os.path.join(ckpt_dir, f"step_{step}")
    if not dist.is_initialized() or dist.get_rank() == 0:
        _write(ckpt_dir, step, final, flat, keep)
    if dist.is_initialized():
        dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, final: str, flat, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    bf16 = sorted(k for k, v in flat.items()
                  if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays), "bfloat16": bf16},
                  f)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in all_steps(ckpt_dir)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "arrays.npz")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, *, device="cpu",
            shardings=None):
    """Checkpoint ``step`` in the structure of ``like`` (a tree of
    tensors or DTensors; their global shapes), each leaf a tensor of its
    ``like`` leaf's dtype on ``device``.  ``shardings``: a tree
    congruent with ``like`` of
    :class:`~repro_torch.launch.sharding.NamedSharding` leaves (or None
    for a plain tensor), each leaf then placed on its mesh as a DTensor
    on the mesh's device.  Raises ``ValueError`` when a key of ``like``
    is missing or its shape differs."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        bf16 = set(json.load(f).get("bfloat16", ()))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        loaded = {k: z[k] for k in z.files}
    flat_like = list(leaves_with_paths(like))
    missing = sorted(k for k, _ in flat_like if k not in loaded)
    if missing:
        raise ValueError(f"checkpoint missing keys: {missing[:5]}")

    def leaf(key, want):
        a = loaded[key]
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint {key}: shape {a.shape} != "
                             f"{tuple(want.shape)}")
        if key in bf16 or a.dtype == _BF16_BITS:
            t = torch.from_numpy(np.array(a.view(np.int16))).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=want.dtype)

    tree = unflatten(like, [leaf(k, w) for k, w in flat_like])
    if shardings is None:
        return tree
    from ..launch.sharding import place

    def put(t, sh):
        if sh is None:
            return t
        return place(t.to(sh.mesh.device_type), sh.mesh, sh.spec)
    return tree_map(put, tree, shardings)
