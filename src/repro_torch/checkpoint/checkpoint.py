"""Checkpointing with atomic writes, resume and keep-GC (the port's copy
of the JAX package's ``checkpoint/checkpoint.py``).

* **atomic**: written to ``<dir>/tmp.<step>``, then ``os.replace``d to
  ``<dir>/step_<step>``, so a crash mid-write never leaves a partial
  checkpoint where :func:`all_steps` looks;
* **restart**: :func:`latest_step` + :func:`restore` resume exactly;
* **bounded**: all but the newest ``keep`` checkpoints are deleted.

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
either package's bf16 files.)  The reference's elastic ``shardings``
argument waits for the port's launch slice.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from ..core.tree import leaves_with_paths, unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_BITS = np.dtype("V2")  # what numpy writes for a bf16 array


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; returns its
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = dict(leaves_with_paths(tree))
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
    return final


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


def restore(ckpt_dir: str, step: int, like, *, device="cpu"):
    """Checkpoint ``step`` in the structure of ``like`` (a tree of
    tensors), each leaf a tensor of its ``like`` leaf's dtype on
    ``device``.  Raises ``ValueError`` when a key of ``like`` is
    missing or its shape differs."""
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

    return unflatten(like, [leaf(k, w) for k, w in flat_like])
