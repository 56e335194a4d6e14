"""The LM kernel-variant autotuner with its on-disk tuning cache (the
port of the LM half of the JAX package's ``engine/autotune.py``).

* :class:`TuningCache` — one JSON record a key under a directory, written
  atomically; the default directory is the port's own, so the port's
  records never sit among the JAX package's.
* :func:`tune_lm_variants` — the LM stack's prefill kernel variants
  (attention, the flash tiles, the RWKV scan) timed as candidates by a
  greedy per-axis descent, the winner persisted in the cache and keyed by
  (arch fingerprint, prefill shape, :func:`device_digest`, measurement
  parameters).

The C code generator's tuners (per-layer unroll levels, SIMD modes, the
int8, fusion and pipeline candidates) tune the paper's CPU artifact,
which the port does not carry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core.torch_exec import resolve_device
from ..models import lm as lm_mod
from ..models.kernel_policy import (ATTENTION_VARIANTS, DEFAULT_KERNELS,
                                    SCAN_VARIANTS, KernelPolicy, fit_block)

DEFAULT_CACHE_DIR = os.path.join(tempfile.gettempdir(), "nncg_cache",
                                 "tuning_torch")


class TuningCache:
    """One JSON file a key under ``path``."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else DEFAULT_CACHE_DIR

    @staticmethod
    def key_raw(raw: str) -> str:
        """The key of a dependency string: its sha256, 24 hex digits."""
        return hashlib.sha256(raw.encode()).hexdigest()[:24]

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def get(self, key: str) -> Optional[dict]:
        try:
            with open(self._file(key)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def put(self, key: str, record: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = self._file(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, self._file(key))


def lm_fingerprint(model_cfg) -> str:
    """Content hash of a ModelConfig (16 hex digits).  The port's
    ``ModelConfig`` has the JAX one's fields, so an arch has the same
    fingerprint in both packages."""
    raw = json.dumps(dataclasses.asdict(model_cfg), sort_keys=True,
                     default=str)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def device_digest(device=None) -> str:
    """What the measurement runs on: ``torch:<type>[:<name>]:n<count>``,
    for example ``torch:cuda:NVIDIA H100 80GB HBM3:n1`` or
    ``torch:cpu:n1``.  The ``torch:`` prefix keeps the port's records
    apart from the JAX package's (``cpu:cpu:n1``, ``tpu:...``) in one
    directory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return (f"torch:cuda:{torch.cuda.get_device_name(dev)}"
                f":n{torch.cuda.device_count()}")
    return f"torch:{dev.type}:n1"


@dataclass
class LMTuneResult:
    policy: KernelPolicy  # the winner
    prefill_us: float     # its measured prefill latency
    from_cache: bool      # True if nothing was timed


_LM_BLOCK_CANDIDATES = (128, 256, 512)


def tune_lm_variants(model_cfg, params, *, max_context: int,
                     batch: int = 1, prompt: int = 16,
                     cache: Optional[TuningCache] = None, iters: int = 3,
                     fixed: Optional[dict] = None,
                     device=None, par=None) -> LMTuneResult:
    """Time the LM stack's prefill kernel variants and keep the fastest,
    as the JAX package's ``tune_lm_variants`` does: a greedy descent over
    the axes, each skipped when the arch has no such layer or the caller
    pinned it in ``fixed``:

    * attention (``ATTENTION_VARIANTS``) for archs with A/L/S blocks,
    * ``block_q = block_k`` over (128, 256, 512) for the attention winner,
    * the RWKV scan (``SCAN_VARIANTS``) for R blocks.

    A trial replaces the incumbent only when strictly faster.  Each
    candidate is a prefill of ``(batch, prompt)`` tokens from
    ``default_rng(0)`` on ``params``, which must already be on
    ``device`` (none is copied): one untimed first call, then the best
    of ``iters`` calls, each between two ``torch.cuda.synchronize()`` on
    the card, under ``inference_mode``.  Policies that run the same
    program are timed once: the CUDA flash kernel and ``"reference"``
    ignore the flash tiles, and ``"flash_jax"`` fits its tiles to the
    prompt (``fit_block``).  The record is keyed like the JAX package's,
    with this package's :func:`device_digest`.  ``par``: the session's
    mesh context (its prefill is the one timed), as in the reference."""
    dev = resolve_device(device)
    fixed = dict(fixed or {})
    base = DEFAULT_KERNELS._replace(**fixed).validate()
    kinds = set(model_cfg.pattern) | set(model_cfg.prologue or "")
    attn = bool(kinds & {"A", "L", "S"})
    tune_attn = attn and "attention" not in fixed
    tune_blocks = attn and not {"block_q", "block_k"} & set(fixed)
    tune_scan = "R" in kinds and "scan" not in fixed

    cache = cache or TuningCache()
    raw = (f"lm:{lm_fingerprint(model_cfg)}:ctx{max_context}:b{batch}"
           f":p{prompt}:{device_digest(dev)}:i{iters}"
           f":fx{sorted(fixed.items())}:v1")
    key = cache.key_raw(raw)
    rec = cache.get(key)
    if rec is not None:
        return LMTuneResult(policy=KernelPolicy(**rec["policy"]).validate(),
                            prefill_us=float(rec["prefill_us"]),
                            from_cache=True)

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model_cfg.vocab_size, size=(batch, prompt))).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def effective(pol: KernelPolicy):
        scan = pol.scan if tune_scan else DEFAULT_KERNELS.scan
        if pol.attention != "flash_jax":  # the tiles change nothing
            return pol.attention, scan
        return (pol.attention, scan, fit_block(prompt, pol.block_q),
                fit_block(prompt, pol.block_k))

    timed: Dict[tuple, float] = {}

    def time_policy(pol: KernelPolicy) -> float:
        eff = effective(pol)
        if eff in timed:
            return timed[eff]
        step = lm_mod.make_prefill_step(model_cfg, max_len=max_context,
                                        kernels=pol, par=par)
        with torch.inference_mode():
            step(params, {"tokens": toks})  # the first call, untimed
            sync()
            best = None
            for _ in range(max(1, iters)):
                sync()
                t0 = time.perf_counter()
                step(params, {"tokens": toks})
                sync()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
        timed[eff] = best * 1e6
        return timed[eff]

    best_pol, best_us = base, time_policy(base)
    if tune_attn:
        for variant in ATTENTION_VARIANTS:
            trial = best_pol._replace(attention=variant)
            t = time_policy(trial)
            if t < best_us:
                best_pol, best_us = trial, t
    if tune_blocks:
        for b in _LM_BLOCK_CANDIDATES:
            trial = best_pol._replace(block_q=b, block_k=b)
            t = time_policy(trial)
            if t < best_us:
                best_pol, best_us = trial, t
    if tune_scan:
        for scan in SCAN_VARIANTS:
            trial = best_pol._replace(scan=scan)
            t = time_policy(trial)
            if t < best_us:
                best_pol, best_us = trial, t

    cache.put(key, {
        "policy": dict(best_pol._asdict()),
        "prefill_us": round(best_us, 3),
        "arch": model_cfg.name,
        "device": device_digest(dev),
        "shape": {"batch": batch, "prompt": prompt,
                  "max_context": max_context},
    })
    return LMTuneResult(policy=best_pol, prefill_us=best_us,
                        from_cache=False)
