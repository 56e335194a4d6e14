"""The autotuners with their on-disk tuning cache (the port of the JAX
package's ``engine/autotune.py``).

* :class:`TuningCache` — one JSON record a key under a directory, written
  atomically; the default directory is the port's own, so the port's
  records never sit among the JAX package's.  :meth:`TuningCache.key`
  keys a C record by (:func:`graph_fingerprint`, ISA, compiler,
  ``CODEGEN_VERSION``, the tuner's parameters and schedule digest), as
  the reference does.
* :class:`Autotuner` — the paper's per-layer benchmark-and-select for
  the generated C: greedy coordinate descent over the unroll levels of
  :func:`repro_torch.core.cgen.enumerate_variants`, each candidate
  compiled and timed on the host; :func:`tune_best_simd` runs it under
  several SIMD modes, :func:`tune_pipeline_stages` times the stage
  counts, and :func:`int8_variant_candidates` /
  :func:`fusion_schedule_candidates` list the int8 session's simd and
  fusion candidates.
* :func:`tune_lm_variants` — the LM stack's prefill kernel variants
  (attention, the flash tiles, the RWKV scan) timed as candidates by a
  greedy per-axis descent, the winner persisted in the cache and keyed by
  (arch fingerprint, prefill shape, :func:`device_digest`, measurement
  parameters).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import cgen, runtime
from ..core.graph import CNNGraph
from ..core.runtime import cc_fingerprint  # part of the C cache key
from ..core.schedule import Schedule, make_schedule
from ..core.torch_exec import resolve_device
from ..models import lm as lm_mod
from ..models.kernel_policy import (ATTENTION_VARIANTS, DEFAULT_KERNELS,
                                    SCAN_VARIANTS, KernelPolicy, fit_block)

DEFAULT_CACHE_DIR = os.path.join(tempfile.gettempdir(), "nncg_cache",
                                 "tuning_torch")


def graph_fingerprint(graph: CNNGraph) -> str:
    """Content hash of a trained graph: topology, layer names, structure,
    weights.

    Two graphs with the same fingerprint generate byte-identical C for
    any codegen options, so tuning results transfer exactly.  The DAG
    edges (``layer.inputs``) participate — two nets with identical layer
    stacks but different wiring (e.g. with/without a residual skip) are
    different programs.  Layer names participate because cached unroll
    selections are keyed by layer name (``CodegenOptions.level_for``).
    """
    h = hashlib.sha256()
    for layer in graph.layers:
        h.update(type(layer).__name__.encode())
        h.update(f"name={layer.name!r};".encode())
        h.update(f"inputs={list(layer.inputs)!r};".encode())
        for attr in ("shape", "strides", "padding", "activation", "alpha",
                     "size", "eps", "rate"):
            if hasattr(layer, attr):
                h.update(f"{attr}={getattr(layer, attr)!r};".encode())
        for attr in ("weights", "bias", "mean", "var", "gamma", "beta"):
            v = getattr(layer, attr, None)
            if v is not None:
                # shape participates: byte-identical weights factored
                # differently (HWIO vs HWCM splits) are different programs
                h.update(f"{attr}{tuple(np.shape(v))};".encode())
                h.update(np.ascontiguousarray(v, np.float32).tobytes())
    return h.hexdigest()


class TuningCache:
    """One JSON file a key under ``path``."""

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else DEFAULT_CACHE_DIR

    def key(self, graph: CNNGraph, simd: str, extra: str = "") -> str:
        """Cache key over everything the measurement depends on: the
        trained graph, SIMD mode, compiler, codegen version, and (via
        ``extra``) the tuner's own search/measurement parameters."""
        raw = (f"{graph_fingerprint(graph)}:{simd}:{cc_fingerprint()}"
               f":v{cgen.CODEGEN_VERSION}:{extra}")
        return self.key_raw(raw)

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


@dataclass
class TuneResult:
    levels: Dict[str, cgen.Level]  # per-layer unroll selection
    us_per_call: float             # measured latency of the winner
    from_cache: bool               # True if no benchmarking happened
    term_cap: int = 200_000        # emission budget the levels assume —
                                   # the final build must use the same


class Autotuner:
    """Greedy per-layer variant selection for the C backend.

    Starts from the static :func:`cgen.choose_levels` heuristic, then
    for each Conv2D/MaxPool layer tries every feasible unroll level
    (holding the others fixed) and keeps any strict improvement —
    exactly the paper's per-layer benchmark-and-select, with results
    persisted through :class:`TuningCache`.
    """

    def __init__(self, simd: str, *, start_budget: int = 20_000,
                 term_cap: int = 200_000, iters: int = 300,
                 repeats: int = 3, cache: Optional[TuningCache] = None,
                 schedule: Optional[Schedule] = None):
        self.simd = simd
        self.start_budget = start_budget
        self.term_cap = term_cap
        self.iters = iters
        self.repeats = max(1, repeats)
        self.cache = cache
        # the graph-level schedule (fusion + stage partition) the
        # deployed build will use: tuned levels are measured under the
        # same generated code, and the digest keys the cached record —
        # a different schedule is a different program to tune
        self.schedule = schedule

    def _params_key(self) -> str:
        key = (f"b{self.start_budget}:t{self.term_cap}:i{self.iters}"
               f":r{self.repeats}")
        if self.schedule is not None:
            key += f":sched:{self.schedule.digest()}"
        return key

    def _time(self, graph: CNNGraph, levels: Dict[str, cgen.Level],
              x: np.ndarray) -> float:
        # term_budget = term_cap so every explored level is actually
        # emitted as requested (the default budget would silently
        # demote deep levels and make distinct trials identical code)
        net = runtime.build(graph, cgen.CodegenOptions(
            simd=self.simd, unroll=dict(levels),
            term_budget=self.term_cap), schedule=self.schedule)
        # min over repeats: robust to scheduler noise, which would
        # otherwise persist a wrong selection into the tuning cache
        return min(
            net.time_per_call_us(x, iters=self.iters,
                                 warmup=max(10, self.iters // 10))
            for _ in range(self.repeats))

    def tune(self, graph: CNNGraph,
             x: Optional[np.ndarray] = None) -> TuneResult:
        if self.cache is not None:
            key = self.cache.key(graph, self.simd, self._params_key())
            rec = self.cache.get(key)
            if rec is not None:
                return TuneResult(levels=dict(rec["levels"]),
                                  us_per_call=float(rec["us_per_call"]),
                                  from_cache=True,
                                  term_cap=self.term_cap)
        if x is None:
            x = np.random.default_rng(0).normal(
                size=graph.input_shape).astype(np.float32)

        # per-layer *input* shapes via the DAG edges (branch layers get
        # their true producer shapes, not list-adjacent ones)
        smap = graph.shape_map()
        shapes: Dict[str, tuple] = {
            layer.name: (smap[layer.inputs[0]] if layer.inputs else None)
            for layer in graph.layers
        }

        levels = cgen.choose_levels(graph, self.start_budget)
        best = self._time(graph, levels, x)
        for layer in graph.layers:
            for lvl in cgen.enumerate_variants(layer, shapes[layer.name],
                                               term_cap=self.term_cap):
                if levels.get(layer.name) == lvl:
                    continue
                trial = dict(levels)
                trial[layer.name] = lvl
                t = self._time(graph, trial, x)
                if t < best:
                    best, levels = t, trial

        if self.cache is not None:
            self.cache.put(key, {
                "levels": levels,
                "us_per_call": best,
                "simd": self.simd,
                "cc": cc_fingerprint(),
                "graph": graph_fingerprint(graph),
            })
        return TuneResult(levels=levels, us_per_call=best, from_cache=False,
                          term_cap=self.term_cap)


def int8_variant_candidates(qgraph=None) -> List[str]:
    """The int8 kernel variants worth timing on this host, best-first.

    Starts from :func:`runtime.supported_int8_simds` (the CPU-feature
    guard — a variant the host can't execute is never enumerated, let
    alone loaded), then drops ``avx_ubs`` when no layer of ``qgraph``
    passes the static ``vpmaddubsw`` saturation proof: that build
    would demote every layer to the plain ``avx`` tile, so timing it
    would only duplicate the ``avx`` candidate."""
    cands = runtime.supported_int8_simds()
    if qgraph is not None and "avx_ubs" in cands \
            and not cgen.maddubsw_any_eligible(qgraph):
        cands = [c for c in cands if c != "avx_ubs"]
    return cands


def fusion_schedule_candidates(graph: CNNGraph, *,
                               nstages: int = 1) -> List[Schedule]:
    """Schedule variants the int8 autotuner times, deduped by digest.

    Fusion kinds are a code-variant axis: fused output is bit-identical
    to unfused, but on layers with channel-group tails a fused requant
    epilogue can lose more than the skipped memory round-trip buys — so
    each kind subset that yields a distinct program is timed like any
    other code version.  Subsets are nested (all kinds ⊃ Adds-only ⊃
    none) rather than the full power set: the pool/Concat fusions
    landed together and share the tail-sensitivity concern, while Add
    fusion predates them with its own track record."""
    cands: List[Schedule] = []
    seen = set()
    for kinds in (("add", "pool", "concat"), ("add",), ()):
        s = make_schedule(graph, nstages=nstages,
                          fusion=bool(kinds), kinds=kinds or ("add",))
        d = s.digest()
        if d not in seen:
            seen.add(d)
            cands.append(s)
    return cands


def pipeline_stage_candidates(max_stages: int = 4) -> List[int]:
    """Stage counts worth timing on this host: layer pipelining trades
    one inter-stage hand-off per frame for stage-level core
    parallelism, so counts beyond the core budget only add overhead —
    a single-core host gets ``[1]`` and times nothing."""
    cores = os.cpu_count() or 1
    return [1] + [s for s in range(2, max_stages + 1) if s <= cores]


def tune_pipeline_stages(graph: CNNGraph, *, simd: str, qgraph=None,
                         cache: Optional[TuningCache] = None,
                         fusion: bool = True, iters: int = 32,
                         func_name: str = "nncg_net",
                         candidates: Optional[List[int]] = None) -> int:
    """Third variant axis: the pipeline stage count.

    Times a batch-1 frame *stream* (the pipeline's target workload —
    per-frame latency through ``predict_batch``) for every viable stage
    count and returns the fastest; the winner persists in the tuning
    cache keyed alongside the fusion flag, host core count, simd and
    precision, so a repeat session streams nothing."""
    if candidates is None:
        candidates = pipeline_stage_candidates()
    if len(candidates) == 1:
        return candidates[0]
    cache = cache or TuningCache()
    extra = (f"pipe:{'+'.join(map(str, candidates))}:f{int(fusion)}"
             f":i{iters}:c{os.cpu_count() or 1}"
             + (":int8" if qgraph is not None else ""))
    key = cache.key(graph, simd, extra=extra)
    rec = cache.get(key)
    if rec is not None and rec.get("nstages") in candidates:
        return int(rec["nstages"])
    n = max(8, int(iters))
    x = np.random.default_rng(0).normal(
        size=(n,) + tuple(graph.input_shape)).astype(np.float32)
    # rolled loops for the stage-count trials: the relative stage
    # balance survives the emission style, and candidate builds at the
    # default full unroll would dwarf the measurement in compile time
    opts = cgen.CodegenOptions(simd=simd, func_name=func_name,
                               unroll=None)
    best = None
    for S in candidates:
        sched = make_schedule(graph, nstages=S, fusion=fusion)
        net = (runtime.build_quantized(qgraph, opts, schedule=sched)
               if qgraph is not None
               else runtime.build(graph, opts, schedule=sched))
        net.predict_batch(x[:min(4, n)])  # warm caches + threads
        t = None
        for _ in range(2):  # min over repeats: scheduler-noise guard
            t0 = time.perf_counter()
            net.predict_batch(x)
            dt = time.perf_counter() - t0
            t = dt if t is None else min(t, dt)
        if best is None or t < best[0]:
            best = (t, S)
    cache.put(key, {"nstages": best[1],
                    "stream_us_per_frame": round(best[0] / n * 1e6, 3)})
    return best[1]


def tune_best_simd(graph: CNNGraph, simds, *,
                   x: Optional[np.ndarray] = None,
                   cache: Optional[TuningCache] = None,
                   **tuner_kw):
    """Second variant axis: run the per-layer tuner under each SIMD mode
    and keep the overall fastest. Returns ``(simd, TuneResult)``.

    Cached candidates are re-*timed* (never re-tuned, and with the .so
    content cache no recompile happens) so the cross-mode comparison
    uses measurements taken under the same machine conditions — a
    cached number from an earlier, differently-loaded run must not
    decide the selection.
    """
    if x is None:
        x = np.random.default_rng(0).normal(
            size=graph.input_shape).astype(np.float32)
    best_simd, best_res, best_us = None, None, None
    for simd in simds:
        tuner = Autotuner(simd, cache=cache, **tuner_kw)
        res = tuner.tune(graph, x)
        us = (tuner._time(graph, res.levels, x) if res.from_cache
              else res.us_per_call)
        if best_us is None or us < best_us:
            best_simd, best_res, best_us = simd, res, us
    if best_simd is None:
        raise ValueError("tune_best_simd: empty simd candidate list")
    return best_simd, best_res


# ============================================================ LM variants ====

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
