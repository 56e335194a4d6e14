"""The port's inference entry point: one session over a registered
backend (the port of the JAX package's ``engine/session.py``).

    sess = InferenceSession(graph, config=SessionConfig(backend="cuda"))
    probs = sess.predict(batch)          # (N, *out_shape), on cuda:0

The paper's own deployment, a trained CNN as one dependency-free ANSI C
file compiled with the host ``cc``, is the ``"c"`` backend:

    sess = InferenceSession(graph, config=SessionConfig(
        backend="c", autotune=True))     # runs on the host's CPU

Post-training int8 is one more config field, on ``"torch"`` (the int8
reference) or ``"c"`` (int8 C):

    sess = InferenceSession(graph, config=SessionConfig(
        backend="c", precision="int8",
        calibration=CalibrationConfig(data=sample_batch)))

The session runs the NNCG passes, calibrates and quantizes at int8, and
builds the backend.  On ``"c"`` it also owns the code generator's
pipeline, as the JAX session does: ISA selection, the graph-level
schedule (epilogue fusion, pipeline stages), per-layer variant
autotuning with the on-disk tuning cache, codegen and compile.  Channel
alignment follows the backend: on ``"c"`` at fp32 the widest ISA width
among ``simd`` / ``simd_search`` (8 for ``avx``), as in the JAX session,
so the optimized graph and its C equal the JAX session's; on ``"cuda"``
and ``"torch"`` a fixed multiple of 4 (padding channels with zero
filters does not change the numbers); at int8 always 1, so the graph and
its quantization equal the JAX session's.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core import cgen, passes, runtime
from ..core import quantize as quantize_mod
from ..core.graph import CNNGraph
from ..core.schedule import Schedule, make_schedule
from ..core.torch_exec import resolve_device
from ..data.pipeline import camera_frame_batch
from .autotune import (Autotuner, TuneResult, TuningCache,
                       fusion_schedule_candidates, int8_variant_candidates,
                       tune_best_simd, tune_pipeline_stages)
from .backends import Backend, CBackend, QuantizedTorchBackend, get_backend
from .config import SessionConfig

SIMD_MULTIPLE = 4


class InferenceSession:
    """Build once, predict many — over any registered backend.

    ``graph`` is a trained port :class:`CNNGraph` (raw; the passes run
    here unless ``config.optimize=False``).  ``config`` is a
    :class:`SessionConfig` or a dict of its fields; ``None`` is the
    default config (``backend="cuda"`` on ``cuda:0``).

    On ``"c"``, ``autotune=True`` times the generated code versions
    (fp32: per-layer unroll levels, under each ``simd_search`` mode;
    int8: simd x fusion candidates) and keeps the fastest, through the
    tuning cache (``tuned.from_cache`` on a repeat).  On ``"cuda"`` and
    ``"torch"`` it is accepted and tunes nothing: as in the JAX session
    for every backend but the C code generator's, the backend is built
    as is and ``tuned`` stays ``None``.
    """

    def __init__(self, graph: CNNGraph, *,
                 config: Union[SessionConfig, dict, None] = None):
        if config is None:
            config = SessionConfig()
        elif isinstance(config, dict):
            config = SessionConfig(**config)
        if config.lm is not None:
            raise TypeError(
                "SessionConfig.lm is an LM workload: construct "
                "repro_torch.engine.LMSession(config=cfg) instead of "
                "InferenceSession (which serves CNN graphs)")
        self.config = config
        self.backend_name = config.backend
        self.precision = config.precision
        is_c = config.backend == "c"
        # the generated C runs on the host (the config refuses a device)
        self.device = (torch.device("cpu") if is_c
                       else resolve_device(config.device))
        self.simd = (config.simd or runtime.best_isa()) if is_c else None
        candidates = (list(config.simd_search)
                      if (config.simd_search and config.autotune and is_c)
                      else None)
        # int8 quantizes whole channels: alignment would only add dead
        # ones; the C aligns fp32 channels to its widest vector
        if config.precision == "int8":
            self.simd_multiple = 1
        elif is_c:
            self.simd_multiple = max(
                cgen.ISAS[s].width if s in cgen.ISAS else 4
                for s in (candidates or [self.simd]))
        else:
            self.simd_multiple = SIMD_MULTIPLE
        self.graph = (passes.optimize(graph, simd_multiple=self.simd_multiple)
                      if config.optimize else graph)
        self.qgraph = None
        self.schedule: Optional[Schedule] = None
        # only the C has variants to time
        self.tuned: Optional[TuneResult] = None
        if config.precision == "int8":
            self._init_int8(candidates)
        elif is_c:
            self._init_c(candidates)
        else:
            self._backend: Backend = get_backend(config.backend)(
                self.graph, self.device)

    # -- the C backend ---------------------------------------------------------

    def _tuning_cache(self) -> TuningCache:
        tc = self.config.tune_cache
        return tc if isinstance(tc, TuningCache) else TuningCache(tc)

    def _resolve_schedule(self, qgraph=None) -> Schedule:
        """The graph-level schedule this session deploys: epilogue
        fusion per ``config.fusion`` (auto = on — output is bitwise
        identical and the arena never grows; int8 autotune additionally
        times the unfused build and may deploy it, see
        :meth:`_init_int8_c`) and the pipeline stage count per
        ``config.pipeline_stages`` (0 = auto: the autotuner times the
        host's viable stage counts on a frame stream and the winner
        persists in the tuning cache)."""
        cfg = self.config
        fusion = True if cfg.fusion is None else cfg.fusion
        s = cfg.pipeline_stages
        if s == 0:
            s = tune_pipeline_stages(
                self.graph, simd=self.simd, qgraph=qgraph,
                cache=self._tuning_cache(), fusion=fusion,
                iters=max(8, cfg.tune_iters // 8),
                func_name=cfg.func_name)
        return make_schedule(self.graph, nstages=s, fusion=fusion)

    def _init_c(self, candidates) -> None:
        """The fp32 C build: unroll levels from the autotuner (under
        each ``simd_search`` mode when given), the static heuristic
        (``unroll="auto"``) or the config's pinned levels."""
        cfg = self.config
        self.schedule = self._resolve_schedule()
        if cfg.autotune:
            cache = self._tuning_cache()
            if candidates:
                self.simd, self.tuned = tune_best_simd(
                    self.graph, candidates, cache=cache,
                    iters=cfg.tune_iters, schedule=self.schedule)
            else:
                tuner = Autotuner(self.simd, iters=cfg.tune_iters,
                                  cache=cache, schedule=self.schedule)
                self.tuned = tuner.tune(self.graph)
            unroll_cfg = self.tuned.levels
        elif cfg.unroll == "auto":
            unroll_cfg = cgen.choose_levels(self.graph, 20_000)
        else:
            unroll_cfg = cfg.unroll
        # tuned levels were measured at the tuner's emission budget;
        # the deployed build must emit the same code
        term_budget = (self.tuned.term_cap if self.tuned is not None
                       else None)
        self._backend = CBackend(
            self.graph, simd=self.simd, unroll=unroll_cfg,
            func_name=cfg.func_name, term_budget=term_budget,
            threads=cfg.threads, schedule=self.schedule)
        # the CPU-feature guard's demotion, reported
        self.simd = self._backend.opts.simd

    def _init_int8(self, candidates) -> None:
        """Calibrate (on this session's device) or take the provided
        qparams, quantize, and build the int8 backend: the int8 reference
        on ``"torch"``, int8 C on ``"c"``.  The kernel path has no int8
        kernels, so ``"cuda"`` raises, as the JAX session refuses
        ``"pallas"``."""
        cfg = self.config
        if cfg.backend not in ("torch", "c"):
            raise ValueError(
                f"precision='int8' supports backends 'torch' and 'c', "
                f"not {cfg.backend!r}")
        cal = cfg.calibration
        if cal.qparams is not None:
            # externally-determined (e.g. QAT-exported) scales and
            # zero-points: no calibration pass at all
            self.qgraph = quantize_mod.quantize_from_qparams(
                self.graph, cal.qparams)
        else:
            data = cal.data
            method = cal.resolved_method(data_provided=data is not None)
            if data is None:
                data = self._default_calibration()
            self.qgraph = quantize_mod.quantize(
                self.graph, data, method=method, percentile=cal.percentile,
                per_channel=cal.per_channel, device=self.device)
        if cfg.backend == "c":
            self._init_int8_c(candidates)
        else:
            self._backend = QuantizedTorchBackend(self.qgraph, self.device)

    def _init_int8_c(self, candidates) -> None:
        """The int8 C build.

        The quantized kernels' variant space is the SIMD mode (the int8
        emitters are rolled — unroll levels don't apply): with
        ``autotune`` the session times each candidate build and keeps
        the fastest; integer accumulation is order-independent, so all
        candidates are bit-identical and the choice is purely speed.
        The winning mode persists in the same on-disk tuning cache the
        float path uses (keyed by graph/compiler/codegen version plus
        an int8 tag and the qparams' digest), so a repeat session times
        nothing."""
        cfg = self.config
        sched = self.schedule = self._resolve_schedule(self.qgraph)
        if not cfg.autotune:
            # honor an explicit simd= (post guard) or take the host's
            # best int8 variant outright
            simd = cfg.simd or runtime.supported_int8_simds()[0]
            self._backend = CBackend(self.graph, simd=simd,
                                     func_name=cfg.func_name,
                                     threads=cfg.threads,
                                     qgraph=self.qgraph, schedule=sched)
            self.simd = self._backend.opts.simd
            return
        cands = candidates
        if not cands:
            cands = int8_variant_candidates(self.qgraph)
        else:
            # explicit simd_search lists still go through the runtime
            # CPU-feature guard (no SIGILL, no duplicate builds after
            # fallback collapses variants)
            cands = list(dict.fromkeys(
                runtime.resolve_int8_simd(s) for s in cands))
        # fusion kinds are a variant axis too when the config leaves
        # fusion to auto: fused output is bit-identical, but on layers
        # with channel-group tails a fused requant epilogue can lose
        # more than the skipped memory round-trip buys, so each distinct
        # kind subset (all, Adds-only, none) is timed like any other
        # code version
        scheds = [sched]
        if cfg.fusion is None:
            scheds = fusion_schedule_candidates(
                self.graph, nstages=len(sched.stages))
        cache = self._tuning_cache()
        # the generated int8 C embeds the calibration-derived qparams,
        # so the cache key must carry them — and so is a different
        # schedule (fusion + stage partition) a different program
        qdigest = quantize_mod.qparams_digest(self.qgraph)
        key = cache.key(self.graph, "+".join(cands),
                        extra=f"int8:{qdigest}:i{cfg.tune_iters}:sched:"
                              + "+".join(s.digest() for s in scheds))
        rec = cache.get(key)
        if rec is not None and rec.get("simd") in cands:
            self.schedule = next(
                (s for s in scheds if s.digest() == rec.get("sched")), sched)
            self._backend = CBackend(
                self.graph, simd=rec["simd"], func_name=cfg.func_name,
                threads=cfg.threads, qgraph=self.qgraph,
                schedule=self.schedule)
            self.simd = self._backend.opts.simd
            self.tuned = TuneResult(levels={}, us_per_call=float(
                rec.get("us_per_call", 0.0)), from_cache=True)
            return
        x = np.random.default_rng(0).normal(
            size=self.graph.input_shape).astype(np.float32)
        best = None
        for simd in cands:
            for sc in scheds:
                b = CBackend(self.graph, simd=simd, func_name=cfg.func_name,
                             threads=cfg.threads, qgraph=self.qgraph,
                             schedule=sc)
                # min over repeats: scheduler noise must not persist a
                # wrong variant/schedule into the tuning cache
                t = min(b.time_per_call_us(
                    x, iters=cfg.tune_iters,
                    warmup=max(10, cfg.tune_iters // 10))
                    for _ in range(3))
                if best is None or t < best[0]:
                    best = (t, simd, sc, b)
        _, _, self.schedule, self._backend = best
        self.simd = self._backend.opts.simd
        cache.put(key, {"simd": self.simd, "sched": self.schedule.digest(),
                        "us_per_call": round(best[0], 3)})
        self.tuned = TuneResult(levels={}, us_per_call=best[0],
                                from_cache=False)

    def _default_calibration(self) -> np.ndarray:
        """Representative frames for int8 calibration when the caller
        supplies none: camera-like frames for image inputs (ranges
        calibrated on unbounded noise cost the robot net its top-1
        agreement), bounded uniform noise otherwise."""
        in_shape = tuple(self.graph.input_shape)
        n = self.config.calibration.samples
        if len(in_shape) == 3:
            return camera_frame_batch(n, in_shape, seed=0)
        return np.random.default_rng(0).uniform(
            -1.0, 1.0, size=(n,) + in_shape).astype(np.float32)

    @property
    def input_shape(self):
        return self.graph.input_shape

    @property
    def output_shape(self):
        return self.graph.output_shape

    @property
    def backend(self) -> Backend:
        """The live :class:`Backend` this session serves through."""
        return self._backend

    def close(self) -> None:
        self._backend.close()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Single image ``(*in_shape)`` -> ``(*out_shape)``, or batch
        ``(N, *in_shape)`` -> ``(N, *out_shape)``."""
        x = np.asarray(x, dtype=np.float32)
        in_shape = tuple(self.input_shape)
        if x.shape == in_shape:
            return self._backend.predict_batch(x[None])[0]
        if x.shape[1:] == in_shape:
            return self._backend.predict_batch(x)
        raise ValueError(
            f"predict: expected {in_shape} or (N,)+{in_shape}, "
            f"got {x.shape}")

    def benchmark(self, x: Optional[np.ndarray] = None, *,
                  iters: int = 500, warmup: int = 20) -> float:
        """Single-image latency of this session's backend in µs/call; a
        batch is sliced to its first image.  On ``"c"`` a ctypes-level
        loop over the generated entry (the paper's in-process
        measurement); on ``"cuda"`` and ``"torch"`` the device time per
        forward with the input already on the device."""
        if x is None:
            x = np.random.default_rng(0).normal(
                size=self.input_shape).astype(np.float32)
        x = np.asarray(x, np.float32)
        in_shape = tuple(self.input_shape)
        if x.shape != in_shape:
            if x.ndim == len(in_shape) + 1 and x.shape[1:] == in_shape:
                x = x[0]
            else:
                raise ValueError(
                    f"benchmark times one image of {in_shape}, "
                    f"got {x.shape}")
        return self._backend.time_per_call_us(x, iters=iters, warmup=warmup)

    @property
    def info(self) -> dict:
        d = dict(
            backend=self.backend_name, precision=self.precision,
            device=str(self.device), simd_multiple=self.simd_multiple,
            input_shape=tuple(self.input_shape),
            output_shape=tuple(self.output_shape),
            config=self.config.to_dict())
        if self.simd is not None:
            d["simd"] = self.simd
        if self.qgraph is not None:
            d["quantized_layers"] = sorted(self.qgraph.weights)
            d["input_qparams"] = (self.qgraph.input_qp.scale,
                                  self.qgraph.input_qp.zero_point)
            d["calibration_method"] = self.qgraph.method
            if self.qgraph.method == "percentile":
                d["calibration_percentile"] = self.qgraph.percentile
        if self.schedule is not None:
            # fusion decisions + stage partition of the deployed build
            d["schedule"] = self.schedule.describe()
        if self.tuned is not None:
            d.update(levels=self.tuned.levels,
                     tuned_us_per_call=self.tuned.us_per_call,
                     tuned_from_cache=self.tuned.from_cache)
        desc = self._backend.describe()
        if "arena_bytes" in desc:
            # liveness-planned memory: the one workspace all
            # intermediates share, vs. one buffer a layer, plus how many
            # bytes are live at each layer step
            d["c_source_bytes"] = desc["c_source_bytes"]
            d["so_path"] = desc["so_path"]
            d["arena_bytes"] = desc["arena_bytes"]
            d["arena_buffer_sum_bytes"] = desc["arena_buffer_sum_bytes"]
            d["per_layer_live_bytes"] = desc["per_layer_live_bytes"]
            d["peak_live_bytes"] = max(
                desc["per_layer_live_bytes"].values(), default=0)
            d["threads"] = desc["threads"]
            d["pipeline_stages"] = desc["pipeline_stages"]
            d["schedule_digest"] = desc["schedule_digest"]
        return d
