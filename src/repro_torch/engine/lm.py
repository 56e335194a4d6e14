"""The LM workload behind the port's session surface (the port of the
JAX package's ``engine/lm.py``).

    cfg = SessionConfig(backend="cuda-lm", autotune=True,
                        lm=LMConfig(arch="gemma3-4b", smoke=False,
                                    max_context=2048, decode_batch=4))
    sess = LMSession(config=cfg)                  # on cuda:0
    tokens = sess.generate(prompts, max_new=16)   # greedy, (B, 16) int32

The kernel policy is the port's default (the hand-written
flash-attention and linear-scan kernels) with the axes the ``LMConfig``
pins, or with ``autotune=True`` the fastest prefill of the candidates
:func:`~repro_torch.engine.autotune.tune_lm_variants` times on the
session's device and weights (the pinned axes stay fixed; the winner is
cached on disk, so a repeat session times nothing).  A config with
``lm.mesh_shape`` set serves through
:class:`repro_torch.launch.sharding.MeshPar` on a ``DeviceMesh`` of that
shape (the weights placed by the rule tables, NCCL on the card), falling
back to single-device with a ``RuntimeWarning`` when the process group
cannot have that many ranks, as the reference does when the host has
too few devices.
"""
from __future__ import annotations

import math
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.lm_archs import ARCHS
from ..core.torch_exec import resolve_device
from ..models.kernel_policy import DEFAULT_KERNELS
from ..models.stack import init_params
from .autotune import LMTuneResult, TuningCache, tune_lm_variants
from .backends import KVCacheHandle, LMBackend, _tree_to, get_backend
from .config import LMConfig, SessionConfig


class LMSession:
    """Build once, prefill/decode many — over any registered LM backend.

    ``config`` is a :class:`SessionConfig` with ``lm`` set (or a bare
    :class:`LMConfig`, or a dict for either).  The default CNN backend
    ``"cuda"`` is upgraded to ``"cuda-lm"``; naming a non-LM backend is
    an error.  ``params`` is an optional parameter tree (the port's
    :func:`~repro_torch.models.stack.init_params` layout, e.g. from
    :func:`~repro_torch.models.lm.from_jax_params`); by default the
    session draws random weights from ``lm.seed`` on its device.  The
    tuner and the backend share the one copy of the weights.  ``mesh``:
    a ``DeviceMesh`` to serve on (by default ``lm.mesh_shape`` builds
    one); ``moe`` (``"tp"`` | ``"ep"``) and ``attn_rule`` (``"auto"`` |
    ``"qshard_kvrep"``) are the
    :class:`~repro_torch.launch.sharding.MeshPar` MoE and attention
    rules of a meshed session.
    """

    def __init__(self, config=None, *, params=None, mesh=None,
                 moe: str = "tp", attn_rule: str = "auto"):
        if config is None:
            config = SessionConfig(backend="cuda-lm", lm=LMConfig())
        if isinstance(config, LMConfig):
            config = SessionConfig(backend="cuda-lm", lm=config)
        if isinstance(config, dict):
            config = SessionConfig(**config)
        if config.lm is None:
            raise TypeError(
                "LMSession needs SessionConfig.lm (an LMConfig); for CNN "
                "graphs use InferenceSession")
        if config.backend == "cuda":  # the SessionConfig default
            config = config.replace(backend="cuda-lm")
        self.config = config
        self.backend_name = config.backend
        lm = config.lm
        backend_cls = get_backend(config.backend)
        if not issubclass(backend_cls, LMBackend):
            raise ValueError(
                f"backend {config.backend!r} does not implement the LM "
                f"contract (prefill/decode); it serves CNN graphs")
        model_cfg = ARCHS[lm.arch]
        self.model_cfg = model_cfg.smoke() if lm.smoke else model_cfg
        device = resolve_device(config.device)
        self.mesh = mesh
        if self.mesh is None and lm.mesh_shape is not None:
            self.mesh = self._make_mesh(lm.mesh_shape, device.type)
        par = None
        if self.mesh is not None:
            from ..launch.sharding import MeshPar
            par = MeshPar(self.mesh, self.model_cfg, moe=moe,
                          attn_rule=attn_rule)
            if params is None:
                params = init_params(self.model_cfg, torch.Generator(
                    device).manual_seed(lm.seed), device)
            params = par.place_params(_tree_to(params, device))
        pins = {axis: value for axis, value in (
            ("attention", lm.attn_variant), ("scan", lm.scan_variant),
            ("block_q", lm.block_q), ("block_k", lm.block_k))
            if value is not None}
        self.tuned: Optional[LMTuneResult] = None
        if config.autotune:
            # the one copy of the weights, on the device, that the tuner
            # times and the backend then serves
            if par is None:
                params = (init_params(self.model_cfg, torch.Generator(
                    device).manual_seed(lm.seed), device) if params is None
                          else _tree_to(params, device))
            tc = config.tune_cache
            self.tuned = tune_lm_variants(
                self.model_cfg, params, max_context=lm.max_context,
                batch=lm.decode_batch, prompt=min(16, lm.max_context),
                cache=tc if isinstance(tc, TuningCache) else TuningCache(tc),
                iters=max(1, config.tune_iters // 100), fixed=pins,
                device=device, par=par)
            policy = self.tuned.policy
        else:
            policy = DEFAULT_KERNELS._replace(**pins).validate()
        self._backend: LMBackend = backend_cls(
            self.model_cfg, params=params, max_context=lm.max_context,
            decode_batch=lm.decode_batch, policy=policy, seed=lm.seed,
            device=config.device, par=par)
        self.kernel_policy = self._backend.policy

    @staticmethod
    def _make_mesh(shape, device_type: str):
        """The requested mesh, or None (single-device, with the
        reference's ``RuntimeWarning``) when the process group cannot
        have ``prod(shape)`` ranks: this process alone, or a group or
        launcher of fewer."""
        from ..launch.mesh import make_mesh
        need = math.prod(shape)
        have = (dist.get_world_size() if dist.is_initialized()
                else int(os.environ.get("WORLD_SIZE", 1)))
        if need > have:
            warnings.warn(
                f"lm.mesh_shape {tuple(shape)} needs {need} ranks but the "
                f"process group has {have}; falling back to single-device",
                RuntimeWarning, stacklevel=3)
            return None
        return make_mesh(shape, device_type=device_type)

    def prefill(self, tokens: np.ndarray):
        """``(B, T)`` int32 prompts -> ``(last_logits, KVCacheHandle)``."""
        return self._backend.prefill(tokens)

    def decode(self, handle: KVCacheHandle, tokens: np.ndarray) -> np.ndarray:
        """One greedy-loop step: ``(B,)`` tokens -> ``(B, V)`` logits."""
        return self._backend.decode(handle, tokens)

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Greedy decode: ``(B, T)`` int32 -> ``(B, max_new)`` int32."""
        return self._backend.generate(prompts, max_new)

    def predict(self, tokens: np.ndarray) -> np.ndarray:
        """Full-sequence logits ``(B, T)`` -> ``(B, T, V)``."""
        return self._backend.predict_batch(tokens)

    @property
    def backend(self) -> LMBackend:
        return self._backend

    def close(self) -> None:
        self._backend.close()

    @property
    def info(self) -> dict:
        d = {"backend": self.backend_name, "config": self.config.to_dict()}
        if self.tuned is not None:
            d.update(tuned_prefill_us=self.tuned.prefill_us,
                     tuned_from_cache=self.tuned.from_cache)
        return {**d, **self._backend.describe()}
