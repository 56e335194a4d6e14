"""Typed, frozen session configuration (the port's part of the JAX
package's ``engine/config.py``: ``SessionConfig``, its int8 calibration
sub-config ``CalibrationConfig`` and its ``lm`` sub-config ``LMConfig``).

    cfg = SessionConfig(backend="cuda")              # a CNN on cuda:0
    cfg = SessionConfig(backend="torch", device="cpu")
    cfg = SessionConfig(backend="c", autotune=True)  # generated C, host cc
    cfg = SessionConfig(backend="torch", precision="int8",
                        calibration=CalibrationConfig(method="minmax"))
    cfg = SessionConfig(backend="cuda-lm",           # an LM on cuda:0
                        lm=LMConfig(arch="gemma3-4b", smoke=False))

``device=None`` means the card (``cuda:0``); a session asked for the card
on a machine without one raises ``RuntimeError``.  The ``"c"`` backend
runs the generated C on the host, so it takes ``device=None`` or
``"cpu"`` only.  ``autotune=True`` times the C code versions or the LM
kernel variants (:mod:`repro_torch.engine.autotune`) and caches the
winner in ``tune_cache``; ``LMConfig.mesh_shape`` runs the LM over a
device mesh (:class:`repro_torch.engine.LMSession`).  The C code
generator's knobs (``simd``, ``simd_search``, ``unroll``, ``threads``,
``func_name``, ``fusion``, ``pipeline_stages``) carry the JAX package's
defaults and checks, and are read by the ``"c"`` backend only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.lm_archs import ARCHS
from ..core import quantize as quantize_mod
from ..models.kernel_policy import ATTENTION_VARIANTS, SCAN_VARIANTS

_PRECISIONS = ("fp32", "int8")


@dataclass(frozen=True)
class CalibrationConfig:
    """The int8 calibration knobs (ignored at ``precision="fp32"``).

    ``data`` is the representative sample batch ``(N, *in_shape)``; when
    ``None`` the session synthesizes ``samples`` camera-like frames via
    :func:`repro_torch.data.pipeline.camera_frame_batch` (bounded,
    spatially smooth — the input domain the paper's nets actually see).
    ``data`` is runtime state, not a knob: it is excluded from
    ``to_dict()``.

    ``method=None`` means *auto*: ``"minmax"`` when the caller provided
    ``data`` (the historical, bit-stable behavior), ``"percentile"``
    when the session synthesizes its default frames (outlier-tail clip
    is what keeps the robot net's top-1 agreement >= 0.99 there).

    ``qparams`` accepts externally-determined quantization parameters —
    e.g. exported from a QAT run — as a mapping of layer name to
    :class:`repro_torch.core.quantize.QParams` (or a ``(scale,
    zero_point)`` pair).  When set, the session skips calibration
    entirely; like ``data`` it is runtime state, not a serializable knob.

    ``per_channel=True`` gives eligible layers per-output-channel
    activation qparams (scales folded into the consumers' weight
    quantization; see
    :func:`repro_torch.core.quantize.per_channel_eligible`).  Ignored
    when ``qparams`` is provided (the import format is per-tensor).
    """

    data: Optional[Any] = None          # np.ndarray; not serialized
    samples: int = 32
    method: Optional[str] = None        # None = auto (see above)
    percentile: float = 99.99
    qparams: Optional[Dict[str, Any]] = None  # QAT import; not serialized
    per_channel: bool = False

    def __post_init__(self):
        if (self.method is not None
                and self.method not in quantize_mod.CALIBRATION_METHODS):
            raise ValueError(
                f"calibration method {self.method!r}; expected one of "
                f"{quantize_mod.CALIBRATION_METHODS} or None (auto)")
        if not (0.0 < self.percentile <= 100.0):
            raise ValueError(
                f"calibration percentile {self.percentile!r} not in (0, 100]")
        if self.samples < 1:
            raise ValueError(f"calibration samples {self.samples} < 1")

    def resolved_method(self, *, data_provided: bool) -> str:
        """The concrete range-selection method after resolving auto."""
        if self.method is not None:
            return self.method
        return "minmax" if data_provided else "percentile"

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe knobs (``data`` omitted — arrays don't serialize)."""
        return {"samples": self.samples, "method": self.method,
                "percentile": self.percentile,
                "per_channel": self.per_channel}


@dataclass(frozen=True)
class LMConfig:
    """The LM workload sub-config carried by ``SessionConfig.lm``; its
    fields and their meaning are the JAX package's, so a config
    round-trips between the two packages.

    ``arch`` names an entry of :data:`repro_torch.configs.lm_archs.ARCHS`;
    ``smoke=True`` shrinks it via ``ModelConfig.smoke()`` (the CPU test
    shape, fp32).  ``attn_variant`` / ``scan_variant`` pin the
    :class:`~repro_torch.models.kernel_policy.KernelPolicy` axes; axes
    left ``None`` take the port's default, the kernels.  ``block_q`` /
    ``block_k`` pin the policy's tiles of ``"flash_jax"``; the CUDA
    kernel's tiles are fixed and masked at the ragged edge, so
    ``"flash_pallas"`` ignores them.  ``mesh_shape`` (e.g. ``(1, 1)``:
    data, model) serves the LM over a device mesh of that shape, or
    single-device with a ``RuntimeWarning`` when the process group
    cannot have that many ranks."""

    arch: str = "gemma3-4b"
    smoke: bool = True
    max_context: int = 128
    decode_batch: int = 1
    attn_variant: Optional[str] = None
    scan_variant: Optional[str] = None
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(
                f"lm arch {self.arch!r}; expected one of "
                f"{tuple(sorted(ARCHS))}")
        if self.max_context < 1:
            raise ValueError(f"max_context {self.max_context} < 1")
        if self.decode_batch < 1:
            raise ValueError(f"decode_batch {self.decode_batch} < 1")
        if (self.attn_variant is not None
                and self.attn_variant not in ATTENTION_VARIANTS):
            raise ValueError(
                f"attn_variant {self.attn_variant!r}; expected one of "
                f"{ATTENTION_VARIANTS} or None (the default)")
        if (self.scan_variant is not None
                and self.scan_variant not in SCAN_VARIANTS):
            raise ValueError(
                f"scan_variant {self.scan_variant!r}; expected one of "
                f"{SCAN_VARIANTS} or None (the default)")
        for name in ("block_q", "block_k"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} {v} < 1")
        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape",
                               tuple(int(d) for d in self.mesh_shape))
            if any(d < 1 for d in self.mesh_shape):
                raise ValueError(f"mesh_shape {self.mesh_shape}")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["mesh_shape"] is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        return d


def _coerce_lm(v) -> Optional[LMConfig]:
    if v is None or isinstance(v, LMConfig):
        return v
    if isinstance(v, dict):
        return LMConfig(**v)
    if isinstance(v, str):  # shorthand: lm="gemma3-4b"
        return LMConfig(arch=v)
    raise TypeError(f"lm must be an LMConfig, dict, arch name or None; "
                    f"got {type(v).__name__}")


def _coerce_calibration(v) -> CalibrationConfig:
    if isinstance(v, CalibrationConfig):
        return v
    if isinstance(v, dict):
        return CalibrationConfig(**v)
    if v is None:
        return CalibrationConfig()
    # legacy spelling: calibration=<sample batch array>
    return CalibrationConfig(data=v)


@dataclass(frozen=True)
class SessionConfig:
    """Everything a session needs beyond the graph or the arch.

    * ``backend`` — ``"cuda"`` (the hand-written CNN kernels), ``"torch"``
      (plain eager PyTorch), ``"c"`` (the paper's generated ANSI C,
      compiled with the host ``cc``) or, for an LM, ``"cuda-lm"``; see
      :func:`repro_torch.engine.backends.available_backends`.
    * ``optimize`` — run the NNCG passes (BN fold, activation fusion,
      channel alignment) before building a CNN backend.
    * ``precision`` — ``"fp32"`` or ``"int8"`` (post-training int8, on
      ``backend="torch"`` (the int8 reference) or ``"c"`` (int8 C)).
    * ``calibration`` — the int8 calibration knobs
      (:class:`CalibrationConfig`, or a dict of its fields).
    * ``device`` — a torch device string; ``None`` = ``cuda:0`` (the
      host's CPU for ``"c"``, which takes ``None`` or ``"cpu"`` only).
    * ``autotune`` — ``"c"``: benchmark every per-layer code version
      (and, at int8, every simd x fusion candidate) and keep the
      fastest; an LM session times its kernel variants
      (:func:`repro_torch.engine.autotune.tune_lm_variants`); the other
      CNN backends have nothing to tune and build as is.
    * ``tune_cache`` — the tuning cache: a directory path, a
      :class:`~repro_torch.engine.autotune.TuningCache`, or ``None`` for
      the default directory.
    * ``tune_iters`` — the measurement budget: timing iterations a C
      candidate; an LM tuning takes the best of
      ``max(1, tune_iters // 100)`` prefills a candidate.
    * ``simd`` — ``"c"``: the codegen mode (``"generic"``,
      ``"structured"``, ``"sse"``, ``"avx"``; at int8 also the
      ``QISAS`` variants); ``None`` = the widest the host supports.
    * ``simd_search`` — ``"c"`` with ``autotune``: modes to tune under;
      the fastest (mode, levels) pair is kept.
    * ``unroll`` — ``"c"`` without autotune: ``"auto"`` (the static
      heuristic), one level, or a per-layer dict.
    * ``threads`` — ``"c"``: drive a batch thread-parallel through the
      reentrant ``<func>_ws`` entry.
    * ``func_name`` — the generated C's entry symbol.
    * ``fusion`` — ``"c"``: epilogue fusion of residual Adds, pools and
      Concat edges (``None`` = auto = on; int8 autotune also times the
      kind subsets); the output is bitwise identical either way.
    * ``pipeline_stages`` — ``"c"``: 1 = one function, k > 1 = a
      layer-pipelined build streaming a batch across k cores, 0 = tune
      the stage count on this host.
    * ``lm`` — the LM workload (:class:`LMConfig`), served by
      :class:`repro_torch.engine.LMSession`; ``None`` = a CNN session.
    """

    backend: str = "cuda"
    optimize: bool = True
    precision: str = "fp32"
    device: Optional[str] = None
    autotune: bool = False
    tune_cache: Optional[Any] = None    # dir path str, or a TuningCache
    tune_iters: int = 300
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    lm: Optional[LMConfig] = None
    # the C code generator's knobs (backend "c"), with the JAX defaults
    simd: Optional[str] = None
    simd_search: Optional[Tuple[str, ...]] = None
    unroll: Union[str, int, None, Dict] = "auto"
    threads: Optional[int] = None
    func_name: str = "nncg_net"
    fusion: Optional[bool] = None
    pipeline_stages: int = 1

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r}; expected one of {_PRECISIONS}")
        if self.tune_iters < 1:
            raise ValueError(f"tune_iters {self.tune_iters} < 1")
        if self.pipeline_stages < 0:
            raise ValueError(
                f"pipeline_stages {self.pipeline_stages} < 0 "
                f"(0 = auto, 1 = single stage, k = k stages)")
        if self.device is not None:
            dev = torch.device(self.device)  # raises on a malformed string
            if self.backend == "c" and dev.type != "cpu":
                raise ValueError(
                    f"backend 'c' runs the generated C on the host: device "
                    f"must be None or 'cpu', not {self.device!r}")
        object.__setattr__(self, "calibration",
                           _coerce_calibration(self.calibration))
        object.__setattr__(self, "lm", _coerce_lm(self.lm))
        if self.simd_search is not None:
            object.__setattr__(self, "simd_search",
                               tuple(self.simd_search))

    def replace(self, **changes) -> "SessionConfig":
        """A copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    def portable(self) -> "SessionConfig":
        """The serializable projection of this config: the calibration
        data and imported qparams dropped, and a live
        :class:`~repro_torch.engine.autotune.TuningCache` (or a path
        object) replaced by its path string.  ``SessionConfig(**cfg.to_dict())`` equals
        ``cfg.portable()``."""
        changes: Dict[str, Any] = {}
        if (self.calibration.data is not None
                or self.calibration.qparams is not None):
            changes["calibration"] = dataclasses.replace(
                self.calibration, data=None, qparams=None)
        tc = self.tune_cache
        if tc is not None and not isinstance(tc, str):  # a cache or a Path
            changes["tune_cache"] = str(getattr(tc, "path", tc))
        return self.replace(**changes) if changes else self

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict; ``SessionConfig(**d)`` reconstructs
        :meth:`portable`."""
        p = self.portable()
        d = dataclasses.asdict(p)
        d["calibration"] = p.calibration.to_dict()
        d["lm"] = None if p.lm is None else p.lm.to_dict()
        if d["simd_search"] is not None:
            d["simd_search"] = list(d["simd_search"])
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SessionConfig":
        return cls(**d)
