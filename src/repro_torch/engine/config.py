"""Typed, frozen session configuration (the port's part of the JAX
package's ``engine/config.py``: ``SessionConfig`` and its ``lm``
sub-config ``LMConfig``).

    cfg = SessionConfig(backend="cuda")              # a CNN on cuda:0
    cfg = SessionConfig(backend="torch", device="cpu")
    cfg = SessionConfig(backend="cuda-lm",           # an LM on cuda:0
                        lm=LMConfig(arch="gemma3-4b", smoke=False))

``device=None`` means the card (``cuda:0``); a session asked for the card
on a machine without one raises ``RuntimeError``.  The C code generator's
knobs (simd, unroll, threads, tuning, fusion, pipeline stages) have no
meaning here; int8, autotuning and device meshes are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.lm_archs import ARCHS
from ..models.kernel_policy import ATTENTION_VARIANTS, SCAN_VARIANTS

_PRECISIONS = ("fp32", "int8")


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
    ``block_k`` are the TPU kernel's tiles, kept for the round trip: the
    CUDA kernel's tiles are fixed and masked at the ragged edge, so they
    change nothing in the port.
    ``mesh_shape`` is not ported yet."""

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
            raise NotImplementedError(
                "lm.mesh_shape (data-parallel prefill over a device mesh) "
                "is not ported yet: ROADMAP.md Queue 1, item 11")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce_lm(v) -> Optional[LMConfig]:
    if v is None or isinstance(v, LMConfig):
        return v
    if isinstance(v, dict):
        return LMConfig(**v)
    if isinstance(v, str):  # shorthand: lm="gemma3-4b"
        return LMConfig(arch=v)
    raise TypeError(f"lm must be an LMConfig, dict, arch name or None; "
                    f"got {type(v).__name__}")


@dataclass(frozen=True)
class SessionConfig:
    """Everything a session needs beyond the graph or the arch.

    * ``backend`` — ``"cuda"`` (the hand-written CNN kernels), ``"torch"``
      (plain eager PyTorch) or, for an LM, ``"cuda-lm"``; see
      :func:`repro_torch.engine.backends.available_backends`.
    * ``optimize`` — run the NNCG passes (BN fold, activation fusion,
      channel alignment) before building a CNN backend.
    * ``precision`` — ``"fp32"``.
    * ``device`` — a torch device string; ``None`` = ``cuda:0``.
    * ``autotune`` — not ported yet.
    * ``lm`` — the LM workload (:class:`LMConfig`), served by
      :class:`repro_torch.engine.LMSession`; ``None`` = a CNN session.
    """

    backend: str = "cuda"
    optimize: bool = True
    precision: str = "fp32"
    device: Optional[str] = None
    autotune: bool = False
    lm: Optional[LMConfig] = None

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r}; expected one of {_PRECISIONS}")
        if self.precision == "int8":
            raise NotImplementedError(
                "precision='int8' is not ported yet: ROADMAP.md Queue 1, "
                "items 3-5 (torch int8 reference, calibration, int8 session)")
        if self.autotune:
            raise NotImplementedError(
                "autotune=True is not ported yet: ROADMAP.md Queue 1, item 9 "
                "(tune_lm_variants, device_digest)")
        if self.device is not None:
            torch.device(self.device)  # raises on a malformed device string
        object.__setattr__(self, "lm", _coerce_lm(self.lm))

    def replace(self, **changes) -> "SessionConfig":
        """A copy with ``changes`` applied."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict; ``SessionConfig(**d)`` reconstructs."""
        d = dataclasses.asdict(self)
        d["lm"] = None if self.lm is None else self.lm.to_dict()
        return d
