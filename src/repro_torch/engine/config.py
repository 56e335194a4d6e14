"""Typed, frozen session configuration (the fp32 subset of the JAX
package's ``engine/config.py`` ``SessionConfig``).

    cfg = SessionConfig(backend="cuda")              # on cuda:0
    cfg = SessionConfig(backend="torch", device="cpu")

``device=None`` means the card (``cuda:0``); a session asked for the card
on a machine without one raises ``RuntimeError``.  The C code generator's
knobs (simd, unroll, threads, tuning, fusion, pipeline stages) have no
meaning here, and int8 is not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

_PRECISIONS = ("fp32", "int8")


@dataclass(frozen=True)
class SessionConfig:
    """Everything :class:`repro_torch.engine.InferenceSession` needs
    beyond the graph.

    * ``backend`` — ``"cuda"`` (the hand-written kernels) or ``"torch"``
      (plain eager PyTorch); see
      :func:`repro_torch.engine.backends.available_backends`.
    * ``optimize`` — run the NNCG passes (BN fold, activation fusion,
      channel alignment) before building the backend.
    * ``precision`` — ``"fp32"``.
    * ``device`` — a torch device string; ``None`` = ``cuda:0``.
    """

    backend: str = "cuda"
    optimize: bool = True
    precision: str = "fp32"
    device: Optional[str] = None

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r}; expected one of {_PRECISIONS}")
        if self.precision == "int8":
            raise NotImplementedError(
                "precision='int8' is not ported yet: ROADMAP.md Queue 1, "
                "items 3-5 (torch int8 reference, calibration, int8 session)")
        if self.device is not None:
            torch.device(self.device)  # raises on a malformed device string

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict; ``SessionConfig(**d)`` reconstructs."""
        return dataclasses.asdict(self)
