"""The port's inference engine: CNN sessions over the ``"cuda"``
(hand-written kernels) and ``"torch"`` (plain eager; at
``precision="int8"`` the int8 reference) backends, and LM sessions over
``"cuda-lm"``."""
from .backends import (Backend, CudaBackend, CudaLMBackend, KVCacheHandle,
                       LMBackend, QuantizedTorchBackend, TorchBackend,
                       available_backends, get_backend, register_backend)
from .config import CalibrationConfig, LMConfig, SessionConfig
from .lm import LMSession
from .session import InferenceSession

__all__ = [
    "Backend",
    "CalibrationConfig",
    "CudaBackend",
    "CudaLMBackend",
    "InferenceSession",
    "KVCacheHandle",
    "LMBackend",
    "LMConfig",
    "LMSession",
    "QuantizedTorchBackend",
    "SessionConfig",
    "TorchBackend",
    "available_backends",
    "get_backend",
    "register_backend",
]
