"""The port's inference engine: CNN sessions over the ``"cuda"``
(hand-written kernels) and ``"torch"`` (plain eager) backends, and LM
sessions over ``"cuda-lm"``."""
from .backends import (Backend, CudaBackend, CudaLMBackend, KVCacheHandle,
                       LMBackend, TorchBackend, available_backends,
                       get_backend, register_backend)
from .config import LMConfig, SessionConfig
from .lm import LMSession
from .session import InferenceSession

__all__ = [
    "Backend",
    "CudaBackend",
    "CudaLMBackend",
    "InferenceSession",
    "KVCacheHandle",
    "LMBackend",
    "LMConfig",
    "LMSession",
    "SessionConfig",
    "TorchBackend",
    "available_backends",
    "get_backend",
    "register_backend",
]
