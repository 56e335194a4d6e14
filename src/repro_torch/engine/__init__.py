"""The port's inference engine: sessions over the ``"cuda"`` (hand-written
kernels) and ``"torch"`` (plain eager) backends."""
from .backends import (Backend, CudaBackend, TorchBackend,
                       available_backends, get_backend, register_backend)
from .config import SessionConfig
from .session import InferenceSession

__all__ = [
    "Backend",
    "CudaBackend",
    "InferenceSession",
    "SessionConfig",
    "TorchBackend",
    "available_backends",
    "get_backend",
    "register_backend",
]
