"""The port's inference engine: CNN sessions over the ``"cuda"``
(hand-written kernels), ``"torch"`` (plain eager; at ``precision="int8"``
the int8 reference) and ``"c"`` (the paper's generated ANSI C on the
host, fp32 and int8) backends, and LM sessions over ``"cuda-lm"``;
:mod:`.autotune` times and caches the C code versions and the LM kernel
variants."""
from .autotune import (Autotuner, LMTuneResult, TuneResult, TuningCache,
                       cc_fingerprint, device_digest, graph_fingerprint,
                       lm_fingerprint, tune_best_simd, tune_lm_variants)
from .backends import (Backend, CBackend, CudaBackend, CudaLMBackend,
                       KVCacheHandle, LMBackend, QuantizedTorchBackend,
                       TorchBackend, available_backends, get_backend,
                       register_backend)
from .config import CalibrationConfig, LMConfig, SessionConfig
from .lm import LMSession
from .session import InferenceSession

__all__ = [
    "Autotuner",
    "Backend",
    "CBackend",
    "CalibrationConfig",
    "CudaBackend",
    "CudaLMBackend",
    "InferenceSession",
    "KVCacheHandle",
    "LMBackend",
    "LMConfig",
    "LMSession",
    "LMTuneResult",
    "QuantizedTorchBackend",
    "SessionConfig",
    "TorchBackend",
    "TuneResult",
    "TuningCache",
    "available_backends",
    "cc_fingerprint",
    "device_digest",
    "get_backend",
    "graph_fingerprint",
    "lm_fingerprint",
    "register_backend",
    "tune_best_simd",
    "tune_lm_variants",
]
