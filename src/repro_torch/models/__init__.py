"""The LM stack in PyTorch: configs, kernel policy, layers, RWKV6, the
layer stack and the LM-level prefill/decode API."""
from .config import ModelConfig
from .kernel_policy import DEFAULT_KERNELS, PLAIN_KERNELS, KernelPolicy
from .lm import (forward, from_jax_params, make_decode_step,
                 make_prefill_step, param_count)
from .stack import apply_stack, init_cache, init_params

__all__ = [
    "DEFAULT_KERNELS",
    "KernelPolicy",
    "ModelConfig",
    "PLAIN_KERNELS",
    "apply_stack",
    "forward",
    "from_jax_params",
    "init_cache",
    "init_params",
    "make_decode_step",
    "make_prefill_step",
    "param_count",
]
