"""The LM stack in PyTorch: configs, kernel policy, layers, the
mixture-of-experts MLP, Mamba2 and RWKV6, head-dim alignment, the layer
stack, the flash backward and the LM-level API (forward, loss, train /
eval / prefill / decode steps)."""
from .align import pad_head_dim
from .attention_vjp import flash_mha, local_mha
from .config import ModelConfig
from .kernel_policy import (DEFAULT_KERNELS, PLAIN_KERNELS, TRAIN_KERNELS,
                            KernelPolicy, fit_block)
from .lm import (active_param_count, forward, from_jax_params,
                 from_jax_train_state, loss_fn, make_decode_step,
                 make_eval_step, make_prefill_step, make_train_step,
                 param_count)
from .stack import apply_stack, init_cache, init_params

__all__ = [
    "DEFAULT_KERNELS",
    "KernelPolicy",
    "ModelConfig",
    "PLAIN_KERNELS",
    "TRAIN_KERNELS",
    "active_param_count",
    "apply_stack",
    "fit_block",
    "flash_mha",
    "forward",
    "from_jax_params",
    "from_jax_train_state",
    "init_cache",
    "init_params",
    "local_mha",
    "loss_fn",
    "make_decode_step",
    "make_eval_step",
    "make_prefill_step",
    "make_train_step",
    "pad_head_dim",
    "param_count",
]
