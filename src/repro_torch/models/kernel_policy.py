"""Which attention and scan kernel the LM stack's prefill and training
run (the port's copy of the JAX package's ``models/kernel_policy.py``).

:class:`KernelPolicy` is that selection as a value, passed to the model
code (``forward``, ``loss_fn``, ``apply_stack``, the train, prefill and
decode steps).  Its fields are the JAX package's, in its order, so a JAX
``KernelPolicy`` round-trips (``KernelPolicy(*jax_policy)``):

* ``attention`` — ``"flash_pallas"``, the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`: the hand-written CUDA
  kernel on the card, its plain version on the CPU); ``"reference"``,
  the dense masked softmax (:func:`repro_torch.kernels.ref.attention_ref`);
  ``"flash_jax"``, the blockwise attention with a hand-written backward
  (:mod:`repro_torch.models.attention_vjp`: ``flash_mha``, or
  ``local_mha`` for sliding-window layers), the one to train through.
* ``scan`` — the RWKV6 recurrence: ``"linear_scan"``, the scan kernel
  (:mod:`repro_torch.kernels.linear_scan`), or ``"chunked"``, the plain
  step loop (under autograd, checkpointed chunks of steps).
* ``block_q`` / ``block_k`` — the tiles of ``"flash_jax"``.  As in the
  reference they are not fitted: ``T`` must be a multiple of
  ``min(block_q, T)``.  The CUDA kernels' tiles are fixed and masked at
  the ragged edge, so ``"flash_pallas"`` ignores them.

The CUDA kernels have no backward and raise under autograd
(:func:`repro_torch.kernels.build.check_no_grad`), so training takes
:data:`TRAIN_KERNELS`, ``("flash_jax", "chunked")``: the JAX package's
``DEFAULT_KERNELS``, which its training path runs.  Serving takes the
port's default, the kernels: ``("flash_pallas", "linear_scan")``.

In bf16, ``"reference"`` is not quite the JAX package's function.  The
JAX ``attention_ref`` forms q·kᵀ as a bf16 einsum, so its logits are
rounded to bf16 before ``* scale``; the port's keeps them in fp32, since
it is also the plain version the CUDA kernels are held to (their scores
are fp32 sums of exact products).  The two policies agree within the
bf16 tolerance of 3e-2 (``tests/test_torch_lm_model.py`` pins the gap
on a bf16 ``.smoke()`` config); in fp32 they are the same function.

Decode (T == 1) runs the plain RWKV step.  Its attention takes the
decode-attention kernel (:mod:`repro_torch.kernels.decode_attention`)
under ``"flash_pallas"`` where the caches are bf16 on the card and the
scores are whole; everywhere else (the CPU, fp32 caches, the other two
policies, the head-dim split's partial scores) the plain
:func:`repro_torch.kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

from typing import NamedTuple

ATTENTION_VARIANTS = ("flash_jax", "flash_pallas", "reference")
SCAN_VARIANTS = ("chunked", "linear_scan")


class KernelPolicy(NamedTuple):
    attention: str = "flash_pallas"
    scan: str = "linear_scan"
    block_q: int = 512
    block_k: int = 512

    def validate(self) -> "KernelPolicy":
        if self.attention not in ATTENTION_VARIANTS:
            raise ValueError(
                f"attention variant {self.attention!r}; expected one of "
                f"{ATTENTION_VARIANTS}")
        if self.scan not in SCAN_VARIANTS:
            raise ValueError(
                f"scan variant {self.scan!r}; expected one of "
                f"{SCAN_VARIANTS}")
        if self.block_q < 1 or self.block_k < 1:
            raise ValueError(
                f"flash blocks ({self.block_q}, {self.block_k}) must be >= 1")
        return self


DEFAULT_KERNELS = KernelPolicy()
PLAIN_KERNELS = KernelPolicy(attention="reference", scan="chunked")
TRAIN_KERNELS = KernelPolicy(attention="flash_jax", scan="chunked")


def fit_block(n: int, block: int) -> int:
    """Largest divisor of ``n`` that is <= ``block`` (>= 1)."""
    b = max(1, min(int(block), int(n)))
    while n % b:
        b -= 1
    return b
