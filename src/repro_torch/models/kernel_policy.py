"""Which attention and scan kernel the LM stack's prefill runs (the port's
copy of the JAX package's ``models/kernel_policy.py``).

:class:`KernelPolicy` is that selection as a value, passed to the model
code (``forward``, ``apply_stack``, the prefill and decode steps).  The
variant names are the JAX package's, so an ``LMConfig`` round-trips
between the two packages:

* ``attention`` — ``"flash_pallas"``, the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`: the hand-written CUDA
  kernel on the card, its plain version on the CPU); ``"reference"``,
  the dense masked softmax (:func:`repro_torch.kernels.ref.attention_ref`);
  ``"flash_jax"``, the JAX package's blockwise XLA path with its custom
  VJP, which is not ported yet: pinning it raises ``NotImplementedError``
  (ROADMAP.md Queue 1, item 8: ``attention_vjp.py``, the training
  slice).
* ``scan`` — the RWKV6 recurrence: ``"linear_scan"``, the scan kernel
  (:mod:`repro_torch.kernels.linear_scan`), or ``"chunked"``, the plain
  step-by-step loop.

In bf16, ``"reference"`` is not quite the JAX package's function.  The
JAX ``attention_ref`` forms q·kᵀ as a bf16 einsum, so its logits are
rounded to bf16 before ``* scale``; the port's keeps them in fp32, since
it is also the plain version the CUDA kernels are held to (their scores
are fp32 sums of exact products).  The two policies agree within the
bf16 tolerance of 3e-2 (``tests/test_torch_lm_model.py`` pins the gap
on a bf16 ``.smoke()`` config); in fp32 they are the same function.

The port's default is the kernels: ``("flash_pallas", "linear_scan")``.
Decode (T == 1) always runs the plain
:func:`repro_torch.models.layers.decode_attention` and the plain RWKV
step.
"""
from __future__ import annotations

from typing import NamedTuple

ATTENTION_VARIANTS = ("flash_jax", "flash_pallas", "reference")
SCAN_VARIANTS = ("chunked", "linear_scan")


class KernelPolicy(NamedTuple):
    attention: str = "flash_pallas"
    scan: str = "linear_scan"

    def validate(self) -> "KernelPolicy":
        if self.attention not in ATTENTION_VARIANTS:
            raise ValueError(
                f"attention variant {self.attention!r}; expected one of "
                f"{ATTENTION_VARIANTS}")
        if self.attention == "flash_jax":
            raise NotImplementedError(
                "attention='flash_jax' (the blockwise attention with a "
                "custom VJP, attention_vjp.py) is not ported yet: "
                "ROADMAP.md Queue 1, item 8, the training slice")
        if self.scan not in SCAN_VARIANTS:
            raise ValueError(
                f"scan variant {self.scan!r}; expected one of "
                f"{SCAN_VARIANTS}")
        return self


DEFAULT_KERNELS = KernelPolicy()
PLAIN_KERNELS = KernelPolicy(attention="reference", scan="chunked")
