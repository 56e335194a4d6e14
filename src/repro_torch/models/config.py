"""Model configuration for the 10 LM-family architectures (the port's own
copy of the JAX package's ``models/config.py``; pure Python)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 => attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # layer pattern: one char per layer in the repeating group.
    #   A = global (full) attention block      L = local (sliding-window)
    #   M = Mamba2 block                       R = RWKV6 block
    #   S = *shared* attention block (Zamba2-style: same weights each use)
    pattern: str = "A"
    prologue: str = ""             # unscanned blocks before the groups
    window: Optional[int] = None   # SWA width for 'L' layers
    causal: bool = True            # False => encoder-only (no decode path)
    qkv_bias: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None  # routed-expert hidden (deepseek fine-grained)
    capacity_factor: float = 1.25   # MoE token capacity per expert

    # SSM / RWKV
    ssm_state: int = 0
    ssm_head_dim: int = 64
    conv_kernel: int = 4

    # embeddings / misc
    rope_theta: float = 1e4
    rope_dim: Optional[int] = None  # original rotary dim when head_dim is
                                    # lane-padded (align.py); None = head_dim
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    embed_inputs: bool = True      # False => frontend stub feeds embeddings
    tie_embeddings: bool = False
    act: str = "silu"
    mlp_gated: bool = True         # False => plain 2-matrix MLP (hubert)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # training-time policies (the paper's P1 knob, TPU reading)
    scan_layers: bool = True       # scan over the repeating group (no unroll)
    remat: str = "full"            # 'none' | 'full'
    grad_accum: int = 1            # microbatches per optimizer step

    def __post_init__(self):
        if self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.head_dim or self.d_model // self.n_heads)
        assert (self.n_layers - len(self.prologue)) % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} minus prologue not a "
            f"multiple of pattern {self.pattern!r}")

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.prologue)) // len(self.pattern)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attn_free(self) -> bool:
        return all(c in "MR" for c in self.pattern + self.prologue)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve 500k context (SSM/hybrid/SWA)."""
        return all(c in "MRLS" or (c == "A" and False) for c in self.pattern) \
            or self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        pat_len = len(self.pattern)
        return replace(
            self,
            name=self.name + "-smoke",
            prologue=self.prologue[:1],
            n_layers=len(self.prologue[:1]) + pat_len * (1 if pat_len > 2
                                                         else 2),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else None,
            d_ff=128,
            moe_d_ff=32 if self.moe_d_ff else None,
            vocab_size=256,
            window=min(self.window, 8) if self.window else None,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=float(max(self.n_experts, 1)),  # dropless in smoke
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            grad_accum=1,
            dtype="float32",
            remat="none",
        )
