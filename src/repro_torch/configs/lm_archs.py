"""The 10 LM-family architectures (exact published configs): the port's
own copy of the JAX package's ``configs/lm_archs.py``.

Pattern legend: A=global attention, L=sliding-window, M=Mamba2, R=RWKV6,
S=shared-weight attention block (Zamba2).
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig

def _pat(s: str) -> str:
    """gemma3 patterns are written with G for readability; G == A."""
    return s.replace("G", "A")


ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


zamba2_2p7b = _register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    grad_accum=4,
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, pattern="MMMMMS", ssm_state=64, ssm_head_dim=64,
    act="gelu",
))  # Mamba2 backbone + one shared attention block applied every 6 layers

hubert_xlarge = _register(ModelConfig(
    name="hubert-xlarge", family="audio",
    grad_accum=2,
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, pattern="A", causal=False, embed_inputs=False,
    act="gelu", mlp_gated=False,
))  # encoder-only; frame frontend is a stub (precomputed embeddings)

gemma3_4b = _register(ModelConfig(
    name="gemma3-4b", family="dense",
    grad_accum=4,
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab_size=262144, head_dim=256, pattern=_pat("LLLLLG"),
    prologue="LLLL", window=1024, act="gelu", tie_embeddings=True,
    rope_theta=1e6,
))  # 4L prologue + 5x(5L+1G) = 34L, 29:5 local:global (published 5:1)

h2o_danube3_4b = _register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    grad_accum=4,
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, head_dim=120, pattern="L", window=4096,
))  # llama+mistral mix with sliding-window attention

gemma3_27b = _register(ModelConfig(
    name="gemma3-27b", family="dense",
    grad_accum=8,
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab_size=262144, head_dim=128, pattern=_pat("LLLLLG"),
    prologue="LL", window=1024, act="gelu", tie_embeddings=True,
    rope_theta=1e6,
))  # 2L prologue + 10x(5L+1G) = 62L, 52:10 local:global (published 5:1)

qwen15_110b = _register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    grad_accum=8,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064, head_dim=128, pattern="A", qkv_bias=True,
))

deepseek_moe_16b = _register(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    grad_accum=4,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, head_dim=128, pattern="A",
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
))  # fine-grained: 64 routed (top-6) + 2 shared experts of 1408

grok1_314b = _register(ModelConfig(
    name="grok-1-314b", family="moe",
    grad_accum=8,
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, head_dim=128, pattern="A",
    n_experts=8, n_shared_experts=0, top_k=2, moe_d_ff=32768,
))

rwkv6_7b = _register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    grad_accum=4,
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=14336,
    vocab_size=65536, pattern="R", ssm_head_dim=64,
))  # Finch: attention-free, data-dependent decay

qwen2_vl_72b = _register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    grad_accum=8,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, head_dim=128, pattern="A", qkv_bias=True,
    mrope_sections=(16, 24, 24),
))  # M-RoPE backbone; vision frontend is a stub (precomputed patch embeds)


# ------------------------------------------------------------- shapes -------

SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}

# long_500k needs sub-quadratic attention over the context; pure
# full-attention archs skip it. Encoder-only archs have no
# autoregressive step at all.
_LONG_OK = {"zamba2-2.7b", "rwkv6-7b", "h2o-danube-3-4b",
            "gemma3-4b", "gemma3-27b"}


def cell_supported(arch: str, shape: str) -> bool:
    cfg = ARCHS[arch]
    kind = SHAPES[shape]["kind"]
    if cfg.is_encoder and kind == "decode":
        return False
    if shape == "long_500k" and arch not in _LONG_OK:
        return False
    return True


def all_cells():
    return [(a, s) for a in ARCHS for s in SHAPES if cell_supported(a, s)]
