"""Operations and bytes from shapes alone, for a configuration file's
``as_run`` group: the model FLOPs of the tokens a call processes, and
the flash attention's operations and bytes (as ``chip_smoke.py``'s
``lm_time`` lines count them).

Model FLOPs count two a multiply-add of every matrix product a token
needs (for a mixture of experts: the router, its top-k experts and the
shared experts; not the capacity buffer's padding), the attention's
scores and weighted sum against the keys at or before the token, the
Mamba2 recurrence in its one-step form (5 N P a head: decay, the
rank-one update, the read-out), and the output head for each position
whose logits the call returns.  Element-wise work is left out.
"""
from __future__ import annotations


def _kinds(cfg) -> str:
    groups = (cfg["n_layers"] - len(cfg["prologue"])) // len(cfg["pattern"])
    return cfg["prologue"] + cfg["pattern"] * groups


def attention_layers(cfg) -> int:
    return sum(k in "ALS" for k in _kinds(cfg))


def _linear_flops(cfg, kind: str) -> int:
    """FLOPs of one token's matrix products in one block of ``kind``."""
    d = cfg["d_model"]
    if kind in "ALS":
        h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        attn = 2 * d * h * dh + 4 * d * hkv * dh + 2 * h * dh * d
        if cfg["n_experts"] and kind != "S":
            fe = cfg["moe_d_ff"] or cfg["d_ff"]
            mlp = (2 * d * cfg["n_experts"] + 6 * d * fe * cfg["top_k"]
                   + 6 * d * fe * cfg["n_shared_experts"])
        else:
            mlp = (6 if cfg["mlp_gated"] else 4) * d * cfg["d_ff"]
        return attn + mlp
    if kind == "M":
        di, n, p = 2 * d, cfg["ssm_state"], cfg["ssm_head_dim"]
        h = di // p
        return (4 * d * di + 2 * cfg["conv_kernel"] * di
                + 2 * di * (2 * n + h) + 5 * n * p * h + 2 * di * d)
    raise ValueError(f"no FLOP count for block {kind!r}")


def call_flops(cfg, batch: int, start: int, stop: int) -> int:
    """Model FLOPs of a call that runs positions ``start .. stop - 1`` of
    ``batch`` sequences (earlier positions cached) and returns one row of
    logits a sequence."""
    kinds = _kinds(cfg)
    per_token = sum(_linear_flops(cfg, k) for k in kinds)
    keys = (stop * (stop + 1) - start * (start + 1)) // 2  # sum of pos + 1
    attn = 4 * cfg["n_heads"] * cfg["head_dim"] * attention_layers(cfg)
    head = 2 * cfg["d_model"] * cfg["vocab_size"]
    return batch * (per_token * (stop - start) + attn * keys + head)


def flash_ops(b: int, hq: int, t: int, d: int) -> int:
    """A causal (B, Hq, T, D) flash layer: 4 B Hq D a (query, key) pair
    at or below the diagonal."""
    return 4 * b * hq * d * (t * (t + 1) // 2)


def flash_bytes(b: int, hq: int, hkv: int, t: int, d: int,
                itemsize: int = 2) -> int:
    """q and o (B, Hq, T, D), k and v (B, Hkv, T, D), each read or
    written once."""
    return (2 * b * hq * t * d + 2 * b * hkv * t * d) * itemsize


def flash_bound_s(cfg, b: int, t: int, peaks: dict) -> float:
    """The least time of one prefill's attention layers on the card:
    per layer the larger of operations over the bf16 rate and bytes
    over the memory bandwidth."""
    h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    one = max(flash_ops(b, h, t, dh) / peaks["bf16_flops"],
              flash_bytes(b, h, hkv, t, dh) / peaks["hbm_bytes_per_s"])
    return one * attention_layers(cfg)

