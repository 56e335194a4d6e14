"""The decoder/encoder layer stack in PyTorch (the port of the JAX
package's ``models/stack.py``).

The layer pattern (``cfg.pattern``, e.g. ``"LLLLLG"`` for gemma3) is a
repeating group.  Parameters keep the JAX package's tree: plain dicts
and lists of tensors, each group-position leaf stacked over groups with
a leading ``n_groups`` axis, so :func:`repro_torch.models.lm.from_jax_params`
carries a JAX tree across leaf by leaf.  The JAX package's scan over
groups is a Python loop here, reading one group's slice (a view) at a
time.

Blocks ``A`` (global attention), ``L`` (sliding window), ``S`` (one
shared attention block: the same weights at every use, each use with its
own cache), ``M`` (Mamba2) and ``R`` (RWKV6).  In a mixture-of-experts
config every attention block but ``S`` takes the MoE MLP over its
flattened (B*T, D) tokens; ``S`` blocks keep the dense MLP.

Decode caches are updated in place (the JAX package returns new ones):
prefill and each decode step write their keys, values and recurrent
state into the tensors of the cache dict they are given, so a step
allocates no second copy of a multi-GB cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops, ref
from .attention_vjp import flash_mha, local_mha
from .config import ModelConfig
from .kernel_policy import DEFAULT_KERNELS, KernelPolicy
from .layers import (
    ParamInit,
    decode_attention,
    gated_mlp,
    layer_norm,
    linear,
    mrope,
    rms_norm,
    rope,
)
from .moe import moe_mlp
from .ssm import (MambaState, RWKVState, init_mamba2, init_rwkv6, mamba2_mix,
                  rwkv6_channel_mix, rwkv6_time_mix)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ================================================================= init =====

def init_attn(init: ParamInit, cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {"wq": init.normal((d, h * dh), d, dt),
         "wk": init.normal((d, hkv * dh), d, dt),
         "wv": init.normal((d, hkv * dh), d, dt),
         "wo": init.normal((h * dh, d), h * dh, dt)}
    if cfg.qkv_bias:
        p.update(bq=init.full((h * dh,), 0.0), bk=init.full((hkv * dh,), 0.0),
                 bv=init.full((hkv * dh,), 0.0))
    return p


def init_mlp(init: ParamInit, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    p = {"wg": init.normal((d, f), d, dt)}
    if cfg.mlp_gated:
        p["wu"] = init.normal((d, f), d, dt)
    p["wd"] = init.normal((f, d), f, dt)
    return p


def init_moe(init: ParamInit, cfg: ModelConfig) -> dict:
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.moe_d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"router": init.normal((d, e), d, torch.float32),
         "wg": init.normal((e, d, fe), d, dt),
         "wu": init.normal((e, d, fe), d, dt),
         "wd": init.normal((e, fe, d), fe, dt)}
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p.update(shared_wg=init.normal((d, fs), d, dt),
                 shared_wu=init.normal((d, fs), d, dt),
                 shared_wd=init.normal((fs, d), fs, dt))
    return p


def init_block(init: ParamInit, kind: str, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if kind in ("A", "L", "S"):
        moe = cfg.n_experts and kind != "S"
        return {"ln1": init.full((d,), 0.0), "ln2": init.full((d,), 0.0),
                "attn": init_attn(init, cfg),
                "mlp": init_moe(init, cfg) if moe else init_mlp(init, cfg)}
    if kind == "M":
        return {"ln1": init.full((d,), 0.0),
                "mamba": init_mamba2(init, d, ssm_state=cfg.ssm_state,
                                     head_dim=cfg.ssm_head_dim,
                                     conv_kernel=cfg.conv_kernel,
                                     dtype=dtype_of(cfg))}
    if kind == "R":
        return {"ln1": init.full((d,), 1.0), "ln1b": init.full((d,), 0.0),
                "ln2": init.full((d,), 1.0), "ln2b": init.full((d,), 0.0),
                "rwkv": init_rwkv6(init, d, cfg.d_ff, dtype=dtype_of(cfg))}
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cpu") -> Dict[str, Any]:
    """Random parameters with the JAX ``init_params`` tree, shapes and
    scales, drawn from ``generator`` on ``device`` (its own numbers: a
    ``torch.Generator`` does not give ``jax.random``'s bits).  On the
    ``meta`` device: shapes only."""
    init = ParamInit(device, generator)
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = init.normal((cfg.vocab_size, cfg.d_model),
                                      cfg.d_model, dt)
    if cfg.prologue:
        params["prologue"] = [{} if kind == "S" else init_block(init, kind, cfg)
                              for kind in cfg.prologue]
    stacked = init.stacked(cfg.n_groups)
    params["groups"] = [{} if kind == "S" else init_block(stacked, kind, cfg)
                        for kind in cfg.pattern]
    if "S" in cfg.pattern:
        params["shared"] = init_block(init, "S", cfg)
    params["final_norm"] = init.full((cfg.d_model,), 0.0)
    if not cfg.tie_embeddings:
        params["head"] = init.normal((cfg.d_model, cfg.vocab_size),
                                     cfg.d_model, dt)
    return params


# ================================================================ caches =====

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu"):
    """Decode caches: {'pro': one per prologue block, 'grp': one per
    pattern position, stacked over groups}.  Attention blocks hold
    {'k', 'v'} of (B, S, Hkv, Dh), S = max_len, or min(window, max_len)
    slots of a ring for ``L`` blocks; ``M`` blocks a :class:`MambaState`,
    ``R`` blocks an :class:`RWKVState`."""
    return {"pro": [_position_cache(cfg, k, batch, max_len, (), device)
                    for k in cfg.prologue],
            "grp": [_position_cache(cfg, k, batch, max_len,
                                    (cfg.n_groups,), device)
                    for k in cfg.pattern]}


def _position_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    lead, device):
    def zeros(*shape, dtype=dtype_of(cfg)):
        return torch.zeros(tuple(lead) + shape, dtype=dtype, device=device)

    if kind in ("A", "S", "L"):
        s = min(cfg.window, max_len) if kind == "L" else max_len
        return {"k": zeros(batch, s, cfg.n_kv_heads, cfg.head_dim),
                "v": zeros(batch, s, cfg.n_kv_heads, cfg.head_dim)}
    if kind == "M":
        d_inner = 2 * cfg.d_model
        return MambaState(
            ssm=zeros(batch, d_inner // cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_head_dim, dtype=torch.float32),
            conv=zeros(batch, cfg.conv_kernel - 1, d_inner))
    if kind == "R":
        n = cfg.ssm_head_dim
        return RWKVState(wkv=zeros(batch, cfg.d_model // n, n, n,
                                   dtype=torch.float32),
                         prev_tm=zeros(batch, cfg.d_model),
                         prev_cm=zeros(batch, cfg.d_model))
    raise ValueError(kind)


def _group(tree, g: int):
    """Group ``g``'s slice (views) of a group-stacked params/cache tree."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    if isinstance(tree, (MambaState, RWKVState)):
        return type(tree)(*(t[g] for t in tree))
    return tree[g]


# =============================================================== blocks =====

def _apply_rope(cfg, q, k, positions, pos3):
    if cfg.mrope_sections is not None and pos3 is not None:
        return (mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta),
                mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta))
    return (rope(q, positions, cfg.rope_theta, cfg.rope_dim),
            rope(k, positions, cfg.rope_theta, cfg.rope_dim))


def _prefill_attention(q, k, v, cfg: ModelConfig, kind: str,
                       pol: KernelPolicy):
    """Prefill / train attention over the policy's variant axis.  q/k/v
    are (B, T, H, Dh), as ``"flash_jax"`` takes them; the kernel and the
    dense reference speak (B, H, T, Dh), so they get transposed views (no
    copy: the CUDA kernel takes strides)."""
    window = cfg.window if kind == "L" and cfg.window is not None else None
    if pol.attention == "flash_jax":
        if window is not None:
            return local_mha(q, k, v, window, None, min(pol.block_q, 256))
        return flash_mha(q, k, v, cfg.causal, None, None, pol.block_q,
                         pol.block_k)
    fn = (ops.flash_attention if pol.attention == "flash_pallas"
          else ref.attention_ref)  # a validated policy: "reference"
    o = fn(*(a.transpose(1, 2) for a in (q, k, v)), causal=cfg.causal,
           window=window)
    return o.transpose(1, 2)


def attention_block(x, p, cfg: ModelConfig, kernels: KernelPolicy,
                    kind: str, *, positions, cache=None,
                    pos: Optional[int] = None, pos3=None):
    """Train/encode (no cache), prefill (T > 1: writes the cache) and
    decode (T == 1: writes the new token's slot, reads the cache; ``pos``
    a Python int or a 0-d tensor on the device)."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(b, t, h, dh)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, t, hkv, dh)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, t, hkv, dh)
    q, k = _apply_rope(cfg, q, k, positions, pos3)

    if cache is not None and t == 1:
        s = cache["k"].shape[1]
        ring = kind == "L" and cfg.window is not None
        slot = pos % s if ring else pos
        if isinstance(slot, torch.Tensor):  # a device position: no sync
            cache["k"].index_copy_(1, slot.reshape(1), k)
            cache["v"].index_copy_(1, slot.reshape(1), v)
        else:
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"], pos,
                             window=cfg.window if kind == "L" else None,
                             ring=ring)
    else:
        if cache is not None:  # prefill: populate the cache
            s = cache["k"].shape[1]
            if s >= t:
                cache["k"][:, :t] = k
                cache["v"][:, :t] = v
            else:  # ring smaller than the prompt: the last s, rolled
                cache["k"].copy_(torch.roll(k[:, -s:], t % s, dims=1))
                cache["v"].copy_(torch.roll(v[:, -s:], t % s, dims=1))
        o = _prefill_attention(q, k, v, cfg, kind, kernels)
    return linear(o.reshape(b, t, h * dh), p["wo"])


def mlp_block(x, p, cfg: ModelConfig, kind: str):
    """The MoE MLP over the (B*T, D) tokens in an MoE config's non-``S``
    blocks, the dense gated MLP otherwise."""
    if cfg.n_experts and kind != "S":
        b, t, d = x.shape
        return moe_mlp(x.reshape(b * t, d), p, top_k=cfg.top_k, act=cfg.act,
                       capacity_factor=cfg.capacity_factor).reshape(b, t, d)
    return gated_mlp(x, p, cfg.act)


def apply_block(x, kind: str, p, cfg: ModelConfig,
                kernels: KernelPolicy = DEFAULT_KERNELS, *, positions,
                cache=None, pos=None, pos3=None):
    if kind in ("A", "L", "S"):
        x = x + attention_block(
            rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg, kernels, kind,
            positions=positions, cache=cache, pos=pos, pos3=pos3)
        return x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                             cfg, kind)
    if kind == "M":
        h, state = mamba2_mix(rms_norm(x, p["ln1"], cfg.norm_eps), p["mamba"],
                              ssm_state=cfg.ssm_state,
                              head_dim=cfg.ssm_head_dim, state=cache)
        if cache is not None:
            for dst, src in zip(cache, state):
                dst.copy_(src)
        return x + h
    if kind == "R":
        h, wkv, prev_tm = rwkv6_time_mix(
            layer_norm(x, p["ln1"], p["ln1b"]), p["rwkv"],
            head_dim=cfg.ssm_head_dim, state=cache, scan=kernels.scan)
        x = x + h
        h, prev_cm = rwkv6_channel_mix(
            layer_norm(x, p["ln2"], p["ln2b"]), p["rwkv"],
            None if cache is None else cache.prev_cm)
        if cache is not None:
            for dst, src in zip(cache, (wkv, prev_tm, prev_cm)):
                dst.copy_(src)
        return x + h
    raise ValueError(kind)


# ================================================================ stack =====

def stack_blocks(params, cfg: ModelConfig, caches=None) -> List[tuple]:
    """``(kind, params, cache)`` of every block in the order they run:
    the prologue, then each group's pattern (group-stacked leaves as
    views of that group's slice).  ``cache`` is None without caches."""
    shared = params.get("shared")
    blocks: List[tuple] = [
        (kind, shared if kind == "S" else params["prologue"][i],
         None if caches is None else caches["pro"][i])
        for i, kind in enumerate(cfg.prologue)]
    for g in range(cfg.n_groups):
        blocks += [
            (kind, shared if kind == "S" else _group(params["groups"][i], g),
             None if caches is None else _group(caches["grp"][i], g))
            for i, kind in enumerate(cfg.pattern)]
    return blocks


def apply_stack(x, params, cfg: ModelConfig,
                kernels: KernelPolicy = DEFAULT_KERNELS, *, positions,
                caches=None, pos=None, pos3=None):
    """Run the full layer stack, prefill attention and the RWKV scan
    through ``kernels``; ``caches`` (if given) are updated in place.
    Returns the final activations.  With ``cfg.remat == "full"`` and
    grad mode on, each block is checkpointed, as the reference
    rematerializes each block: the backward replays one block at a time,
    so the live saved tensors are one block's, not the whole stack's."""
    kernels.validate()
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for kind, p, c in stack_blocks(params, cfg, caches):
        if remat:
            x = checkpoint(apply_block, x, kind, p, cfg, kernels,
                           positions=positions, cache=c, pos=pos, pos3=pos3,
                           use_reentrant=False)
        else:
            x = apply_block(x, kind, p, cfg, kernels, positions=positions,
                            cache=c, pos=pos, pos3=pos3)
    return x
