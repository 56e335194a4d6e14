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

The ``par`` argument is the reference's parallelism context: ``None``
(:data:`DEFAULT_PAR`) is the single-device no-op, and
:class:`repro_torch.launch.sharding.MeshPar` overrides the hooks of
:class:`~repro_torch.models.par.Par` to run the MoE and Ulysses attention
across a mesh and the dense layers tensor-parallel over ``model``: each
block reads its local head counts from its weights' shapes, so the same
code runs whole and on a rank's blocks.  Between the blocks the residual
stream is in the ``par``'s layout (with sequence parallelism, this
rank's chunk of T), and each block reads the whole sequence through its
entry hook.  The model code imports no mesh machinery.
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
    gated_mlp,
    layer_norm,
    linear,
    mrope,
    rms_norm,
    rope,
)
from .par import DEFAULT_PAR, Par  # noqa: F401  (re-exported)
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

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cpu",
               par: Optional[Par] = None):
    """Decode caches: {'pro': one per prologue block, 'grp': one per
    pattern position, stacked over groups}.  Attention blocks hold
    {'k', 'v'} of (B, S, Hkv, Dh), S = max_len, or min(window, max_len)
    slots of a ring for ``L`` blocks; ``M`` blocks a :class:`MambaState`,
    ``R`` blocks an :class:`RWKVState`.  With a ``par`` whose layers run
    split over ``model``, this rank's block: the heads (and Mamba2's
    conv channels) divided by :meth:`Par.cache_split`, or, where the
    attention is ``"head_dim"``, the head dim of ``k`` / ``v`` (this
    rank's contiguous slice of Dh, the reference's ``cache_specs``)."""
    par = par or DEFAULT_PAR
    return {"pro": [_position_cache(cfg, k, batch, max_len, (), device, par)
                    for k in cfg.prologue],
            "grp": [_position_cache(cfg, k, batch, max_len,
                                    (cfg.n_groups,), device, par)
                    for k in cfg.pattern]}


def _position_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    lead, device, par: Par):
    def zeros(*shape, dtype=dtype_of(cfg)):
        return torch.zeros(tuple(lead) + shape, dtype=dtype, device=device)

    if kind in ("A", "S", "L"):
        s = min(cfg.window, max_len) if kind == "L" else max_len
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        if par.dense_split("attn") == "head_dim":
            dh //= par.cache_split("attn")
        else:
            hkv //= par.cache_split("attn")
        return {"k": zeros(batch, s, hkv, dh), "v": zeros(batch, s, hkv, dh)}
    if kind == "M":
        d_inner = 2 * cfg.d_model // par.cache_split("mamba")
        return MambaState(
            ssm=zeros(batch, d_inner // cfg.ssm_head_dim, cfg.ssm_state,
                      cfg.ssm_head_dim, dtype=torch.float32),
            conv=zeros(batch, cfg.conv_kernel - 1, d_inner))
    if kind == "R":
        n = cfg.ssm_head_dim
        h = cfg.d_model // n // par.cache_split("rwkv")
        return RWKVState(wkv=zeros(batch, h, n, n, dtype=torch.float32),
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
                       pol: KernelPolicy, q_start: int = 0):
    """Prefill / train attention over the policy's variant axis.  q/k/v
    are (B, T, H, Dh), as ``"flash_jax"`` takes them; the kernel and the
    dense reference speak (B, H, T, Dh), so they get transposed views (no
    copy: the CUDA kernel takes strides).  q's row i is at position
    ``q_start + i`` (this rank's rows of a sequence whose k and v are
    whole)."""
    window = cfg.window if kind == "L" and cfg.window is not None else None
    if pol.attention == "flash_jax":
        if window is not None:
            return local_mha(q, k, v, window, None, min(pol.block_q, 256),
                             q_start)
        return flash_mha(q, k, v, cfg.causal, None, None, pol.block_q,
                         pol.block_k, q_start)
    fn = (ops.flash_attention if pol.attention == "flash_pallas"
          else ref.attention_ref)  # a validated policy: "reference"
    o = fn(*(a.transpose(1, 2) for a in (q, k, v)), causal=cfg.causal,
           window=window, q_start=q_start)
    return o.transpose(1, 2)


def _decode_attention(q, k_cache, v_cache, pos, pol: KernelPolicy, *,
                      window, ring: bool):
    """A decode step's attention (T == 1) against this rank's caches:
    :func:`repro_torch.kernels.ops.decode_attention` (the decode-attention
    kernel on the card, its plain version on the CPU) where the policy
    takes the kernels (``"flash_pallas"``) and the caches are bf16, the
    plain :func:`~repro_torch.kernels.ref.decode_attention_ref`
    otherwise."""
    fn = (ops.decode_attention if pol.attention == "flash_pallas"
          and k_cache.dtype == torch.bfloat16 else ref.decode_attention_ref)
    return fn(q, k_cache, v_cache, pos, window=window, ring=ring)


def _write_slot(cache, k, v, pos, ring: bool):
    """A decode step's k and v (B, 1, Hkv, Dh) into their cache slot
    (``pos`` an int or a 0-d device tensor: then no sync)."""
    s = cache["k"].shape[1]
    slot = pos % s if ring else pos
    if isinstance(slot, torch.Tensor):
        cache["k"].index_copy_(1, slot.reshape(1), k)
        cache["v"].index_copy_(1, slot.reshape(1), v)
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]


def _fill_cache(cache, k, v):
    """A prefill's k and v (B, T, Hkv, Dh) into the cache: its first T
    slots, or, in a ring smaller than the prompt, the last S rolled."""
    s, t = cache["k"].shape[1], k.shape[1]
    if s >= t:
        cache["k"][:, :t] = k
        cache["v"][:, :t] = v
    else:
        cache["k"].copy_(torch.roll(k[:, -s:], t % s, dims=1))
        cache["v"].copy_(torch.roll(v[:, -s:], t % s, dims=1))


def attention_block(x, p, cfg: ModelConfig, kernels: KernelPolicy,
                    kind: str, *, positions, cache=None,
                    pos: Optional[int] = None, pos3=None,
                    par: Optional[Par] = None):
    """Train/encode (no cache), prefill (T > 1: writes the cache) and
    decode (T == 1: writes the new token's slot, reads the cache; ``pos``
    a Python int or a 0-d tensor on the device).  Without a cache a
    ``par`` that takes Ulysses attention runs it instead.  ``x`` is the
    residual stream in the ``par``'s layout (under sequence parallelism
    this rank's chunk of T); the block reads the whole sequence after
    its entry (``region_in`` / ``whole_in``), so the prefill writes the
    caches on the whole of T.

    The head counts are the weights': a ``par`` that splits the
    attention over ``model`` hands this rank's columns of ``wq`` (and of
    ``wk`` / ``wv`` under ``"heads"``) and rows of ``wo``, and the block
    runs column-parallel in and row-parallel out.  Under
    ``"q_heads_kv_whole"`` ``wk`` and ``wv`` are whole: this rank's q
    heads fall in one kv group, and it projects only that group's k and
    v, or, with a cache (which stays whole), all of them into the cache
    and attends to that group's.  Under ``"head_dim"`` a decode step
    splits the head dim (:func:`_head_dim_decode`) and prefill and
    training split the query rows (:func:`_head_dim_rows`)."""
    par = par or DEFAULT_PAR
    dh = cfg.head_dim
    if cache is None and par.ulysses_ok(cfg, par.seq_len(x)):
        return par.ulysses_attention(x, p, cfg, kind, positions)
    split = par.dense_split("attn")
    if split == "head_dim" and cache is not None and par.seq_len(x) == 1:
        return _head_dim_decode(x, p, cfg, kind, positions=positions,
                                cache=cache, pos=pos, pos3=pos3, par=par)
    if split == "head_dim":
        return _head_dim_rows(x, p, cfg, kernels, kind, positions=positions,
                              cache=cache, pos3=pos3, par=par)
    h = p["wq"].shape[-1] // dh
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    group = None  # (first, count) of the kv heads this rank attends to
    x = par.whole_in(x) if split == "whole" else par.region_in(x)
    b, t, _ = x.shape
    if split == "q_heads_kv_whole":
        g = cfg.n_heads // cfg.n_kv_heads
        group = ((par.model_rank * h) // g, max(h // g, 1))
        if cache is None:  # project that group alone
            cut = (group[0] * dh, group[1] * dh)
            wk, wv = (par.narrow(w, -1, *cut) for w in (wk, wv))
            if bk is not None:
                bk, bv = (par.narrow(a, -1, *cut) for a in (bk, bv))
            group = None
    hkv = wk.shape[-1] // dh
    q = linear(x, p["wq"], p.get("bq")).reshape(b, t, h, dh)
    k = linear(x, wk, bk).reshape(b, t, hkv, dh)
    v = linear(x, wv, bv).reshape(b, t, hkv, dh)
    q, k = _apply_rope(cfg, q, k, positions, pos3)
    q = par.constraint(q, "heads")
    k = par.constraint(k, "kv_heads")
    v = par.constraint(v, "kv_heads")

    def attended(a):  # the kv heads of this rank's q heads
        return a if group is None else a.narrow(2, *group)

    if cache is not None and t == 1:
        ring = kind == "L" and cfg.window is not None
        _write_slot(cache, k, v, pos, ring)
        o = _decode_attention(q, attended(cache["k"]), attended(cache["v"]),
                              pos, kernels,
                              window=cfg.window if kind == "L" else None,
                              ring=ring)
    else:
        if cache is not None:  # prefill: populate the cache
            _fill_cache(cache, k, v)
        o = _prefill_attention(q, attended(k), attended(v), cfg, kind,
                               kernels)
    o = par.constraint(o, "heads")
    y = linear(o.reshape(b, t, h * dh), p["wo"])
    return par.whole_out(y) if split == "whole" else par.region_out(y)


def _dh_slice(a, par: Par):
    """This rank's contiguous slice of the head dim (the last) of ``a``."""
    piece = a.shape[-1] // par.model_n
    return a.narrow(-1, par.model_rank * piece, piece)


def _head_dim_rows(x, p, cfg: ModelConfig, kernels: KernelPolicy,
                   kind: str, *, positions, cache, pos3, par: Par):
    """Prefill and training under ``"head_dim"``: the attention's leaves
    are whole (entering through ``replicated_in`` where the stream is
    split, so their gradients are summed over ``model``), and each rank
    computes every head on its own rows.  Where the stream is split
    over T, the rows are this rank's chunk of it: q, k and v projected
    and rotated there (at those rows' positions), k and v all-gathered
    over T (backward: a reduce-scatter), attention of the rows against
    the whole k and v from query position ``model_rank * T / n``, and
    ``wo`` on the rows, whose output is the stream's chunk already.
    Where it is whole, every rank runs the whole attention.  A prefill
    writes this rank's slice of the head dim of the rotated k and v."""
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    rows = par.seq_len(x) != x.shape[1]
    b, m, _ = x.shape
    q_start = par.model_rank * m if rows else 0
    if rows:
        positions = positions[:, q_start:q_start + m]
        pos3 = None if pos3 is None else pos3[..., q_start:q_start + m]
    q = linear(x, p["wq"], p.get("bq")).reshape(b, m, h, dh)
    k = linear(x, p["wk"], p.get("bk")).reshape(b, m, hkv, dh)
    v = linear(x, p["wv"], p.get("bv")).reshape(b, m, hkv, dh)
    q, k = _apply_rope(cfg, q, k, positions, pos3)
    if rows:  # one all-gather of k and v together
        k, v = par.seq_gather(torch.cat([k, v], 2)).split(hkv, 2)
    if cache is not None:
        _fill_cache(cache, _dh_slice(k, par), _dh_slice(v, par))
    o = _prefill_attention(q, k, v, cfg, kind, kernels, q_start)
    return linear(o.reshape(b, m, h * dh), p["wo"])


def _head_dim_decode(x, p, cfg: ModelConfig, kind: str, *, positions,
                     cache, pos, pos3, par: Par):
    """A decode step under ``"head_dim"`` (the reference's split): this
    rank's stored columns of ``wq`` / ``wk`` / ``wv`` (and biases) give
    its part of q, k and v, gathered whole over ``model`` in one
    all-gather (RoPE pairs element d with d + Dh/2, so a slice of the
    head dim cannot be rotated alone) and rotated; this rank's slice of
    the head dim of k and v goes into its cache, the partial scores on
    the slice are summed over ``model`` before the mask and the softmax
    (scaled by the whole head dim), p.v runs on the slice, o is gathered
    and this rank's column chunk meets its stored rows of ``wo``, the
    partial sums leaving through ``region_out``."""
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    n, r = par.model_n, par.model_rank
    x = par.region_in(x)
    b = x.shape[0]
    cols = torch.cat([linear(x, p["wq"], p.get("bq")),
                      linear(x, p["wk"], p.get("bk")),
                      linear(x, p["wv"], p.get("bv"))], -1)
    whole = par.gather_out(cols[:, :, None], 2)  # (b, 1, n, cols)
    q, k, v = (a.reshape(b, 1, heads, dh) for a, heads in zip(
        whole.split([h * dh // n, hkv * dh // n, hkv * dh // n], -1),
        (h, hkv, hkv)))
    q, k = _apply_rope(cfg, q, k, positions, pos3)
    ring = kind == "L" and cfg.window is not None
    _write_slot(cache, _dh_slice(k, par), _dh_slice(v, par), pos, ring)
    # partial scores, summed over ``model``: the kernel cannot take them
    o = ref.decode_attention_ref(
        _dh_slice(q, par), cache["k"], cache["v"], pos,
        window=cfg.window if kind == "L" else None, ring=ring,
        scale=dh ** -0.5, scores=par.model_sum)
    o = par.gather_out(o, -1).reshape(b, 1, h * dh)
    y = linear(o.narrow(-1, r * (h * dh // n), h * dh // n), p["wo"])
    return par.region_out(y)


def mlp_block(x, p, cfg: ModelConfig, kind: str, par: Optional[Par] = None):
    """The MoE MLP (``par.moe``: over the (B*T, D) tokens) in an MoE
    config's non-``S`` blocks, the dense gated MLP otherwise: with a
    ``par`` that splits it, ``wg`` / ``wu`` column-parallel over this
    rank's hidden units and ``wd`` row-parallel; whole, on the whole
    sequence (``whole_in`` / ``whole_out``)."""
    par = par or DEFAULT_PAR
    if cfg.n_experts and kind != "S":
        return par.moe(x, p, cfg)
    if par.dense_split("mlp") == "whole":
        return par.whole_out(gated_mlp(par.whole_in(x), p, cfg.act))
    return par.region_out(gated_mlp(par.region_in(x), p, cfg.act))


def apply_block(x, kind: str, p, cfg: ModelConfig,
                kernels: KernelPolicy = DEFAULT_KERNELS, *, positions,
                cache=None, pos=None, pos3=None, par: Optional[Par] = None):
    par = par or DEFAULT_PAR
    if kind in ("A", "L", "S"):
        x = x + attention_block(
            rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg, kernels, kind,
            positions=positions, cache=cache, pos=pos, pos3=pos3, par=par)
        return x + mlp_block(rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                             cfg, kind, par)
    if kind == "M":
        h, state = mamba2_mix(rms_norm(x, p["ln1"], cfg.norm_eps), p["mamba"],
                              ssm_state=cfg.ssm_state,
                              head_dim=cfg.ssm_head_dim, state=cache,
                              par=par)
        if cache is not None:
            for dst, src in zip(cache, state):
                dst.copy_(src)
        return x + h
    if kind == "R":
        h, wkv, prev_tm = rwkv6_time_mix(
            layer_norm(x, p["ln1"], p["ln1b"]), p["rwkv"],
            head_dim=cfg.ssm_head_dim, state=cache, scan=kernels.scan,
            constraint=lambda a: par.constraint(a, "ssm_heads"), par=par)
        x = x + h
        h, prev_cm = rwkv6_channel_mix(
            layer_norm(x, p["ln2"], p["ln2b"]), p["rwkv"],
            None if cache is None else cache.prev_cm, par=par)
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
                caches=None, pos=None, pos3=None, par: Optional[Par] = None):
    """Run the full layer stack, prefill attention and the RWKV scan
    through ``kernels``; ``caches`` (if given) are updated in place.
    Returns the final activations.  With ``cfg.remat == "full"`` and
    grad mode on, each block is checkpointed, as the reference
    rematerializes each block: the backward replays one block at a time,
    so the live saved tensors are one block's, not the whole stack's
    (under sequence parallelism each block's saved input is this rank's
    chunk of T)."""
    kernels.validate()
    par = par or DEFAULT_PAR
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for kind, p, c in stack_blocks(params, cfg, caches):
        x = par.constraint(x, "activations")
        if remat:
            x = checkpoint(apply_block, x, kind, p, cfg, kernels,
                           positions=positions, cache=c, pos=pos, pos3=pos3,
                           par=par, use_reentrant=False)
        else:
            x = apply_block(x, kind, p, cfg, kernels, positions=positions,
                            cache=c, pos=pos, pos3=pos3, par=par)
    return x
