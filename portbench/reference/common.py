"""Plain float32 layers that the reference families share.

Conventions of the configurations as run (their files' ``as_run`` and
``departures``): RMSNorm scales by ``1 + w``; RoPE rotates the split
halves of each head with frequencies ``theta ** (-i / half)``; the
embedding rows are scaled by ``sqrt(d_model)`` rounded to the model's
type; gelu is the tanh approximation; the output head is the float32
product of the final norm's output and the head's weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def fp8(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``a`` rounded through float8 e4m3, one scale (amax / 448) for each
    slice along ``dim``, back in float32."""
    scale = a.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (a / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in float32; with ``quant`` the inputs
    are rounded per row and the weights per output column."""
    w = w.float()
    if quant is not None:
        x, w = quant(x, -1), quant(w, 0)
    return x @ w


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def act(name: str):
    return {"silu": F.silu,
            "gelu": lambda a: F.gelu(a, approximate="tanh")}[name]


def gated_mlp(x, p, act_name: str, quant=None):
    h = act(act_name)(linear(x, p["wg"], quant))
    if "wu" in p:
        h = h * linear(x, p["wu"], quant)
    return linear(h, p["wd"], quant)


def rope(x, theta: float):
    """x (B, S, H, D) rotated at positions 0 .. S - 1 (split halves)."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * freqs)[None, :, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q, k, v):
    """q (B, S, H, D), k and v (B, S, Hkv, D) -> (B, S, H, D): softmax
    of the scaled scores over the keys at or before each query, one
    sequence at a time."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].transpose(0, 1)                              # (H, S, D)
        ki = k[i].repeat_interleave(rep, 1).transpose(0, 1)
        vi = v[i].repeat_interleave(rep, 1).transpose(0, 1)
        scores = (qi @ ki.transpose(1, 2)) * d ** -0.5
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        out[i] = (probs @ vi).transpose(0, 1)
    return out


def attention(x, p, cfg, quant=None):
    """A full causal attention block's mixer (no norm, no residual)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = linear(x, p["wq"], quant)
    k = linear(x, p["wk"], quant)
    v = linear(x, p["wv"], quant)
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    q = rope(q.reshape(b, s, h, dh), cfg["rope_theta"])
    k = rope(k.reshape(b, s, hkv, dh), cfg["rope_theta"])
    o = causal_attention(q, k, v.reshape(b, s, hkv, dh))
    return linear(o.reshape(b, s, h * dh), p["wo"], quant)


def embed(params, cfg, seq):
    scale = torch.tensor(math.sqrt(cfg["d_model"]),
                         dtype=DTYPES[cfg["dtype"]]).item()
    return params["embed"][seq].float() * scale


def unembed(params, cfg, x, quant=None):
    x = rms_norm(x, params["final_norm"], cfg["norm_eps"])
    head = params["embed"].T if cfg["tie_embeddings"] else params["head"]
    return linear(x, head, quant)


def blocks(params, cfg):
    """``(kind, params)`` of every block in the order it runs: the
    prologue, then each group of the pattern, with the group-stacked
    leaves cut to that group and ``S`` blocks on the shared weights."""
    def cut(tree, g):
        if isinstance(tree, dict):
            return {k: cut(v, g) for k, v in tree.items()}
        return tree[g]

    pattern, prologue = cfg["pattern"], cfg["prologue"]
    out = [(kind, params["shared"] if kind == "S" else params["prologue"][i])
           for i, kind in enumerate(prologue)]
    for g in range((cfg["n_layers"] - len(prologue)) // len(pattern)):
        out += [(kind, params["shared"] if kind == "S"
                 else cut(params["groups"][i], g))
                for i, kind in enumerate(pattern)]
    return out


def forward(params, cfg, seq, first: int, *, mixers, mlp, quant=None):
    """Logits (B, S - first, V) at positions ``first ..`` of ``seq``
    (B, S): each block in turn over the whole sequence.  ``mixers`` maps
    a block kind to its mixer ``f(x, p, cfg, quant)``; ``mlp(x, p, kind,
    quant)`` is the MLP after an attention block's mixer."""
    x = embed(params, cfg, seq)
    eps = cfg["norm_eps"]
    for kind, p in blocks(params, cfg):
        if kind in ("A", "S"):
            x = x + attention(rms_norm(x, p["ln1"], eps), p["attn"], cfg,
                              quant)
            x = x + mlp(rms_norm(x, p["ln2"], eps), p["mlp"], kind, quant)
        elif kind in mixers:
            x = x + mixers[kind](rms_norm(x, p["ln1"], eps), p, cfg, quant)
        else:
            raise ValueError(f"the reference has no block {kind!r}")
    return unembed(params, cfg, x[:, first:], quant)
