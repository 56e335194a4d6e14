"""Core LM building blocks in PyTorch (the port of the JAX package's
``models/layers.py``).

Layout conventions, as in the JAX package:
  activations  (B, T, D)          heads (B, T, H, Dh)
  attn weights (D, H*Dh) etc.     all params live in plain dicts

Conventions kept from the reference: ``rms_norm`` scales by
``1 + scale`` with eps 1e-6; ``layer_norm`` and ``group_norm_heads`` use
eps 1e-5; every norm computes in fp32 and returns the input's type;
``rope`` rotates split halves (not interleaved pairs) and honours
``rope_dim``; gelu is the tanh approximation.  Training attention (the
JAX package's blockwise XLA attention with its custom VJPs) is
:mod:`repro_torch.models.attention_vjp`; prefill attention goes through
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ref import NEG_INF


# ------------------------------------------------------------------ norms ----

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def group_norm_heads(x, scale, eps: float = 1e-5):
    """Per-head LayerNorm (RWKV6 wkv output norm). x: (..., H, N)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ------------------------------------------------------------------- rope ----

def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the split halves of x (B,T,H,Dh) by angles (B,T,Dh/2)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
         rope_dim: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding; x (B, T, H, Dh), positions (B, T) int.
    ``rope_dim``: the original head_dim when Dh has been padded — keeps
    the frequency ladder of the unpadded model."""
    half = x.shape[-1] // 2
    base_half = (rope_dim or x.shape[-1]) // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / base_half)
    return _rotate(x, positions.float()[..., None] * freqs)


def section_ids(sections: Tuple[int, int, int], device) -> torch.Tensor:
    """The M-RoPE section (0, 1, 2) of each of the ``sum(sections)``
    frequencies, built on the device from Python ints: no host copy and
    no size the host must wait for, so a decode step that runs it can be
    captured in a CUDA graph."""
    ar = torch.arange(sum(sections), device=device)
    return (ar >= sections[0]).long() + (ar >= sections[0] + sections[1]
                                         ).long()


def mrope(x: torch.Tensor, positions3: torch.Tensor,
          sections: Tuple[int, int, int], theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: head_dim/2 freqs split into (t, h, w)
    sections, each rotated by its own position stream.
    x (B,T,H,Dh); positions3 (3,B,T)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = positions3.float()[section_ids(sections, x.device)]  # (half,B,T)
    return _rotate(x, pos.permute(1, 2, 0) * freqs)


# ------------------------------------------------------------------ linear ----

def linear(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def gated_mlp(x, p, act: str = "silu"):
    h = act_fn(act)(linear(x, p["wg"]))
    if "wu" in p:
        h = h * linear(x, p["wu"])
    return linear(h, p["wd"])


# -------------------------------------------------------------- attention ----

def decode_attention(q, k_cache, v_cache, pos, *, window=None,
                     ring: bool = False, scale=None, scores=None):
    """One-token attention against a cache (plain torch; the JAX
    package's ``decode_attention_jax``).

    q (B,1,H,Dh); k_cache/v_cache (B,S,Hkv,Dh); pos the position of the
    new token, a Python int or a 0-d integer tensor on q's device (the
    mask is then built on the device); the cache already holds the new
    token at its slot.  ``ring=True``
    means the cache is a rolling buffer of S slots, slot s holding
    position ``pos - ((pos - s) mod S)``.  ``scores``, if given, takes
    the raw fp32 scores (B, Hkv, G, S) before the scale and the mask: a
    rank holding a slice of the head dim passes the sum over ``model``
    of its partial scores (and ``scale`` of the whole head dim)."""
    b, s, hkv, dh = k_cache.shape
    h = q.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    qh = q.reshape(b, hkv, h // hkv, dh).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qh, k_cache.float())
    if scores is not None:
        logits = scores(logits)
    logits = logits * scale
    slots = torch.arange(s, device=q.device)
    slot_pos = pos - torch.remainder(pos - slots, s) if ring else slots
    mask = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        mask &= (pos - slot_pos) < window
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1).masked_fill(~mask, 0.0)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, dh).to(q.dtype)


# ------------------------------------------------------------------- init ----

class ParamInit:
    """Makes parameters with the JAX package's shapes and scales from a
    ``torch.Generator``: ``normal`` draws N(0, 1) * fan_in ** -0.5 in fp32
    and stores it in the given type.  Every shape gets the ``lead``
    prefix (the group axis of stacked parameters), and a stacked tensor is
    drawn one leading slice at a time, so the fp32 draw never holds more
    than one group.  On the ``meta`` device nothing is drawn: the shapes
    alone (for counting parameters)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None,
                 lead: Tuple[int, ...] = ()):
        self.device = torch.device(device)
        self.generator = generator
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "ParamInit":
        return ParamInit(self.device, self.generator, self.lead + (n,))

    def _draw(self, shape, dtype, draw) -> torch.Tensor:
        out = torch.empty(self.lead + tuple(shape), dtype=dtype,
                          device=self.device)
        if self.device.type == "meta":
            return out
        for part in (out.unbind(0) if self.lead else (out,)):
            part.copy_(draw(part.shape))
        return out

    def normal(self, shape, fan_in: int, dtype) -> torch.Tensor:
        return self._draw(shape, dtype, lambda s: torch.randn(
            s, generator=self.generator, dtype=torch.float32,
            device=self.device) * fan_in ** -0.5)

    def uniform(self, shape, low: float, high: float) -> torch.Tensor:
        """U(low, high) in fp32."""
        return self._draw(shape, torch.float32, lambda s: torch.empty(
            s, dtype=torch.float32, device=self.device).uniform_(
                low, high, generator=self.generator))

    def full(self, shape, value: float,
             dtype=torch.float32) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)
