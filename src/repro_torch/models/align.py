"""Head-dim alignment at LM scale (the port of the JAX package's
``models/align.py``; the paper's P4 channel padding read for attention).

:func:`pad_head_dim` zero-pads each attention head from ``head_dim`` to a
larger width, e.g. h2o-danube-3-4b's 120 to 128.  The padding is exact:
padded q/k dims add 0 to every logit (they are padded in rope-pair space,
and ``rope_dim`` keeps the unpadded model's frequency ladder), ``wq``
and ``bq`` absorb ``sqrt(new / old)`` so the softmax scale
``1 / sqrt(head_dim)`` is unchanged, and padded v dims give zero
outputs that meet zero rows of ``wo``.  Running the padded parameters
under the returned config computes the unpadded model's function.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .config import ModelConfig


def _scaled(t: torch.Tensor, scale: float) -> torch.Tensor:
    """``t * scale`` with the scale in ``t``'s type, as the reference
    multiplies by a Python float (bf16 weights: the scale rounded to bf16
    first)."""
    return t * torch.tensor(scale, dtype=t.dtype)


def _pad_head_cols(w, n_heads: int, dh_old: int, dh_new: int, *,
                   rotary: bool, scale: float = 1.0) -> torch.Tensor:
    """Pad the per-head columns of w (..., H*dh_old) to (..., H*dh_new),
    a bias (H*dh_old,) too (the reference's ``_pad_bias``);
    ``rotary=True`` pads each half of a head separately, so the (i,
    i + dh/2) rotation pairs of the original dims stay paired."""
    *lead, _ = w.shape
    w = _scaled(w.reshape(*lead, n_heads, dh_old), scale)
    if rotary:
        w = F.pad(w.reshape(*lead, n_heads, 2, dh_old // 2),
                  (0, (dh_new - dh_old) // 2))
    else:
        w = F.pad(w, (0, dh_new - dh_old))
    return w.reshape(*lead, n_heads * dh_new)


def _pad_head_rows(w, n_heads: int, dh_old: int, dh_new: int):
    """Pad the per-head input rows of wo (..., H*dh_old, D)."""
    *lead, _, d = w.shape
    w = w.reshape(*lead, n_heads, dh_old, d)
    return F.pad(w, (0, 0, 0, dh_new - dh_old)).reshape(
        *lead, n_heads * dh_new, d)


def pad_head_dim(params, cfg: ModelConfig, new_dh: int):
    """``(padded params, config)`` with every attention block's heads
    padded to ``new_dh``; the input tree is not modified.  The config
    gets ``head_dim=new_dh`` and ``rope_dim`` the old head dim."""
    old = cfg.head_dim
    if not (new_dh >= old and new_dh % 2 == 0 and old % 2 == 0):
        raise ValueError(f"pad_head_dim: {old} -> {new_dh}; both even, "
                         f"and no narrower")
    if cfg.mrope_sections is not None:
        raise ValueError("pad_head_dim: M-RoPE sections need their own pad")
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    qscale = (new_dh / old) ** 0.5  # attention scales by 1/sqrt(new_dh)

    def fix_attn(p):
        q = dict(p)
        q["wq"] = _pad_head_cols(p["wq"], h, old, new_dh, rotary=True,
                                 scale=qscale)
        q["wk"] = _pad_head_cols(p["wk"], hkv, old, new_dh, rotary=True)
        q["wv"] = _pad_head_cols(p["wv"], hkv, old, new_dh, rotary=False)
        q["wo"] = _pad_head_rows(p["wo"], h, old, new_dh)
        if "bq" in p:
            q["bq"] = _pad_head_cols(p["bq"], h, old, new_dh, rotary=True,
                                     scale=qscale)
            q["bk"] = _pad_head_cols(p["bk"], hkv, old, new_dh, rotary=True)
            q["bv"] = _pad_head_cols(p["bv"], hkv, old, new_dh,
                                     rotary=False)
        return q

    def walk(node):
        if isinstance(node, dict):
            if "wq" in node:
                return fix_attn(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params), dataclasses.replace(cfg, head_dim=new_dh,
                                             rope_dim=old)
