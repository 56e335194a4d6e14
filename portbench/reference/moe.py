"""The plain reference of the ``moe`` family (deepseek-moe-16b as the
port runs it): attention blocks whose MLP is a mixture of experts.

The router is a float32 product with the (D, E) router weights; each
token takes the softmax's ``top_k`` experts, their gates divided by
their sum, and every one of its slots is computed: no expert drops a
token, as in the published model.  The shared experts are a gated MLP
that every token takes.
"""
from __future__ import annotations

import torch

from . import common


def moe_mlp(x, p, cfg, quant=None):
    """x (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    xs = x.reshape(b * s, d)
    probs = torch.softmax(xs @ p["router"].float(), -1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(xs)
    for j in range(e):
        tok, slot = (eidx == j).nonzero(as_tuple=True)
        if not tok.numel():
            continue
        pj = {name: p[name][j] for name in ("wg", "wu", "wd")}
        y.index_add_(0, tok, common.gated_mlp(xs[tok], pj, cfg["act"], quant)
                     * gates[tok, slot][:, None])
    if "shared_wg" in p:
        y = y + common.gated_mlp(xs, {"wg": p["shared_wg"],
                                      "wu": p["shared_wu"],
                                      "wd": p["shared_wd"]}, cfg["act"], quant)
    return y.reshape(b, s, d)


def logits(params, cfg, seq, first, quant=None):
    def mlp(x, p, kind, q):
        if kind == "S":
            return common.gated_mlp(x, p, cfg["act"], q)
        return moe_mlp(x, p, cfg, q)
    return common.forward(params, cfg, seq, first, mixers={}, mlp=mlp,
                          quant=quant)
