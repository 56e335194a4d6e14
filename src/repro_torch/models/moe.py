"""Mixture-of-experts MLP in PyTorch (the port of the JAX package's
``models/moe.py``: deepseek-moe's fine-grained experts, grok-1's coarse
ones).

Routing is the reference's sort-based dispatch: each token's top-k
experts are sorted by expert id (a stable sort, so among the slots of
one expert the earlier token comes first), scattered into an (E, C, D)
capacity buffer, run through the experts as three batched products and
combined back with the normalized gate weights.  Slots past an expert's
capacity ``C`` are dropped: they are zeroed and added onto slot 0 of
their expert, which adds +0 to the kept token there (the reference's
``.at[].add``), so the scatter accumulates.  ``C`` counts the tokens of
the whole call, so a token's output depends on the tokens it is batched
with whenever some are dropped.

:func:`moe_mlp_ep` is the expert-parallel variant: the routed experts
split over the ranks of a mesh axis, and each token's slots sent to
their experts' owners and back by ``all_to_all``
(:class:`repro_torch.launch.sharding.MeshPar` runs it with
``moe="ep"``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import spans
from .layers import act_fn, linear


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``max(int(S * k / E * capacity_factor), 1)``."""
    return max(int(tokens * top_k / n_experts * capacity_factor), 1)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          router_in_f32: bool = True):
    """Router logits (fp32), normalized top-k gates and expert ids."""
    rx = x.float() if router_in_f32 else x
    logits = (rx @ router.to(rx.dtype)).float()             # (S, E)
    gates, eidx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    return logits, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _device_span(fn):
    """``fn`` timed as one ``moe.mlp`` device span (:mod:`..spans`)."""
    @functools.wraps(fn)
    def traced(x, p, **kw):
        with spans.device_span("moe.mlp", x.device):
            return fn(x, p, **kw)
    return traced


@_device_span
def moe_mlp(x: torch.Tensor, p: dict, *, top_k: int, act: str = "silu",
            capacity_factor: float = 1.25,
            router_in_f32: bool = True) -> torch.Tensor:
    """x (S, D) tokens -> (S, D).

    p: router (D, E); wg, wu (E, D, F); wd (E, F, D); optional
    shared_wg / shared_wu (D, Fs) and shared_wd (Fs, D), the always-on
    shared experts."""
    s, d = x.shape
    e = p["router"].shape[1]
    c = capacity(s, top_k, e, capacity_factor)
    spans.count("moe.routed_slots", s * top_k)
    spans.count("moe.buffer_slots", e * c)
    _, gates, eidx = route(x, p["router"], top_k, router_in_f32)

    # ---- sort-based dispatch ----
    flat_e = eidx.reshape(-1)                               # (S*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of_slot = order // top_k
    counts = torch.zeros(e, dtype=sorted_e.dtype, device=x.device)
    counts.scatter_add_(0, sorted_e, torch.ones_like(sorted_e))  # no sync
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(s * top_k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < c                                     # capacity drop
    safe_pos = torch.where(keep, pos_in_e, 0)
    xs = x[token_of_slot] * keep[:, None].to(x.dtype)
    buf = torch.zeros((e, c, d), dtype=x.dtype, device=x.device).index_put(
        (sorted_e, safe_pos), xs, accumulate=True)

    # ---- the experts: three products batched over E ----
    h = act_fn(act)(torch.bmm(buf, p["wg"].to(x.dtype)))
    h = h * torch.bmm(buf, p["wu"].to(x.dtype))
    y_buf = torch.bmm(h, p["wd"].to(x.dtype))

    # ---- combine ----
    y_slots = y_buf[sorted_e, safe_pos] * keep[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    y = torch.einsum("skd,sk->sd", y_slots[inv].reshape(s, top_k, d),
                     gates.to(x.dtype))

    if "shared_wg" in p:
        h = act_fn(act)(linear(x, p["shared_wg"])) * linear(x, p["shared_wu"])
        y = y + linear(h, p["shared_wd"])
    return y


@_device_span
def moe_mlp_ep(x: torch.Tensor, p: dict, *, top_k: int, group,
               act: str = "silu", capacity_factor: float = 1.25
               ) -> torch.Tensor:
    """Expert-parallel MoE: x (S_local, D) this rank's tokens -> (S_local,
    D), complete (no sum over ranks needed).

    ``group`` is the mesh axis the experts are split over (a
    :class:`repro_torch.launch.collectives.Axis`: ``size()`` and
    ``all_to_all``); ``p`` holds the router (D, E) and this rank's
    E / size experts' wg, wu (E_local, D, F) and wd (E_local, F, D),
    plus the optional shared experts, whole.  The capacity C counts this
    rank's tokens against all E experts.  Each slot goes to its expert's
    owner in a (ranks, E_local, C, D) buffer, whose dim 0 is the
    destination; dropped slots add +0 to slot 0 of their expert, as in
    :func:`moe_mlp`."""
    s, d = x.shape
    n_dev = group.size()
    e_local = p["wg"].shape[0]
    e = e_local * n_dev
    c = capacity(s, top_k, e, capacity_factor)
    spans.count("moe.routed_slots", s * top_k)
    spans.count("moe.buffer_slots", e * c)
    _, gates, eidx = route(x, p["router"], top_k)

    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of_slot = order // top_k
    counts = torch.zeros(e, dtype=sorted_e.dtype, device=x.device)
    counts.scatter_add_(0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(s * top_k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < c
    safe_pos = torch.where(keep, pos_in_e, 0)
    owner = sorted_e // e_local
    local_e = sorted_e % e_local

    xs = x[token_of_slot] * keep[:, None].to(x.dtype)
    send = torch.zeros((n_dev, e_local, c, d), dtype=x.dtype,
                       device=x.device).index_put(
        (owner, local_e, safe_pos), xs, accumulate=True)
    # ship the slots to their experts' owners (dim 0: the destination);
    # recv[r, e, c] = rank r's slots for my local expert e
    recv = group.all_to_all(send, 0, 0)
    buf = recv.transpose(0, 1).reshape(e_local, n_dev * c, d)

    h = act_fn(act)(torch.bmm(buf, p["wg"].to(x.dtype)))
    h = h * torch.bmm(buf, p["wu"].to(x.dtype))
    y_buf = torch.bmm(h, p["wd"].to(x.dtype))

    # back[r, e, c]: the slot this rank sent to rank r's expert e
    back = group.all_to_all(
        y_buf.reshape(e_local, n_dev, c, d).transpose(0, 1), 0, 0)
    y_slots = back[owner, local_e, safe_pos] * keep[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    y = torch.einsum("skd,sk->sd", y_slots[inv].reshape(s, top_k, d),
                     gates.to(x.dtype))

    if "shared_wg" in p:
        h = act_fn(act)(linear(x, p["shared_wg"])) * linear(x, p["shared_wu"])
        y = y + linear(h, p["shared_wd"])
    return y


def aux_load_balance_loss(logits_f32: torch.Tensor, eidx: torch.Tensor,
                          n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: ``E * sum(me * ce)``
    (mean router probability times the share of routed slots, per
    expert)."""
    me = torch.softmax(logits_f32, dim=-1).mean(0)
    ce = F.one_hot(eidx, n_experts).sum(1).float().mean(0) / top_k
    return n_experts * torch.sum(me * ce)
