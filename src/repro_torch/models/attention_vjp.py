"""Memory-efficient attention with a hand-written flash backward (the
port's copy of the JAX package's ``models/attention_vjp.py``).

Autograd through a blockwise online softmax would keep every block's
probability matrix (O(T^2) saved tensors).  Here each function is a
:class:`torch.autograd.Function` whose forward saves only
``(q, k, v, o, lse)`` = O(T) and whose backward re-tiles the score
blocks, exactly as the reference's custom VJPs do; neither direction is
recorded by autograd.

Two variants:

* :func:`flash_mha` — full / causal attention, q-blocks x kv-blocks;
* :func:`local_mha` — sliding window: every q-block reads one
  contiguous context slice of ``min(window + bq, T)`` keys, so compute
  and memory are O(T * window) in both directions; its backward takes
  two passes, dq per q-block and then dk / dv per kv-block over the
  ``min(window + bq, T)`` queries that can see it.

Layouts: q (B,T,H,Dh), k/v (B,Tk,Hkv,Dh), GQA by H = Hkv*G.  Query row
i is at position ``q_start + i`` for the masks and key j at j, so q may
be a rank's rows of a longer sequence whose keys are whole (``q_start``
0: q and k share T).  Scores and
accumulators are fp32 (products of the inputs' values summed in fp32,
the reference's ``preferred_element_type``).  ``T`` must be a multiple
of the fitted block ``min(block_q, T)`` (and ``Tk`` of
``min(block_k, Tk)``), as the reference asserts; nothing is padded.
These are plain PyTorch, not a port of a TPU kernel: the reference's
functions are XLA scans, not Pallas kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def _fit(n: int, block: int, what: str) -> int:
    b = min(block, n)
    if n % b:
        raise ValueError(f"{what} {n} is no multiple of its block {b}")
    return b


def _scores(q_i, k_j):
    """(B,bq,Hkv,G,Dh) x (B,bk,Hkv,Dh) -> fp32 (B,Hkv,G,bq,bk)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q_i.float(), k_j.float())


def _pv(p, v_j):
    """fp32 (B,Hkv,G,bq,bk) x (B,bk,Hkv,Dh) -> fp32 (B,Hkv,G,bq,Dh)."""
    return torch.einsum("bhgqk,bkhd->bhgqd", p, v_j.float())


def _ds_to_q(ds, k_j):
    """-> fp32 (B,bq,Hkv,G,Dh)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, k_j.float())


def _to_k(p, x_i):
    """fp32 (B,Hkv,G,bq,bk) x (B,bq,Hkv,G,Dh) -> fp32 (B,bk,Hkv,Dh)."""
    return torch.einsum("bhgqk,bqhgd->bkhd", p, x_i.float())


def _delta(do, o, b, t, hkv, g, dh):
    """sum_d do * o per row: fp32 (B,Hkv,G,T)."""
    return torch.einsum("bthgd,bthgd->bhgt",
                        do.float().reshape(b, t, hkv, g, dh),
                        o.float().reshape(b, t, hkv, g, dh))


# =========================================================== full/causal ====

def _flash_fwd(q, k, v, causal, window, scale, block_q, block_k, q_start):
    b, t, h, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq, bk = _fit(t, block_q, "T"), _fit(tk, block_k, "Tk")
    sc = scale if scale is not None else dh ** -0.5
    qs = (q.float() * sc).to(q.dtype).reshape(b, t, hkv, g, dh)
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((b, hkv, g, t), dtype=torch.float32, device=dev)
    for q0 in range(0, t, bq):
        q_i = qs[:, q0:q0 + bq]
        qpos = torch.arange(q_start + q0, q_start + q0 + bq, device=dev)
        m = torch.full((b, hkv, g, bq, 1), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, bq, 1), device=dev)
        acc = torch.zeros((b, hkv, g, bq, dh), device=dev)
        for k0 in range(0, tk, bk):
            k_j, v_j = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            msk = _mask(qpos, torch.arange(k0, k0 + bk, device=dev), causal,
                        window)
            s = torch.where(msk, _scores(q_i, k_j), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(msk, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + _pv(p.to(v.dtype).float(), v_j)
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[:, q0:q0 + bq] = (acc / l_safe).to(q.dtype).permute(
            0, 3, 1, 2, 4).reshape(b, bq, h, dh)
        lse[..., q0:q0 + bq] = (m + torch.log(l_safe))[..., 0]
    return o, lse


def _flash_bwd(q, k, v, o, lse, do, causal, window, scale, block_q,
               block_k, q_start):
    b, t, h, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq, bk = min(block_q, t), min(block_k, tk)
    sc = scale if scale is not None else dh ** -0.5
    dev = q.device
    doh = do.reshape(b, t, hkv, g, dh)
    qh = q.reshape(b, t, hkv, g, dh)
    delta = _delta(do, o, b, t, hkv, g, dh)
    dq = torch.zeros((b, t, hkv, g, dh), device=dev)
    dk = torch.zeros((b, tk, hkv, dh), device=dev)
    dv = torch.zeros((b, tk, hkv, dh), device=dev)
    for k0 in range(0, tk, bk):
        k_j, v_j = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + bk, device=dev)
        dk_j = torch.zeros((b, bk, hkv, dh), device=dev)
        dv_j = torch.zeros((b, bk, hkv, dh), device=dev)
        for q0 in range(0, t, bq):
            q_i, do_i = qh[:, q0:q0 + bq], doh[:, q0:q0 + bq]
            msk = _mask(torch.arange(q_start + q0, q_start + q0 + bq,
                                     device=dev), kpos, causal, window)
            s = _scores(q_i, k_j) * sc
            p = torch.where(msk, torch.exp(s - lse[..., q0:q0 + bq, None]),
                            0.0)
            dv_j = dv_j + _to_k(p, do_i)
            dp = _scores(do_i, v_j)
            ds = p * (dp - delta[..., q0:q0 + bq, None]) * sc
            dq[:, q0:q0 + bq] += _ds_to_q(ds, k_j)
            dk_j = dk_j + _to_k(ds, q_i)
        dk[:, k0:k0 + bk] = dk_j
        dv[:, k0:k0 + bk] = dv_j
    return (dq.reshape(b, t, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k,
                q_start):
        o, lse = _flash_fwd(q, k, v, causal, window, scale, block_q,
                            block_k, q_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, scale, block_q, block_k, q_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _flash_bwd(q, k, v, o, lse, do, *ctx.args) + (None,) * 6


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, block_q: int = 512,
              block_k: int = 512, q_start: int = 0) -> torch.Tensor:
    """Blockwise attention with an O(T) backward; q (B,T,H,Dh), k/v
    (B,Tk,Hkv,Dh) -> (B,T,H,Dh) in q's type; query row i at position
    ``q_start + i``."""
    return _FlashMHA.apply(q, k, v, causal, window, scale, block_q, block_k,
                           q_start)


# ============================================================ local (SWA) ====

def _local_mask(qpos, kpos, window: int):
    return (kpos[None, :] <= qpos[:, None]) & (
        qpos[:, None] - kpos[None, :] < window)


def _local_fwd(q, k, v, window, scale, block_q, q_start):
    b, t, h, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq = _fit(t, block_q, "T")
    _fit(tk, bq, "Tk")  # the backward's kv blocks
    if q_start + t > tk:
        raise ValueError(f"rows at {q_start}..{q_start + t} past the "
                         f"{tk} keys")
    ctx = min(window + bq, tk)
    sc = scale if scale is not None else dh ** -0.5
    qh = q.reshape(b, t, hkv, g, dh)
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty((b, hkv, g, t), dtype=torch.float32, device=dev)
    for q0 in range(0, t, bq):
        p0 = q_start + q0  # the block's first position
        start = min(max(p0 + bq - ctx, 0), tk - ctx)
        k_j, v_j = k[:, start:start + ctx], v[:, start:start + ctx]
        msk = _local_mask(torch.arange(p0, p0 + bq, device=dev),
                          torch.arange(start, start + ctx, device=dev),
                          window)
        s = torch.where(msk, _scores(qh[:, q0:q0 + bq], k_j) * sc, NEG_INF)
        mx = s.amax(-1, keepdim=True)
        p = torch.where(msk, torch.exp(s - mx), 0.0)
        l = p.sum(-1, keepdim=True)
        l = torch.where(l == 0, 1.0, l)
        o_i = torch.einsum("bhgqk,bkhd->bqhgd", (p / l).to(v.dtype), v_j)
        o[:, q0:q0 + bq] = o_i.reshape(b, bq, h, dh).to(q.dtype)
        lse[..., q0:q0 + bq] = (mx + torch.log(l))[..., 0]
    return o, lse


def _local_bwd(q, k, v, o, lse, do, window, scale, block_q, q_start):
    b, t, h, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq = min(block_q, t)
    ctx = min(window + bq, tk)
    sc = scale if scale is not None else dh ** -0.5
    dev = q.device
    qh = q.reshape(b, t, hkv, g, dh)
    doh = do.reshape(b, t, hkv, g, dh)
    delta = _delta(do, o, b, t, hkv, g, dh)

    def recompute_p(q_i, k_j, lse_i, q0, k0, nq, nk):
        msk = _local_mask(torch.arange(q_start + q0, q_start + q0 + nq,
                                       device=dev),
                          torch.arange(k0, k0 + nk, device=dev), window)
        s = _scores(q_i, k_j) * sc
        return torch.where(msk, torch.exp(s - lse_i[..., None]), 0.0)

    # pass 1: dq per q-block (the forward's slices)
    dq = torch.empty((b, t, hkv, g, dh), device=dev)
    for q0 in range(0, t, bq):
        start = min(max(q_start + q0 + bq - ctx, 0), tk - ctx)
        q_i, do_i = qh[:, q0:q0 + bq], doh[:, q0:q0 + bq]
        k_j, v_j = k[:, start:start + ctx], v[:, start:start + ctx]
        p = recompute_p(q_i, k_j, lse[..., q0:q0 + bq], q0, start, bq, ctx)
        ds = p * (_scores(do_i, v_j) - delta[..., q0:q0 + bq, None]) * sc
        dq[:, q0:q0 + bq] = _ds_to_q(ds, k_j)

    # pass 2: dk/dv per kv-block; the q rows that can see block j lie in
    # one contiguous slice of min(window + bkv, T) rows
    bkv = bq
    qctx = min(window + bkv, t)
    dk = torch.empty((b, tk, hkv, dh), device=dev)
    dv = torch.empty((b, tk, hkv, dh), device=dev)
    for k0 in range(0, tk, bkv):
        qs = min(max(k0 - q_start, 0), t - qctx)
        k_j, v_j = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        q_i, do_i = qh[:, qs:qs + qctx], doh[:, qs:qs + qctx]
        p = recompute_p(q_i, k_j, lse[..., qs:qs + qctx], qs, k0, qctx, bkv)
        dv[:, k0:k0 + bkv] = _to_k(p, do_i)
        ds = p * (_scores(do_i, v_j) - delta[..., qs:qs + qctx, None]) * sc
        dk[:, k0:k0 + bkv] = _to_k(ds, q_i)
    return (dq.reshape(b, t, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _LocalMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, scale, block_q, q_start):
        o, lse = _local_fwd(q, k, v, window, scale, block_q, q_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, scale, block_q, q_start)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _local_bwd(q, k, v, o, lse, do, *ctx.args) + (None,) * 4


def local_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, scale: Optional[float] = None,
              block_q: int = 256, q_start: int = 0) -> torch.Tensor:
    """Causal sliding-window attention (a query sees the ``window`` keys
    up to itself) with an O(T * window) backward; q (B,T,H,Dh), k/v
    (B,Tk,Hkv,Dh) with ``q_start + T <= Tk`` -> (B,T,H,Dh) in q's type;
    query row i at position ``q_start + i``."""
    return _LocalMHA.apply(q, k, v, window, scale, block_q, q_start)
