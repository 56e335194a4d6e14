"""Mamba2 and RWKV6 ("Finch") in PyTorch (the port of the JAX package's
``models/ssm.py``).

Mamba2's mixer runs the chunked SSD algorithm (:func:`ssd_chunked`:
quadratic within a chunk as batched products, a short recurrence across
chunks) for prefill and training, and its one-step recurrence in
decode.  RWKV6's time mix runs the diagonal-decay recurrence the
``linear_scan`` kernel implements.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .kernel_policy import fit_block
from .layers import group_norm_heads, linear
from .par import DEFAULT_PAR

# ============================================================== Mamba2 ======


def ssd_chunked(a, u, bm, cm, s0=None, chunk: int = 128):
    """Chunked scan of ``S_t = a_t S_{t-1} + B_t u_t``, ``y_t = C_t S_t``.

    a (B,T,H) in (0, 1]; u (B,T,H,P); bm, cm (B,T,N), shared over
    heads; s0 (B,H,N,P) or None (zeros).  Returns y (B,T,H,P) in
    ``u.dtype`` and the final state (B,H,N,P) in fp32.  ``T`` must be a
    multiple of the chunk ``min(chunk, T)``, as the reference requires.

    The reference's three-operand intra-chunk product is taken as the
    (B,nc,c,c,H) weight ``(C_i.B_j) exp(cum_i - cum_j)`` (zero above the
    diagonal) and one batched product over j, never the (B,nc,c,c,H,P)
    intermediate.  The weight's upper triangle is masked before the
    exponential, which gives the reference's values and keeps their
    gradient finite."""
    b, t, h = a.shape
    p, n = u.shape[-1], bm.shape[-1]
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"ssd_chunked: T = {t} is not a multiple of the "
                         f"chunk {c}")
    nc = t // c
    uc = u.reshape(b, nc, c, h, p).float()
    bc = bm.reshape(b, nc, c, n).float()
    cc = cm.reshape(b, nc, c, n).float()
    cum = torch.cumsum(torch.log(a.reshape(b, nc, c, h).float().clamp_min(
        1e-20)), dim=2)                                     # inclusive

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) u_j
    scores = torch.einsum("bgin,bgjn->bgij", cc, bc)
    tri = torch.ones((c, c), dtype=torch.bool, device=a.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,H)
    lm = diff.masked_fill(~tri[:, :, None], float("-inf")).exp()
    w = (scores[..., None] * lm).permute(0, 1, 4, 2, 3)    # (B,nc,H,i,j)
    y = (w @ uc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # inter-chunk: each chunk's summary state, then the recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,nc,c,H)
    cstate = torch.einsum("bgjn,bgjhp->bghnp", bc,
                          decay_to_end[..., None] * uc)
    cdecay = torch.exp(cum[:, :, -1, :])                   # (B,nc,H)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=a.device)
             if s0 is None else s0.float())
    prevs = []
    for g in range(nc):
        prevs.append(state)                                # before chunk g
        state = cdecay[:, g, :, None, None] * state + cstate[:, g]
    y_inter = torch.einsum("bgin,bghnp->bgihp", cc, torch.stack(prevs, 1))
    y = y + torch.exp(cum)[..., None] * y_inter
    return y.reshape(b, t, h, p).to(u.dtype), state


def causal_conv1d(x, w, bias, state=None):
    """Depthwise causal conv; x (B,T,C), w (K,C).  Returns (y, the last
    K-1 inputs in ``x.dtype``, the decode state)."""
    k = w.shape[0]
    if state is None:
        hist = F.pad(x, (0, 0, k - 1, 0))
    else:
        hist = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(hist[:, i:i + t] * w[i][None, None] for i in range(k))
    return y + bias[None, None], hist[:, hist.shape[1] - (k - 1):]


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, H, N, P) f32
    conv: torch.Tensor  # (B, K-1, d_inner)


def mamba2_mix(x, p, *, ssm_state: int, head_dim: int, chunk: int = 128,
               state: Optional[MambaState] = None, par=None):
    """Mamba2 mixer; x (B,T,D).  Returns ``(out, MambaState)``.  With a
    state and T == 1: the one-step recurrence (decode); otherwise
    :func:`ssd_chunked` from the state (zeros without one).  The casts
    sit where the reference's do: the conv's fp32 weights make ``xi``
    fp32, so the B, C and dt projections run in fp32, and ``y`` returns
    to ``x.dtype`` only before the ``silu(z)`` gate.

    With a ``par`` (:class:`~repro_torch.models.par.Par`) that splits
    the mixer over ``model``, ``p`` holds this rank's blocks: ``w_in``'s
    contiguous chunk of its ``xi | z`` columns (re-cut into this rank's
    chunk of each half by ``par.halves``), the conv's and ``w_out``'s
    ``d_inner`` channels, and ``w_B`` / ``w_C`` / ``w_dt``'s rows, whose
    partial products are summed over ``model`` as one tensor; the
    per-head vectors are read as this rank's heads, and the state is its
    heads' and channels'.  ``x`` is the residual stream in the ``par``'s
    layout: the conv and the scan run on the whole sequence after the
    entry (``region_in``, or ``whole_in`` for a mixer that runs whole)."""
    par = par or DEFAULT_PAR
    split = par.dense_split("mamba") != "whole"
    x = par.region_in(x) if split else par.whole_in(x)
    b, t, _ = x.shape
    d_inner = p["w_out"].shape[0]  # this rank's channels
    h = d_inner // head_dim

    xz = linear(x, p["w_in"])
    xi, z = (par.halves(xz) if split else xz).chunk(2, dim=-1)
    xi, new_conv = causal_conv1d(xi, p["conv_w"], p["conv_b"],
                                 None if state is None else state.conv)
    xi = F.silu(xi)
    bm = linear(xi, p["w_B"])                               # (B,T,N)
    cm = linear(xi, p["w_C"])                               # (B,T,N)
    dt = linear(xi, p["w_dt"])                              # (B,T,H)
    dt_bias, a_log, d_skip = p["dt_bias"], p["A_log"], p["D_skip"]
    if split:
        n = bm.shape[-1]
        bcd = par.replicated_in(par.model_sum(torch.cat([bm, cm, dt], -1)))
        bm, cm, dt = bcd.split([n, n, dt.shape[-1]], -1)
        dt = dt.narrow(-1, par.model_rank * h, h)
        dt_bias, a_log, d_skip = (par.local(a, 0, h)
                                  for a in (dt_bias, a_log, d_skip))
    dt = F.softplus(dt.float() + dt_bias)
    a = torch.exp(-dt * torch.exp(a_log))                   # (B,T,H)
    xh = xi.reshape(b, t, h, head_dim)
    u = xh.float() * dt[..., None]                          # discretized

    if t == 1 and state is not None:
        s_final = (a[:, 0, :, None, None] * state.ssm
                   + torch.einsum("bn,bhp->bhnp", bm[:, 0].float(), u[:, 0]))
        y = torch.einsum("bn,bhnp->bhp", cm[:, 0].float(), s_final)[:, None]
    else:
        y, s_final = ssd_chunked(a, u, bm, cm,
                                 None if state is None else state.ssm, chunk)
    y = y + xh.float() * d_skip[None, None, :, None]
    y = y.reshape(b, t, d_inner).to(x.dtype) * F.silu(z)
    out = linear(y, p["w_out"])
    return (par.region_out(out) if split else par.whole_out(out),
            MambaState(ssm=s_final, conv=new_conv))


def init_mamba2(init, d: int, *, ssm_state: int, head_dim: int,
                conv_kernel: int = 4, dtype=torch.bfloat16) -> dict:
    """Mamba2 parameters with the JAX package's ``init_mamba2`` shapes,
    types and scales (the conv weights drawn, rounded to ``dtype`` and
    kept in fp32, as there); ``init`` is a
    :class:`~repro_torch.models.layers.ParamInit`."""
    d_inner = 2 * d
    h = d_inner // head_dim
    dt0 = init.uniform((h,), math.log(1e-3), math.log(1e-1))
    return {
        "w_in": init.normal((d, 2 * d_inner), d, dtype),
        "conv_w": init.normal((conv_kernel, d_inner), conv_kernel,
                              dtype).float(),
        "conv_b": init.full((d_inner,), 0.0),
        "w_B": init.normal((d_inner, ssm_state), d_inner, dtype),
        "w_C": init.normal((d_inner, ssm_state), d_inner, dtype),
        "w_dt": init.normal((d_inner, h), d_inner, dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(dt0))),
        "A_log": init.full((h,), 0.0),
        "D_skip": init.full((h,), 1.0),
        "w_out": init.normal((d_inner, d), d_inner, dtype),
    }


# ============================================================== RWKV6 =======


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, N, N) f32
    prev_tm: torch.Tensor  # (B, D) last token seen by time-mix
    prev_cm: torch.Tensor  # (B, D) last token seen by channel-mix


def _token_shift(x, prev):
    """Shift by one token; ``prev`` is the last token of the previous
    segment (zeros at sequence start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _steps(rf, kf, vf, decay, u, s):
    """The plain RWKV6 recurrence over (B,T,H,N) inputs from state ``s``:
    ``y_t = r_t (S + u k_t^T v_t)``, ``S = diag(decay_t) S + k_t^T v_t``.
    Returns (y (B,T,H,N), final state)."""
    ys = []
    for i in range(rf.shape[1]):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]       # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, i],
                               s + u[None, :, :, None] * kv))
        s = decay[:, i][..., None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv6_time_mix(x, p, *, head_dim: int,
                   state: Optional[RWKVState] = None,
                   scan: str = "linear_scan", chunk: int = 64,
                   constraint=None, par=None):
    """RWKV6 time mix with data-dependent per-channel decay.  Returns
    ``(out, final wkv state, last token)``.

    ``scan="linear_scan"`` (T > 1) runs the recurrence through the scan
    kernel.  The kernel reads its state after the update
    (``y_t = r.S_t``) while RWKV reads it before the update plus the
    u-bonus, so the kernel gets decay/k/v shifted by one step — its state
    after step t is then S_{t-1} — and the separable bonus
    ``r.(u * k_t v_t^T) = (sum_n r u k) v_t`` and the true final state
    are one elementwise step each outside it.  ``scan="chunked"`` and
    single-step decode (T == 1) run the plain step loop; under grad mode
    that loop runs as checkpointed chunks of ``fit_block(T, chunk)``
    steps, as the reference's scan of rematerialized chunks does (the
    same numbers, with O(T / chunk) saved states).  ``constraint`` is
    applied to r, k, v and the decay, where the reference shards the
    heads (the port's ``Par.constraint``: the identity).

    With a ``par`` that splits RWKV6 over ``model``, ``p`` holds this
    rank's heads' columns of ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and
    rows of ``w_o`` (row-parallel out); the decay's low-rank pair runs
    whole and its log is cut to this rank's heads, as are ``u_bonus``
    and ``ln_x``; ``state`` holds this rank's heads of the wkv state and
    the whole last token.  ``x`` is the residual stream in the ``par``'s
    layout, gathered whole over T once before the token shift
    (``whole_in``: the previous token of a chunk's first position lies on
    another rank); the output leaves in the stream's layout."""
    par = par or DEFAULT_PAR
    split = par.dense_split("rwkv") != "whole"
    x = par.whole_in(x)  # the token shift reads the previous position
    b, t, d = x.shape
    n = head_dim
    dl = p["w_r"].shape[-1]  # this rank's channels
    h = dl // n
    prev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state is None else state.prev_tm.to(x.dtype))
    xx = _token_shift(x, prev)

    def lerp(mu):
        return x + (xx - x) * mu.to(x.dtype)

    xr, xk, xv, xw, xg = (lerp(p[f"mu_{c}"]) for c in "rkvwg")
    if split:
        xr, xk, xv, xg = par.replicated_in(torch.stack([xr, xk, xv, xg])
                                           ).unbind(0)
    r = linear(xr, p["w_r"]).reshape(b, t, h, n)
    k = linear(xk, p["w_k"]).reshape(b, t, h, n)
    v = linear(xv, p["w_v"]).reshape(b, t, h, n)
    g = F.silu(linear(xg, p["w_g"]))
    # data-dependent decay (low-rank): w = exp(-exp(w0 + tanh(xw A) B))
    dd = torch.tanh(linear(xw, p["w_dec_A"])) @ p["w_dec_B"].to(x.dtype)
    logw = p["w_dec0"].float() + dd.float()
    ln_x, u = p["ln_x"], p["u_bonus"]
    if split:
        logw, ln_x, u = (par.local(a, -1, dl) for a in (logw, ln_x, u))
    decay = torch.exp(-torch.exp(logw)).reshape(b, t, h, n)   # (0,1)
    u = u.reshape(h, n).float()
    if constraint is not None:
        r, k, v, decay = (constraint(a) for a in (r, k, v, decay))
    kf, vf, rf = k.float(), v.float(), r.float()
    s0 = (torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
          if state is None else state.wkv)

    if scan == "linear_scan" and t > 1:
        from ..kernels.ops import linear_scan
        one = torch.ones((b, 1, h, n), dtype=torch.float32, device=x.device)
        d_sh = torch.cat([one, decay[:, :-1]], dim=1)
        k_sh = torch.cat([0.0 * one, kf[:, :-1]], dim=1)
        v_sh = torch.cat([0.0 * one, vf[:, :-1]], dim=1)
        y, s_prev = linear_scan(d_sh, k_sh, v_sh, rf.contiguous(), s0)
        y = y + (rf * u * kf).sum(-1, keepdim=True) * vf
        s_final = (decay[:, -1][..., None] * s_prev
                   + kf[:, -1][..., None] * vf[:, -1][..., None, :])
    elif torch.is_grad_enabled() and t > 1:
        # checkpointed chunks: the backward keeps one (B,H,N,N) state per
        # chunk, not one per step, and replays a chunk's steps
        c = fit_block(t, chunk)
        ys, s_final = [], s0
        for c0 in range(0, t, c):
            sl = slice(c0, c0 + c)
            args = (rf[:, sl], kf[:, sl], vf[:, sl], decay[:, sl], u,
                    s_final)
            y_c, s_final = (checkpoint(_steps, *args, use_reentrant=False)
                            if c < t else _steps(*args))
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    else:
        y, s_final = _steps(rf, kf, vf, decay, u, s0)
    y = group_norm_heads(y, ln_x.reshape(h, n)[None, None])
    y = y.reshape(b, t, dl).to(x.dtype) * g
    out = linear(y, p["w_o"])
    return ((par.region_out(out) if split else par.whole_out(out)),
            s_final, x[:, -1])


def rwkv6_channel_mix(x, p, state_prev=None, par=None):
    """RWKV6 channel mix.  With a ``par`` that splits RWKV6 over
    ``model``: ``w_ck`` column-parallel, ``w_cv`` row-parallel with its
    sum reduce-scattered to this rank's channels, which the local block
    of ``w_cr`` (its output channels) gates; the gated channels then
    leave in the stream's layout (``channels_out``: gathered whole, or
    under sequence parallelism exchanged for this rank's chunk of T).
    ``x`` is gathered whole over T before the token shift, as in the
    time mix."""
    par = par or DEFAULT_PAR
    split = par.dense_split("rwkv") != "whole"
    x = par.whole_in(x)
    b, t, d = x.shape
    prev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state_prev is None else state_prev.to(x.dtype))
    xx = _token_shift(x, prev)
    xk = x + (xx - x) * p["mu_ck"].to(x.dtype)
    xr = x + (xx - x) * p["mu_cr"].to(x.dtype)
    if split:
        xk, xr = par.replicated_in(torch.stack([xk, xr])).unbind(0)
    k = torch.square(F.relu(linear(xk, p["w_ck"])))
    kv = linear(k, p["w_cv"])
    if not split:
        return (par.whole_out(torch.sigmoid(linear(xr, p["w_cr"])) * kv),
                x[:, -1])
    kv = par.scatter_out(kv, -1)
    return (par.channels_out(torch.sigmoid(linear(xr, p["w_cr"])) * kv),
            x[:, -1])


def init_rwkv6(init, d: int, d_ff: int, *, dec_rank: int = 64,
               dtype=torch.bfloat16) -> dict:
    """RWKV6 parameters with the JAX package's ``init_rwkv6`` shapes and
    scales; ``init`` is a :class:`~repro_torch.models.layers.ParamInit`."""
    p = {f"mu_{c}": init.full((d,), 0.5) for c in "rkvwg"}
    p.update({
        "w_r": init.normal((d, d), d, dtype),
        "w_k": init.normal((d, d), d, dtype),
        "w_v": init.normal((d, d), d, dtype),
        "w_g": init.normal((d, d), d, dtype),
        "w_o": init.normal((d, d), d, dtype),
        "w_dec_A": init.normal((d, dec_rank), d, dtype),
        "w_dec_B": init.normal((dec_rank, d), dec_rank, dtype),
        "w_dec0": init.full((d,), -1.0),
        "u_bonus": init.full((d,), 0.0),
        "ln_x": init.full((d,), 1.0),
        "mu_ck": init.full((d,), 0.5),
        "mu_cr": init.full((d,), 0.5),
        "w_ck": init.normal((d, d_ff), d, dtype),
        "w_cv": init.normal((d_ff, d), d_ff, dtype),
        "w_cr": init.normal((d, d), d, dtype),
    })
    return p
