"""RWKV6 ("Finch") time mix and channel mix in PyTorch (the RWKV6 half of
the JAX package's ``models/ssm.py``).

The time mix runs the diagonal-decay recurrence the ``linear_scan``
kernel implements.  The Mamba2 half (``ssd_chunked``, ``causal_conv1d``,
``mamba2_mix``) is not ported yet (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .kernel_policy import fit_block
from .layers import group_norm_heads, linear


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
                   scan: str = "linear_scan", chunk: int = 64):
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
    same numbers, with O(T / chunk) saved states)."""
    b, t, d = x.shape
    n = head_dim
    h = d // n
    prev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state is None else state.prev_tm.to(x.dtype))
    xx = _token_shift(x, prev)

    def lerp(mu):
        return x + (xx - x) * mu.to(x.dtype)

    xr, xk, xv, xw, xg = (lerp(p[f"mu_{c}"]) for c in "rkvwg")
    r = linear(xr, p["w_r"]).reshape(b, t, h, n)
    k = linear(xk, p["w_k"]).reshape(b, t, h, n)
    v = linear(xv, p["w_v"]).reshape(b, t, h, n)
    g = F.silu(linear(xg, p["w_g"]))
    # data-dependent decay (low-rank): w = exp(-exp(w0 + tanh(xw A) B))
    dd = torch.tanh(linear(xw, p["w_dec_A"])) @ p["w_dec_B"].to(x.dtype)
    logw = p["w_dec0"].float() + dd.float()
    decay = torch.exp(-torch.exp(logw)).reshape(b, t, h, n)   # (0,1)
    u = p["u_bonus"].reshape(h, n).float()
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
    y = group_norm_heads(y, p["ln_x"].reshape(h, n)[None, None])
    y = y.reshape(b, t, d).to(x.dtype) * g
    return linear(y, p["w_o"]), s_final, x[:, -1]


def rwkv6_channel_mix(x, p, state_prev=None):
    b, t, d = x.shape
    prev = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state_prev is None else state_prev.to(x.dtype))
    xx = _token_shift(x, prev)
    xk = x + (xx - x) * p["mu_ck"].to(x.dtype)
    xr = x + (xx - x) * p["mu_cr"].to(x.dtype)
    k = torch.square(F.relu(linear(xk, p["w_ck"])))
    kv = linear(k, p["w_cv"])
    return torch.sigmoid(linear(xr, p["w_cr"])) * kv, x[:, -1]


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
