"""Plain PyTorch versions of the port's kernels (the ``ref.py`` layer).

Each repeats its kernel's arithmetic with tensor ops, with the same
layouts at the API (NHWC / HWIO for the CNN kernels, (B,H,T,D) for
attention, (B,T,H,N) for the scan), and calls no library convolution,
pooling or attention, so that holding a CUDA kernel against its plain
version on the card checks the kernel and not cuDNN.  The CPU tests run these; on the card
``chip_smoke.py`` holds each CUDA kernel against them.  The main path
never calls them on a CUDA tensor: :mod:`repro_torch.kernels.ops` sends
CUDA tensors to the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.graph import _conv_pads

NEG_INF = -1e30


def activation(y: torch.Tensor, act: Optional[str],
               alpha: float) -> torch.Tensor:
    """The kernels' epilogue activations (``None``, relu, leaky_relu)."""
    if act is None:
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "leaky_relu":
        # the same select as the TPU kernel's epilogue
        return torch.where(y > 0, y, alpha * y)
    raise ValueError(f"unknown activation {act!r}")


def window_taps(x: torch.Tensor, size, strides, pads=(0, 0, 0, 0),
                fill: float = 0.0):
    """``(i, j, xs)`` for every tap of a ``size`` window moved by
    ``strides`` over NHWC ``x`` padded by ``(top, bottom, left, right)``
    ``pads`` of ``fill``: ``xs`` is the strided (N, OH, OW, C) slice of
    the input under tap (i, j)."""
    kh, kw = (int(s) for s in size)
    sh, sw = (int(s) for s in strides)
    pt, pb, pl, pr = pads
    if any(pads):
        x = F.pad(x, (0, 0, pl, pr, pt, pb), value=fill)
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw) // sw + 1
    for i in range(kh):
        for j in range(kw):
            yield i, j, x[:, i:i + (oh - 1) * sh + 1:sh,
                          j:j + (ow - 1) * sw + 1:sw, :]


def conv2d_ref(x, w, b, *, strides=(1, 1), padding="valid",
               act: Optional[str] = None, alpha: float = 0.1):
    """Plain version of ``csrc/conv2d.cu``: NHWC x HWIO convolution plus
    bias and activation, as one ``(N*OH*OW, CI) @ (CI, CO)`` product per
    filter tap accumulated in fp32 (the TPU kernel's implicit GEMM);
    ``same`` padding split TF-style, output in ``x.dtype``."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    sh, sw = (int(s) for s in strides)
    pads = _conv_pads((h, wd, ci), kh, kw, (sh, sw), padding)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, j, xs in window_taps(x.float(), (kh, kw), (sh, sw), pads):
        acc = acc + xs.reshape(-1, ci) @ w[i, j].float()
    acc = activation(acc + b.float(), act, alpha)
    return acc.reshape(n, xs.shape[1], xs.shape[2], co).to(x.dtype)


def maxpool2d_ref(x, *, size=(2, 2), strides=None):
    """Plain version of ``csrc/maxpool2d.cu``: valid-padded NHWC max pool
    as ``torch.maximum`` over the strided tap slices; the stride defaults
    to the window."""
    out = None
    for _, _, xs in window_taps(x, size, strides or size):
        out = xs if out is None else torch.maximum(out, xs)
    return out.contiguous()


def attention_ref(q, k, v, *, causal=True, window: Optional[int] = None,
                  scale: Optional[float] = None, q_start: int = 0):
    """Plain version of ``csrc/flash_attention.cu`` (fp32) and
    ``csrc/flash_attention_sm90.cu`` (bf16): dense masked softmax
    attention in fp32; q (B,Hq,T,D), k/v (B,Hkv,S,D), the kv head of q
    head h is h // (Hq // Hkv).  Query row i is at position
    ``q_start + i`` for the causal and window masks (a rank's rows of a
    longer sequence); key j at j.  Masked scores are -1e30 and their p is
    forced to 0, so a fully masked row gives 0; output in ``q.dtype``."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, hq // hkv, t, d)
    kf = k.float()[:, :, None]
    logits = (qg @ kf.transpose(-1, -2)) * scale       # (B,Hkv,G,T,S)
    qi = torch.arange(q_start, q_start + t, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1).masked_fill(~mask, 0.0)
    o = p @ v.float()[:, :, None]
    return o.reshape(b, hq, t, d).to(q.dtype)


def decode_probs_ref(q, k_cache, pos, *, window=None, ring: bool = False,
                     scale=None, scores=None):
    """The fp32 attention weights p (B, Hkv, G, S) of
    :func:`decode_attention_ref`, before their rounding to the cache's
    type: zero where the mask leaves a slot out."""
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
    return torch.softmax(logits, dim=-1).masked_fill(~mask, 0.0)


def decode_attention_ref(q, k_cache, v_cache, pos, *, window=None,
                         ring: bool = False, scale=None, scores=None):
    """Plain version of ``csrc/decode_attention.cu``, and the decode
    step's attention wherever the kernel is not taken: one-token
    attention against a cache, the JAX package's
    ``decode_attention_jax``.

    q (B,1,H,Dh); k_cache/v_cache (B,S,Hkv,Dh); pos the position of the
    new token, a Python int or a 0-d integer tensor on q's device (the
    mask is then built on the device); the cache already holds the new
    token at its slot.  ``ring=True``
    means the cache is a rolling buffer of S slots, slot s holding
    position ``pos - ((pos - s) mod S)``.  ``scores``, if given, takes
    the raw fp32 scores (B, Hkv, G, S) before the scale and the mask: a
    rank holding a slice of the head dim passes the sum over ``model``
    of its partial scores (and ``scale`` of the whole head dim)."""
    b, _, _, dh = k_cache.shape
    p = decode_probs_ref(q, k_cache, pos, window=window, ring=ring,
                         scale=scale, scores=scores)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, q.shape[2], dh).to(q.dtype)


def linear_scan_ref(decay, k, v, r, s0):
    """Plain version of ``csrc/linear_scan.cu``: a loop over T of
    ``S = decay_t * S + k_t^T v_t; y_t = r_t S`` in fp32.

    decay/k/r (B,T,H,N); v (B,T,H,M); s0 (B,H,N,M).  Returns
    ``(y (B,T,H,M) in v.dtype, final state (B,H,N,M) fp32)``."""
    d, kk, vv, rr = (a.float() for a in (decay, k, v, r))
    state = s0.float()
    ys = []
    for t in range(kk.shape[1]):
        state = (d[:, t, :, :, None] * state
                 + kk[:, t, :, :, None] * vv[:, t, :, None, :])
        ys.append((rr[:, t, :, :, None] * state).sum(dim=-2))
    y = (torch.stack(ys, dim=1) if ys
         else torch.empty(v.shape, dtype=torch.float32, device=v.device))
    return y.to(v.dtype), state
