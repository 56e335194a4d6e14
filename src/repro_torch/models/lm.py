"""LM-level API in PyTorch (the serving half of the JAX package's
``models/lm.py``): embedding, unembedding, forward, the prefill and
decode steps, parameter counting, and :func:`from_jax_params`, which
carries a JAX ``init_params`` tree across.  The loss and the train step
wait for the training slice (ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig
from .layers import rms_norm
from .kernel_policy import DEFAULT_KERNELS, KernelPolicy
from .stack import (apply_stack, check_supported, dtype_of, init_cache,
                    init_params)

# vocabulary columns unembedded at once in fp32 (bounds the temporary)
UNEMBED_CHUNK = 32768


def embed_tokens(params, cfg: ModelConfig, tokens_or_embeds: torch.Tensor):
    """Token ids -> embedding rows scaled by sqrt(d_model) in the
    activation type (the scale itself rounded to that type, as in the
    reference); float inputs (audio frames, patch embeddings) pass
    through in the model's type."""
    if tokens_or_embeds.is_floating_point():
        return tokens_or_embeds.to(dtype_of(cfg))
    x = params["embed"][tokens_or_embeds]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> float32 logits (B, T, V): the products of the model's
    values summed in fp32 and kept in fp32, one vocabulary chunk at a
    time, so a bf16 model's fp32 head copy stays small."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    xf = x.float()
    if head.dtype == torch.float32:
        return xf @ head
    v = head.shape[1]
    out = torch.empty(x.shape[:-1] + (v,), dtype=torch.float32,
                      device=x.device)
    for c0 in range(0, v, UNEMBED_CHUNK):
        out[..., c0:c0 + UNEMBED_CHUNK] = xf @ head[:, c0:c0 + UNEMBED_CHUNK
                                                    ].float()
    return out


def forward(params, cfg: ModelConfig, batch: Dict[str, Any],
            kernels: KernelPolicy = DEFAULT_KERNELS, caches=None,
            pos: Optional[int] = None, last_only: bool = False
            ) -> torch.Tensor:
    """batch: {'tokens' (B,T) int | 'embeds' (B,T,D), optional
    'positions' (B,T), optional 'positions3' (3,B,T)}.  Returns float32
    logits (B, T, V), or (B, 1, V) of the last position when
    ``last_only`` (the same numbers: norm and unembedding are per
    position).  ``caches`` are updated in place."""
    inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
    x = embed_tokens(params, cfg, inp)
    b, t = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = (torch.arange(t, device=x.device)[None]
                     + (0 if pos is None else pos)).expand(b, t)
    x = apply_stack(x, params, cfg, kernels, positions=positions,
                    caches=caches, pos=pos, pos3=batch.get("positions3"))
    if last_only:
        x = x[:, -1:]
    return unembed(params, cfg, rms_norm(x, params["final_norm"],
                                         cfg.norm_eps))


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      kernels: KernelPolicy = DEFAULT_KERNELS):
    """prefill(params, batch) -> (last_logits (B,V), caches, next_pos)."""

    def prefill(params, batch):
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        b, t = inp.shape[:2]
        caches = init_cache(cfg, b, max_len, inp.device)
        logits = forward(params, cfg, batch, kernels, caches=caches, pos=0,
                         last_only=True)
        return logits[:, -1], caches, t

    return prefill


def make_decode_step(cfg: ModelConfig,
                     kernels: KernelPolicy = DEFAULT_KERNELS):
    """decode(params, caches, tokens (B,1) | embeds, pos) ->
    (logits (B,V), caches, pos+1): one new token against the caches,
    which are updated in place."""
    assert not cfg.is_encoder, f"{cfg.name} is encoder-only: no decode step"

    def decode(params, caches, tokens, pos: int):
        batch = ({"tokens": tokens} if cfg.embed_inputs
                 else {"embeds": tokens})
        b = tokens.shape[0]
        batch["positions"] = torch.full((b, 1), pos, dtype=torch.int64,
                                        device=tokens.device)
        if cfg.mrope_sections is not None:
            batch["positions3"] = torch.full((3, b, 1), pos,
                                             dtype=torch.int64,
                                             device=tokens.device)
        logits = forward(params, cfg, batch, kernels, caches=caches,
                         pos=pos)
        return logits[:, -1], caches, pos + 1

    return decode


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from the shapes alone (the meta device)."""
    return sum(math.prod(t.shape) for t in _leaves(init_params(
        cfg, device="meta")))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":  # numpy's bf16 extension type
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(cfg: ModelConfig, tree, device="cpu") -> Dict[str, Any]:
    """The JAX package's ``init_params`` tree, with its leaves as numpy
    arrays (nested dicts and lists; group-stacked leaves with a leading
    ``n_groups`` axis), as the port's parameters on ``device``: the same
    tree of tensors, bit for bit.  Raises unless every key and shape
    matches :func:`init_params` of ``cfg``."""
    check_supported(cfg)
    want = init_params(cfg, device="meta")

    def conv(w, got, path):
        if isinstance(w, dict):
            if not isinstance(got, dict) or set(got) != set(w):
                raise ValueError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(w)}")
            return {k: conv(w[k], got[k], f"{path}/{k}") for k in w}
        if isinstance(w, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(w):
                raise ValueError(f"{path}: expected a list of {len(w)}")
            return [conv(a, b, f"{path}/{i}")
                    for i, (a, b) in enumerate(zip(w, got))]
        t = _to_tensor(got, device)
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(w.shape)} {w.dtype}")
        return t

    return conv(want, tree, "params")
