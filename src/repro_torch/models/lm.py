"""LM-level API in PyTorch (the port of the JAX package's
``models/lm.py``): embedding, unembedding, forward, the loss, the train,
eval, prefill and decode steps, parameter counting, and
:func:`from_jax_params` / :func:`from_jax_train_state`, which carry a
JAX parameter tree or train state across.

Training runs through :data:`~repro_torch.models.kernel_policy.TRAIN_KERNELS`
(``"flash_jax"`` attention with its hand-written backward, the
``"chunked"`` scan); the CUDA kernels of the serving default have no
backward and raise under autograd.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig
from .layers import rms_norm
from ..core.tree import leaves, tree_map, unflatten
from ..optim.adamw import AdamWState, global_norm
from .kernel_policy import DEFAULT_KERNELS, TRAIN_KERNELS, KernelPolicy
from .stack import apply_stack, dtype_of, init_cache, init_params

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
    # the scale is filled on the device, not copied from the host, so a
    # decode step that embeds its tokens can be captured
    return x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
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


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any],
            kernels: KernelPolicy = TRAIN_KERNELS, z_loss: float = 1e-4):
    """Next-token cross entropy on ``batch["labels"]`` (B, T), averaged
    over ``batch["mask"]`` (all ones when absent), plus the z-loss
    ``z_loss * mean(logsumexp^2)``; fp32 throughout.  Returns
    ``(loss, {"xent", "z_loss"})``."""
    logits = forward(params, cfg, batch, kernels)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    denom = torch.clamp_min(mask.sum(), 1.0)
    xent = (nll * mask).sum() / denom
    zl = z_loss * ((lse ** 2) * mask).sum() / denom
    return xent + zl, {"xent": xent, "z_loss": zl}


def _split(batch: Dict[str, torch.Tensor], k: int):
    """The batch as ``k`` microbatches along the batch dim (dim 1 of
    ``positions3``, which is (3, B, T))."""
    def part(key, a, i):
        if key == "positions3":
            return a.reshape(a.shape[0], k, a.shape[1] // k,
                             *a.shape[2:])[:, i]
        return a.reshape((k, a.shape[0] // k) + a.shape[1:])[i]
    return [{key: part(key, a, i) for key, a in batch.items()}
            for i in range(k)]


def make_train_step(cfg: ModelConfig, optimizer,
                    kernels: KernelPolicy = TRAIN_KERNELS):
    """Returns ``train_step(state, batch) -> (state, metrics)``; state is
    ``(params, opt_state, step)``.  The parameters are updated in place
    (``p.copy_((p + u).to(p.dtype))``, without autograd), so views of
    them stay valid; the caller's tensors need not require grad.
    ``cfg.grad_accum`` K > 1 splits the batch into K microbatches, sums
    their grads in fp32 and divides by K, and averages the loss and its
    parts, as the reference's scan over microbatches does."""

    def grads_of(params, batch):
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, aux = loss_fn(unflatten(params, live), cfg, batch, kernels)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(live, gs)]
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                unflatten(params, gs))

    def train_step(state, batch):
        params, opt_state, step = state
        k = cfg.grad_accum
        if k > 1:
            gsum, lsum, auxs = None, 0.0, []
            for micro in _split(batch, k):
                loss, aux, g = grads_of(params, micro)
                g = tree_map(lambda x: x.float(), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss
                auxs.append(aux)
            grads = tree_map(lambda x: x / k, gsum)
            loss = lsum / k
            aux = {key: torch.stack([a[key] for a in auxs]).mean()
                   for key in auxs[0]}
        else:
            loss, aux, grads = grads_of(params, batch)
        gnorm = global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), params,
                     updates)
        metrics = {"loss": loss, **aux, "grad_norm": gnorm}
        return (params, opt_state, step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, kernels: KernelPolicy = TRAIN_KERNELS):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, aux = loss_fn(params, cfg, batch, kernels)
        return {"loss": loss, **aux}
    return eval_step


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
    which are updated in place.

    ``pos`` is a Python int or a 0-d int64 tensor on the tokens' device,
    and ``pos + 1`` comes back of the same kind.  With a tensor the step
    never waits for the device: the positions are views of it, the
    cache slot is written by ``index_copy_`` and the attention mask is
    built from it on the device, so the step can be captured in a CUDA
    graph and replayed with the position advancing on the card.  Both
    kinds give the same logits and caches bit for bit."""
    assert not cfg.is_encoder, f"{cfg.name} is encoder-only: no decode step"

    def decode(params, caches, tokens, pos):
        batch = ({"tokens": tokens} if cfg.embed_inputs
                 else {"embeds": tokens})
        b = tokens.shape[0]
        if isinstance(pos, torch.Tensor):
            batch["positions"] = pos.reshape(1, 1).expand(b, 1)
            if cfg.mrope_sections is not None:
                batch["positions3"] = pos.reshape(1, 1, 1).expand(3, b, 1)
        else:
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
    return sum(math.prod(t.shape) for t in leaves(init_params(
        cfg, device="meta")))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: shared + top-k routed only)."""
    n = param_count(cfg)
    if not cfg.n_experts:
        return n
    fe = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * fe
    return n - (cfg.n_experts - cfg.top_k) * per_expert * cfg.n_layers


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


def from_jax_train_state(cfg: ModelConfig, state, device="cpu"):
    """The JAX package's train state ``(params, AdamWState(step, mu, nu),
    step)``, leaves as numpy arrays, as the port's on ``device``: the
    parameters through :func:`from_jax_params`, the fp32 moments as
    trees of the parameters' shapes, the steps as int32 scalars, all bit
    for bit."""
    params, opt_state, step = state
    step_t, mu, nu = opt_state
    params = from_jax_params(cfg, params, device)

    def moment(p, a):
        t = _to_tensor(a, device)
        if t.shape != p.shape or t.dtype != torch.float32:
            raise ValueError(f"moment {tuple(t.shape)} {t.dtype} != "
                             f"{tuple(p.shape)} float32")
        return t

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=device)

    return (params, AdamWState(step=scalar(step_t),
                               mu=tree_map(moment, params, mu),
                               nu=tree_map(moment, params, nu)),
            scalar(step))
