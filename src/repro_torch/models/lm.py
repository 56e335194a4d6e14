"""LM-level API in PyTorch (the port of the JAX package's
``models/lm.py``): embedding, unembedding, forward, the loss, the train,
eval, prefill and decode steps, parameter counting, and
:func:`from_jax_params` / :func:`from_jax_train_state`, which carry a
JAX parameter tree or train state across.

Training runs through :data:`~repro_torch.models.kernel_policy.TRAIN_KERNELS`
(``"flash_jax"`` attention with its hand-written backward, the
``"chunked"`` scan); the CUDA kernels of the serving default have no
backward and raise under autograd.

Every function takes the reference's ``par``: ``None`` is the
single-device path, and a :class:`repro_torch.launch.sharding.MeshPar`
runs it on a mesh.  There the step functions take and return the global
batch and outputs: they split the batch over the data axes, gather the
outputs back, and the train step sums the gradients over the data
axes into each rank's blocks (after the microbatch sum, before the norm
and AdamW) and updates each rank's blocks of the parameters and
moments.  ``forward`` and ``loss_fn`` take the rank's own part of the
batch; the loss is the masked mean over the whole batch.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig
from .layers import rms_norm
from ..core.tree import leaves, tree_map, unflatten
from ..optim.adamw import AdamWState
from .kernel_policy import DEFAULT_KERNELS, TRAIN_KERNELS, KernelPolicy
from .stack import (DEFAULT_PAR, Par, apply_stack, dtype_of, init_cache,
                    init_params)

# vocabulary columns unembedded at once in fp32 (bounds the temporary)
UNEMBED_CHUNK = 32768


def embed_tokens(params, cfg: ModelConfig, tokens_or_embeds: torch.Tensor,
                 par: Optional[Par] = None):
    """Token ids -> embedding rows scaled by sqrt(d_model) in the
    activation type (the scale itself rounded to that type, as in the
    reference); float inputs (audio frames, patch embeddings) pass
    through in the model's type.  With a ``par`` that splits the
    vocabulary over ``model``, ``params["embed"]`` is this rank's rows:
    it looks up the tokens that fall in them, zeroes the others, and the
    ranks' rows are summed over ``model`` (one is nonzero: exact) into
    the residual stream's layout (``par.region_out``: under sequence
    parallelism a reduce-scatter over T).  Otherwise the rows are whole,
    and :func:`forward` cuts them (``par.constraint(x, "activations")``)."""
    if tokens_or_embeds.is_floating_point():
        return tokens_or_embeds.to(dtype_of(cfg))
    par = par or DEFAULT_PAR
    table = params["embed"]
    split = par.dense_split("vocab") != "whole"
    if split:
        rows = table.shape[0]
        idx = tokens_or_embeds - par.model_rank * rows
        mine = (idx >= 0) & (idx < rows)
        x = table[idx.clamp(0, rows - 1)].masked_fill(~mine[..., None], 0)
    else:
        x = table[tokens_or_embeds]
    # the scale is filled on the device, not copied from the host, so a
    # decode step that embeds its tokens can be captured
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                       device=x.device)
    return par.region_out(x) if split else x


def unembed(params, cfg: ModelConfig, x: torch.Tensor,
            par: Optional[Par] = None, split_logits: bool = False
            ) -> torch.Tensor:
    """(B, T, D) -> float32 logits (B, T, V): the products of the model's
    values summed in fp32 and kept in fp32, one vocabulary chunk at a
    time, so a bf16 model's fp32 head copy stays small.  ``x`` is in the
    ``par``'s stream layout; the head reads the whole sequence.  With a
    ``par`` that splits the vocabulary over ``model`` the head (or the
    tied embedding) is this rank's vocabulary, and its logits are
    gathered whole over ``model``, or kept as this rank's (B, T, V /
    model) with ``split_logits`` (the reference's ``"logits"`` rule, which
    :func:`loss_fn` reads)."""
    par = par or DEFAULT_PAR
    split = par.dense_split("vocab") != "whole"
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    xf = (par.region_in(x) if split else par.whole_in(x)).float()
    if head.dtype == torch.float32:
        out = xf @ head
    else:
        v = head.shape[1]
        out = torch.empty(xf.shape[:-1] + (v,), dtype=torch.float32,
                          device=x.device)
        for c0 in range(0, v, UNEMBED_CHUNK):
            out[..., c0:c0 + UNEMBED_CHUNK] = xf @ head[
                :, c0:c0 + UNEMBED_CHUNK].float()
    return par.gather_out(out, -1) if split and not split_logits else out


def forward(params, cfg: ModelConfig, batch: Dict[str, Any],
            kernels: KernelPolicy = DEFAULT_KERNELS, caches=None,
            pos: Optional[int] = None, last_only: bool = False,
            par: Optional[Par] = None,
            split_logits: bool = False) -> torch.Tensor:
    """batch: {'tokens' (B,T) int | 'embeds' (B,T,D), optional
    'positions' (B,T), optional 'positions3' (3,B,T)}.  Returns float32
    logits (B, T, V), or (B, 1, V) of the last position when
    ``last_only`` (the same numbers: norm and unembedding are per
    position).  ``caches`` are updated in place.  With a mesh ``par``
    the parameters may be DTensors (gathered here, but for the blocks
    that the split layers and the MoE region read as they are) and
    ``batch`` is this rank's part; ``par.sequence`` fixes the residual
    stream's layout from the global T (under sequence parallelism this
    rank's chunk of T between the regions), and ``split_logits`` keeps
    the logits of a vocabulary split over ``model`` as this rank's
    (:func:`unembed`)."""
    par = par or DEFAULT_PAR
    inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
    b, t = inp.shape[:2]
    params = par.sequence(par.local_params(params, t, caches is not None),
                          t)
    x = par.constraint(embed_tokens(params, cfg, inp, par), "activations")
    positions = batch.get("positions")
    if positions is None:
        positions = (torch.arange(t, device=x.device)[None]
                     + (0 if pos is None else pos)).expand(b, t)
    x = apply_stack(x, params, cfg, kernels, positions=positions,
                    caches=caches, pos=pos, pos3=batch.get("positions3"),
                    par=par)
    if last_only:
        x = par.last_position(x)
    return par.constraint(unembed(params, cfg, rms_norm(
        x, params["final_norm"], cfg.norm_eps), par, split_logits),
        "logits")


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any],
            kernels: KernelPolicy = TRAIN_KERNELS, z_loss: float = 1e-4,
            par: Optional[Par] = None):
    """Next-token cross entropy on ``batch["labels"]`` (B, T), averaged
    over ``batch["mask"]`` (all ones when absent), plus the z-loss
    ``z_loss * mean(logsumexp^2)``; fp32 throughout.  Returns
    ``(loss, {"xent", "z_loss"})``.  With a mesh ``par`` ``batch`` is
    this rank's part, and the sums and the mask's count are summed over
    the data axes before the division: the loss is the whole batch's,
    the same on every rank, and this rank's gradients are its part's
    share of the whole batch's.  Where the vocabulary splits over
    ``model`` the loss reads this rank's vocabulary's logits only
    (:func:`vocab_parallel_xent`)."""
    par = par or DEFAULT_PAR
    logits = forward(params, cfg, batch, kernels, par=par, split_logits=True)
    labels = batch["labels"].long()
    if par.dense_split("vocab") == "whole":
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        lse, gold = vocab_parallel_xent(logits, labels, par)
    nll = lse - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    denom = torch.clamp_min(par.data_sum(mask.sum()), 1.0)
    xent = par.data_sum((nll * mask).sum()) / denom
    zl = z_loss * par.data_sum(((lse ** 2) * mask).sum()) / denom
    return xent + zl, {"xent": xent, "z_loss": zl}


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        par: Par):
    """``(logsumexp, gold logit)`` over a vocabulary split over
    ``model``, from this rank's (B, T, V / model) fp32 ``logits``: each
    rank's logsumexp of its rows, their maximum over ``model`` (detached:
    only a shift), ``lse = max + log(sum over ranks of exp(lse_r -
    max))``, and the label's logit from the rank whose rows hold it (a
    masked gather summed over ``model``).  The sums' backward is the
    identity (every rank computes the same loss), so each rank's gradient
    reaches its own rows only.  On one rank the numbers are
    ``torch.logsumexp``'s and ``torch.gather``'s bit for bit."""
    rows = logits.shape[-1]
    part = torch.logsumexp(logits, dim=-1)
    top = par.model_max(part.detach())
    lse = top + torch.log(par.model_sum(torch.exp(part - top)))
    idx = labels - par.model_rank * rows
    mine = (idx >= 0) & (idx < rows)
    gold = torch.gather(logits, -1, idx.clamp(0, rows - 1)[..., None])[..., 0]
    return lse, par.model_sum(gold.masked_fill(~mine, 0.0))


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
                    kernels: KernelPolicy = TRAIN_KERNELS,
                    par: Optional[Par] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; state is
    ``(params, opt_state, step)``.  The parameters are updated in place
    (``p.copy_((p + u).to(p.dtype))``, without autograd), so views of
    them stay valid; the caller's tensors need not require grad.
    ``cfg.grad_accum`` K > 1 splits the batch into K microbatches, sums
    their grads in fp32 and divides by K, and averages the loss and its
    parts, as the reference's scan over microbatches does.  With a mesh
    ``par`` the state is placed by it (``par.place_params``,
    ``par.init_optimizer``), each microbatch is split over the data axes
    (its loss is the whole microbatch's), and the gradients are summed
    over them into each rank's blocks after the microbatch sum."""
    par = par or DEFAULT_PAR

    def grads_of(params, batch):
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, aux = loss_fn(unflatten(params, live), cfg,
                            par.local_batch(batch), kernels, par=par)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(live, gs)]
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                unflatten(params, gs))

    def train_step(state, batch):
        params, opt_state, step = state
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        whole = par.local_params(params, inp.shape[1])
        k = cfg.grad_accum
        if k > 1:
            gsum, lsum, auxs = None, 0.0, []
            for micro in _split(batch, k):
                loss, aux, g = grads_of(whole, micro)
                g = tree_map(lambda x: x.float(), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss
                auxs.append(aux)
            grads = tree_map(lambda x: x / k, gsum)
            loss = lsum / k
            aux = {key: torch.stack([a[key] for a in auxs]).mean()
                   for key in auxs[0]}
        else:
            loss, aux, grads = grads_of(whole, batch)
        grads = par.reduce_grads(grads, params)
        gnorm = par.grad_norm(grads, params)
        opt_state = par.optimizer_step(optimizer, grads, gnorm, opt_state,
                                       params)
        metrics = {"loss": loss, **aux, "grad_norm": gnorm}
        return (params, opt_state, step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, kernels: KernelPolicy = TRAIN_KERNELS,
                   par: Optional[Par] = None):
    par = par or DEFAULT_PAR

    def eval_step(params, batch):
        with torch.no_grad():
            loss, aux = loss_fn(params, cfg, par.local_batch(batch), kernels,
                                par=par)
        return {"loss": loss, **aux}
    return eval_step


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      kernels: KernelPolicy = DEFAULT_KERNELS,
                      par: Optional[Par] = None):
    """prefill(params, batch) -> (last_logits (B,V), caches, next_pos).
    With a mesh ``par`` the caches are this rank's block: its part of
    the batch, and its heads where the layers run split."""
    par = par or DEFAULT_PAR

    def prefill(params, batch):
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        b, t = inp.shape[:2]
        local = par.local_batch(batch)
        b_loc = local["embeds" if "embeds" in local else "tokens"].shape[0]
        caches = init_cache(cfg, b_loc, max_len, inp.device, par)
        logits = forward(params, cfg, local, kernels, caches=caches, pos=0,
                         last_only=True, par=par)
        return par.gather_batch(logits[:, -1], b), caches, t

    return prefill


def make_decode_step(cfg: ModelConfig,
                     kernels: KernelPolicy = DEFAULT_KERNELS,
                     par: Optional[Par] = None):
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
    par = par or DEFAULT_PAR

    def decode(params, caches, tokens, pos):
        b_global = tokens.shape[0]
        key = "tokens" if cfg.embed_inputs else "embeds"
        batch = par.local_batch({key: tokens})
        tokens = batch[key]
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
                         pos=pos, par=par)
        return par.gather_batch(logits[:, -1], b_global), caches, pos + 1

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
