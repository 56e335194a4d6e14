"""Abstract stand-ins for every input of a step, placed on a mesh, with
no allocation (the port of the JAX package's ``launch/specs.py``).

Where the reference builds ``ShapeDtypeStruct``s carrying their
``NamedSharding``, the port builds DTensors whose local blocks are
``meta`` tensors (or fake ones: ``device="cpu"`` under
``torch._subclasses.fake_tensor.FakeTensorMode``), placed by the rule
tables: the
parameters and AdamW moments by :func:`param_specs`, the batch by
:func:`batch_specs`.  The decode caches follow the port's layout
(:func:`cache_layout`): split over the data axes on the batch dim, and
over ``model`` on the dims where the reference's :func:`cache_specs`
splits them and the port's compute splits the same dim.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.tree import leaves_with_paths, tree_map, unflatten
from ..models.config import ModelConfig
from ..models.stack import dtype_of, init_cache, init_params
from ..optim import AdamW
from .mesh import axis_size, dp_axes
from .sharding import (NamedSharding, batch_specs, dense_splits, place,
                       spec_for, spec_of, to_named, to_placements)


def batch_shapes(cfg: ModelConfig, kind: str, batch: int, seq: int
                 ) -> Dict[str, Any]:
    """The abstract input batch (``meta`` tensors) of a (cfg, kind)
    cell.  Archs with a stubbed frontend (audio / vision) take
    precomputed embeddings for train and prefill; decode always feeds
    tokens (text continuation)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    tok = torch.int32
    if kind == "decode":
        return {"tokens": meta((batch, 1), tok)}
    stubbed = (not cfg.embed_inputs) or cfg.mrope_sections is not None
    b: Dict[str, Any] = {}
    if stubbed:
        b["embeds"] = meta((batch, seq, cfg.d_model), dtype_of(cfg))
    else:
        b["tokens"] = meta((batch, seq), tok)
    if cfg.mrope_sections is not None:
        b["positions3"] = meta((3, batch, seq), tok)
    if kind == "train":
        b["labels"] = meta((batch, seq), tok)
    return b


# cache leaf name -> (dense layer kind, its split dim after the batch dim)
_CACHE_HEADS = {"k": ("attn", 2), "v": ("attn", 2), "ssm": ("mamba", 1),
                "conv": ("mamba", 2), "wkv": ("rwkv", 1)}


def cache_layout(mesh, cache_tree, cfg: ModelConfig,
                 attn_rule: str = "auto") -> Any:
    """The port's cache specs of ``cfg``'s whole caches ``cache_tree``:
    the batch dim (after the group dim of the ``grp`` caches) over the
    data axes, and where the layer runs split over ``model``
    (:func:`~repro_torch.launch.sharding.dense_splits` under
    ``attn_rule`` says ``"heads"`` or ``"head_dim"``) the dim the
    reference's ``cache_specs`` puts on ``model``: the kv heads of ``k``
    / ``v`` (their head dim under ``"head_dim"``), Mamba2's ``ssm``
    heads and ``conv`` channels, RWKV6's ``wkv`` heads; the rest
    whole."""
    dp = dp_axes(mesh)
    splits = dense_splits(mesh, cfg, attn_rule)

    def spec(path, t):
        lead = 1 if path.startswith("grp") else 0
        rule = [None] * t.ndim
        rule[lead] = dp
        kind, dim = _CACHE_HEADS.get(path.rpartition("/")[2], (None, 0))
        if kind is not None and splits.get(kind) == "head_dim":
            rule[lead + 3] = "model"  # (B, S, Hkv, Dh): the head dim
        elif kind is not None and splits.get(kind) == "heads":
            rule[lead + dim] = "model"
        return spec_for(mesh, t.shape, rule)
    return unflatten(cache_tree, [spec(p, t)
                                  for p, t in leaves_with_paths(cache_tree)])


def _empty(shape_tree, device):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), shape_tree)


def input_specs(cfg: ModelConfig, mesh, kind: str, batch: int, seq: int,
                *, par, device="meta"):
    """The arguments of the ``kind`` step of ``cfg`` as placed DTensors
    (``par``: the :class:`~repro_torch.launch.sharding.MeshPar` whose
    rules place the parameters): ``(state, batch)`` for train,
    ``(params, batch)`` for prefill, ``(params, caches, tokens, pos)``
    for decode (``pos`` a 0-d int64 tensor)."""
    params = par.place_params(_empty(init_params(cfg, device="meta"),
                                     device))
    shapes = batch_shapes(cfg, kind, batch, seq)
    specs = batch_specs(mesh, cfg, shapes)
    batch_dt = {k: place(torch.empty(v.shape, dtype=v.dtype, device=device),
                         mesh, specs[k]) for k, v in shapes.items()}
    if kind == "train":
        opt = par.init_optimizer(AdamW(), params)
        step = torch.zeros((), dtype=torch.int32, device=device)
        return ((params, opt._replace(step=step), step.clone()), batch_dt)
    if kind == "prefill":
        return (params, batch_dt)
    if kind == "decode":
        local_b = batch // axis_size(mesh, *dp_axes(mesh)) \
            if par.split(batch) else batch
        caches = _empty(init_cache(cfg, local_b, seq, "meta", par), device)
        layout = cache_layout(mesh, init_cache(cfg, batch, seq, "meta"), cfg,
                              par.attn_rule)
        caches = tree_map(lambda t, s: _wrap_local(t, mesh, s), caches,
                          layout)
        pos = torch.zeros((), dtype=torch.int64, device=device)
        return (params, caches, batch_dt["tokens"], pos)
    raise ValueError(kind)


def _wrap_local(t, mesh, spec):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, to_placements(mesh, spec),
                              run_check=False)


def output_shardings(cfg: ModelConfig, mesh, kind: str, args):
    """Where each output of the step lies, as
    :class:`~repro_torch.launch.sharding.NamedSharding` trees: the train
    state as its input, the metrics whole; prefill's and decode's last
    logits whole (the port gathers them over the data axes) and the
    caches in the port's layout."""
    rep = NamedSharding(mesh, ())

    def shard_of(tree):
        return tree_map(lambda t: NamedSharding(mesh, spec_of(mesh, t)),
                        tree)
    if kind == "train":
        metrics = {k: rep for k in ("loss", "xent", "z_loss", "grad_norm")}
        return (shard_of(args[0]), metrics)
    if kind == "prefill":
        if cfg.is_encoder:
            return {k: rep for k in ("loss", "xent", "z_loss")}
        batch = args[1]
        some = next(iter(batch.values()))
        b = some.shape[0] if some.shape[0] != 3 else some.shape[1]
        seq = (batch["tokens"] if "tokens" in batch else batch["embeds"]
               ).shape[1]
        whole = init_cache(cfg, b, seq, "meta")
        caches = to_named(mesh, cache_layout(mesh, whole, cfg), whole)
        return (rep, caches, rep)
    if kind == "decode":
        return (rep, shard_of(args[1]), rep)
    raise ValueError(kind)
