"""Sharding rules for parameters, batches and caches, and the
:class:`MeshPar` context (the port of the JAX package's
``launch/sharding.py``).

The rule tables are the reference's, entry for entry: data parallelism
over ``('pod', 'data')``, every weight matrix also split on one dim over
``data`` (FSDP), heads / ffw / vocab / experts' hidden dim over
``model``, and any dim that does not divide its axes left whole
(:func:`_fit`).  A spec is a tuple with one entry per dim: an axis name,
a tuple of names (split over their product, the first outermost) or
None; :func:`to_placements` turns it into DTensor placements.  The
rule functions read a mesh through :func:`~repro_torch.launch.mesh.axis_names`
and :func:`~repro_torch.launch.mesh.axis_size`, so they take a
``DeviceMesh`` or a JAX-style stand-in with ``axis_names`` and a
``shape`` mapping.  The reference's three environment knobs are
arguments here: ``NNCG_MOE`` is ``moe="tp" | "ep"``, ``NNCG_ULYSSES``
is ``ulysses`` and ``NNCG_ATTN_RULE`` is ``attn_rule="auto" |
"qshard_kvrep"``, each defaulting to the reference's behaviour with the
variable unset.

:class:`MeshPar` runs the model on a mesh in PyTorch's idiom, not
GSPMD's.  Parameters are stored as DTensors placed by
:func:`param_specs`.  A step gathers each leaf over the data axes (the
FSDP gathers; on an axis of one rank the local shard is the whole, as in
DTensor's own redistribution), and over ``model`` only where the layer
that reads it does not run split: the model sees plain tensors, this
rank's blocks over ``model`` wherever it computes on them
(:meth:`MeshPar.local_params`).  The train step sums the gradients over
the data axes straight into each rank's blocks (reduce-scatter over an
axis a leaf is split on, all-reduce over one it is not) and all-reduces
only the squared norms.

The residual stream between the layers takes the reference's
``"activations"`` rule, sequence parallelism: where the global T
divides ``model`` (:meth:`MeshPar.seq_splits`, fixed once a forward by
:meth:`MeshPar.sequence` and reported by ``describe()["activations"]``)
each rank holds its chunk of T, (b, T / model, D), and runs the norms
and residual adds on it; where it does not (decode's T = 1, a prompt of
1,537 on four ranks) the stream is whole over ``model``, as the
reference's ``spec_for`` falls back.

The dense layers are Megatron-style tensor parallel over ``model``
(:func:`dense_splits`, reported by ``describe()["dense"]``): each layer
reads its local head counts from its blocks' shapes, takes the whole
sequence in through :meth:`MeshPar.region_in` (an all-gather over T,
backward a reduce-scatter; with a whole stream the identity, backward
an all-reduce over ``model``), runs column-parallel products on this
rank's heads or hidden units and leaves through a row-parallel product
and :meth:`MeshPar.region_out` (a reduce-scatter over T, backward an
all-gather; with a whole stream an all-reduce, backward the identity).
A layer kind that runs whole gathers T on entry
(:meth:`MeshPar.whole_in`) and keeps its own chunk on exit
(:meth:`MeshPar.whole_out`).  Per layer kind:

* attention, in the reference's priority (its GSPMD constraints,
  ``constraint("heads" | "kv_heads")``), all four of its rules: kv
  heads divide ``model`` -> q and kv heads split, and so are the decode
  caches (``"heads"``); else, under ``attn_rule="qshard_kvrep"`` only,
  q heads divide and each rank's q heads fall in one kv group -> q
  heads split, ``wk`` / ``wv`` read whole and each rank projects only
  its group's k and v, or, with a cache, which stays whole, all of them
  (``"q_heads_kv_whole"``); else the head dim divides -> the decode
  caches split on the head dim, as the reference's ``cache_specs``
  splits them (``"head_dim"``); else whole.  Under ``"head_dim"`` a
  decode step takes the reference's split literally: this rank's stored
  columns of ``wq`` / ``wk`` / ``wv`` and rows of ``wo``, q, k and v
  gathered (a few KB) and rotated whole (RoPE pairs d with d + Dh/2),
  this rank's slice of the head dim written to its cache, the partial
  scores q.k^T summed over ``model`` (one (b, Hkv, G, S) fp32 tensor a
  layer) before the mask and the softmax, p.v on the slice, o gathered
  for this rank's rows of ``wo``.  Prefill and training split the same
  attention over ``model`` by query rows instead, for two reasons: a
  fused flash kernel cannot take partial scores, and summing them would
  all-reduce a (b, H, T, T) fp32 tensor every layer (about 2 GB a
  global layer's forward at ``train_4k``'s 4 x 4096 microbatch, against
  about 70 MB for the gathers below).  There the attention's leaves are
  read whole (entering through ``replicated_in``, so their gradients
  are summed over ``model``), and each rank projects q, k and v on its
  chunk of T, rotates them at those rows' positions, all-gathers k and
  v over T (backward: a reduce-scatter), runs the flash kernels for its
  rows against the whole k and v from query position ``rank * T / n``,
  and applies ``wo`` to its rows, which are the stream's chunk already;
  a prefill writes its slice of the head dim of the rotated k and v to
  its cache.  Causal work is uneven over contiguous rows: the last rank
  attends to about (2n - 1) / n^2 of the pairs, the first to 1 / n^2.
  Where the stream is whole (T does not divide ``model``) every rank
  runs the whole attention, and writes the same cache slice;
* the dense gated MLP: ``wg`` / ``wu`` column-parallel, ``wd``
  row-parallel;
* Mamba2: ``w_in`` column-parallel (its stored chunk of the ``xi | z``
  columns re-cut into this rank's chunk of each half by one uneven
  all-to-all, :meth:`MeshPar.halves`), the conv on its ``d_inner``
  channels, the partial ``B`` / ``C`` / ``dt`` products all-reduced as
  one tensor, the scan on its heads, ``w_out`` row-parallel; the conv
  and SSM caches split;
* RWKV6: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` column-parallel by heads,
  the decay's low-rank pair whole and its log cut to the local heads,
  the scan on them, ``w_o`` row-parallel; in the channel mix ``w_ck``
  column-parallel, ``w_cv`` row-parallel and reduce-scattered to this
  rank's channels, which its block of ``w_cr`` gates before they leave
  (:meth:`MeshPar.channels_out`: gathered whole, or under sequence
  parallelism one all-to-all that trades the channels for this rank's
  chunk of T); both mixes gather T once before the token shift; the wkv
  cache split, the last tokens whole;
* the vocabulary: each rank looks up the tokens in its embedding rows
  and the rows are summed over ``model`` (reduce-scattered over T under
  sequence parallelism); the head (or the tied embedding) gives this
  rank's vocabulary's logits over the whole T.  The loss reads them
  split (the reference's ``"logits"`` rule, ``describe()["logits"]``),
  through a vocab-parallel cross entropy
  (:func:`~repro_torch.models.lm.vocab_parallel_xent`: three
  all-reduces of (b, T) vectors, one of them a maximum); the sessions'
  prefill and decode logits are gathered whole.

A layer kind whose heads (or hidden units, or vocabulary) do not divide
``model`` runs whole, its leaves gathered, as do the attention leaves
where Ulysses runs.  Replicated leaves read inside a split region (the
per-head vectors, ``ln_x``) are cut there through :meth:`MeshPar.narrow`,
whose backward sums the ranks' disjoint parts, so their gradients come
out whole and equal on every ``model`` rank; the norms' weights, read
on the stream's chunk, enter through ``replicated_in`` for the same
reason (:meth:`MeshPar.sequence`), as do the attention's leaves where
``"head_dim"`` runs on rows of T.

Activations are plain local tensors: the batch is split over the data
axes, and the stream over ``model`` as above.  Three regions the
reference writes as explicit ``shard_map``s also split their work over
``model`` with explicit collectives: the tensor-parallel MoE
(:meth:`MeshPar.moe`: the whole T in, a reduce-scatter out), the
expert-parallel MoE (``moe="ep"``) and Ulysses attention
(``ulysses=True``), the last two on the stream's own chunk of T.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.tree import leaves, leaves_with_paths, tree_map, unflatten
from ..models.config import ModelConfig
from ..models.moe import moe_mlp, moe_mlp_ep
from ..models.stack import Par
from .collectives import Collectives, shard_map
from .mesh import axis_names, axis_size, dp_axes

MOE_RULES = ("tp", "ep")
ATTN_RULES = ("auto", "qshard_kvrep")


def _fit(mesh, dim_size: int, axes) -> Optional[Any]:
    """Return ``axes`` if dim_size divides the axis product, else None."""
    if axes is None:
        return None
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(n for n in names if n in axis_names(mesh))
    if not names:
        return None
    total = axis_size(mesh, *names)
    if dim_size % total:
        return None
    return names if len(names) > 1 else names[0]


def spec_for(mesh, shape, axes_per_dim) -> tuple:
    """A spec for ``shape``, dropping any entry that does not divide."""
    assert len(shape) == len(axes_per_dim)
    return tuple(_fit(mesh, s, a) for s, a in zip(shape, axes_per_dim))


# ------------------------------------------------------------- param rules --

# rules keyed by leaf name -> axes for the *unstacked* trailing dims.
_PARAM_RULES: Dict[str, Tuple] = {
    "embed":     ("model", "data"),
    "head":      ("data", "model"),
    "wq":        ("data", "model"), "wk": ("data", "model"),
    "wv":        ("data", "model"), "wo": ("model", "data"),
    "bq":        ("model",), "bk": ("model",), "bv": ("model",),
    "wg":        ("data", "model"), "wu": ("data", "model"),
    "wd":        ("model", "data"),
    "router":    ("data", None),
    "shared_wg": ("data", "model"), "shared_wu": ("data", "model"),
    "shared_wd": ("model", "data"),
    # mamba2
    "w_in":      ("data", "model"), "w_out": ("model", "data"),
    "conv_w":    (None, "model"), "conv_b": ("model",),
    "w_B":       ("model", None), "w_C": ("model", None),
    "w_dt":      ("model", None),
    # rwkv6
    "w_r":       ("data", "model"), "w_k": ("data", "model"),
    "w_v":       ("data", "model"), "w_g": ("data", "model"),
    "w_o":       ("model", "data"),
    "w_dec_A":   ("data", None), "w_dec_B": (None, "data"),
    "w_ck":      ("data", "model"), "w_cv": ("model", "data"),
    "w_cr":      ("data", "model"),
}

_MOE_3D = {"wg", "wu", "wd"}  # under an (E, ., .) expert stack


def _leaf_spec(mesh, path: str, leaf, moe: str = "tp") -> tuple:
    name = path.split("/")[-1]
    rule = _PARAM_RULES.get(name)
    if rule is None:
        return ()  # norms, scalars, decay vectors: replicated
    shape = leaf.shape
    rule = tuple(rule)
    # MoE expert stacks carry a leading E dim before the matrix dims
    if name in _MOE_3D and "mlp" in path and len(shape) >= 3 \
            and len(rule) + 1 <= len(shape):
        if moe == "ep":
            # EP-native storage: E over 'model', D over 'data' (FSDP),
            # full hidden — no per-layer reshard into the EP shard_map
            rule = ("model", "data", None) if name in ("wg", "wu") \
                else ("model", None, "data")
        else:
            rule = (None,) + rule
    # stacked group dim(s) in front
    pad = len(shape) - len(rule)
    rule = (None,) * pad + rule
    return spec_for(mesh, shape, rule)


def param_specs(mesh, params_shape_tree, moe: str = "tp"):
    """A spec tree congruent with the params tree (shapes only: tensors
    on ``meta`` will do)."""
    if moe not in MOE_RULES:
        raise ValueError(f"moe {moe!r}; expected one of {MOE_RULES}")
    return unflatten(params_shape_tree, [
        _leaf_spec(mesh, path, leaf, moe)
        for path, leaf in leaves_with_paths(params_shape_tree)])


class NamedSharding(NamedTuple):
    """A mesh and a spec: where :func:`place` puts a tensor."""
    mesh: Any
    spec: tuple


def to_named(mesh, spec_tree, like):
    """The :class:`NamedSharding` tree of ``spec_tree`` (congruent with
    ``like``, whose structure drives the walk: a spec is a tuple)."""
    return tree_map(lambda _, s: NamedSharding(mesh, s), like, spec_tree)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec) -> list:
    """DTensor placements of ``spec``, one per mesh axis: ``Shard(d)``
    on the axes dim d's entry names (nested in mesh order, which is the
    order the rules name them in), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in the "
                             f"mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_shape(mesh, shape, spec) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    return tuple(s // axis_size(mesh, *_names(e)) for s, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def local_block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        for a in _names(entry):
            t = t.chunk(axis_size(mesh, a), dim)[mesh.get_local_rank(a)]
    return t


def place(t: torch.Tensor, mesh, spec):
    """The whole tensor ``t`` (the same on every rank) as a DTensor
    placed by ``spec``: this rank keeps its block, copied out when it is
    a part of ``t`` (so ``t`` can be freed) and ``t`` itself when the
    block is the whole."""
    from torch.distributed.tensor import DTensor
    block = local_block(t, mesh, spec)
    if block.shape != t.shape:
        block = block.clone()
    return DTensor.from_local(block, mesh, to_placements(mesh, spec),
                              run_check=False)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def spec_of(mesh, t) -> tuple:
    """The spec of a DTensor's placements, without trailing whole dims
    (a plain tensor: ``()``)."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return ()
    spec = [[] for _ in range(t.ndim)]
    for name, pl in zip(axis_names(mesh), t.placements):
        if isinstance(pl, Shard):
            spec[pl.dim].append(name)
    out = [None if not e else e[0] if len(e) == 1 else tuple(e)
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# ---------------------------------------------------------------- batches --

def batch_specs(mesh, cfg: ModelConfig, batch_shapes: Dict[str, Any]):
    dp = dp_axes(mesh)
    out = {}
    for k, sds in batch_shapes.items():
        if k == "positions3":  # (3, B, T)
            out[k] = spec_for(mesh, sds.shape, (None, dp, None))
        elif k == "embeds":    # (B, T, D)
            out[k] = spec_for(mesh, sds.shape, (dp, None, None))
        else:                  # tokens/labels/mask/positions (B, T) or (B,1)
            out[k] = spec_for(mesh, sds.shape, (dp, None))
    return out


def cache_specs(mesh, cfg: ModelConfig, cache_shape_tree):
    """KV caches: batch over dp; kv-heads over 'model' when divisible,
    else head_dim.  SSM/RWKV states shard their head dim.  Prologue
    caches have one fewer leading dim than group caches: the rules are
    anchored at the tail.  These are the reference's rules; the port's
    caches take them where its compute splits the same dim, and are
    whole over ``model`` elsewhere (``launch/specs.py: cache_layout``)."""
    dp = dp_axes(mesh)
    model_n = axis_size(mesh, "model")
    kv_on_heads = cfg.n_kv_heads and cfg.n_kv_heads % model_n == 0

    def tail_rule(name, ndim):
        if name.endswith("k") or name.endswith("v"):   # (...,B,S,Hkv,Dh)
            tail = ((dp, None, "model", None) if kv_on_heads
                    else (dp, None, None, "model"))
        elif "ssm" in name:                             # (...,B,H,N,P)
            tail = (dp, "model", None, None)
        elif "conv" in name:                            # (...,B,K-1,d_inner)
            tail = (dp, None, "model")
        elif "wkv" in name:                             # (...,B,H,N,N)
            tail = (dp, "model", None, None)
        elif "prev" in name:                            # (...,B,D)
            tail = (dp, None)
        else:
            return (None,) * ndim
        return (None,) * (ndim - len(tail)) + tail

    return unflatten(cache_shape_tree, [
        spec_for(mesh, leaf.shape, tail_rule(path, leaf.ndim))
        for path, leaf in leaves_with_paths(cache_shape_tree)])


# ------------------------------------------------------------------ MoE -----

def _moe_local_specs(p_tree):
    """shard_map in_specs for the expert params: TP on the hidden dim."""
    def leaf(path, t):
        name = path.split("/")[-1]
        if name in ("wg", "wu", "shared_wg", "shared_wu"):
            return (None,) * (t.ndim - 1) + ("model",)
        if name in ("wd", "shared_wd"):
            return (None,) * (t.ndim - 2) + ("model", None)
        return ()
    return unflatten(p_tree, [leaf(path, t)
                              for path, t in leaves_with_paths(p_tree)])


def _ep_specs(p_tree):
    """shard_map in_specs of the EP region: the routed expert stacks
    split on E over 'model'; the router and shared experts whole."""
    def leaf(path, t):
        if path.split("/")[-1] in ("wg", "wu", "wd"):
            return (None,) * (t.ndim - 3) + ("model", None, None)
        return (None,) * t.ndim
    return unflatten(p_tree, [leaf(path, t)
                              for path, t in leaves_with_paths(p_tree)])


# ---------------------------------------------------- the dense split -----

# the leaves a split layer kind reads as this rank's blocks over 'model'
_SPLIT_LEAVES = {
    "attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
    "mlp": ("wg", "wu", "wd"),
    "mamba": ("w_in", "conv_w", "conv_b", "w_B", "w_C", "w_dt", "w_out"),
    "rwkv": ("w_r", "w_k", "w_v", "w_g", "w_o", "w_ck", "w_cv", "w_cr"),
    "vocab": ("embed", "head"),
}
_Q_LEAVES = ("wq", "bq", "wo")  # the attention's under "q_heads_kv_whole"
# the replicated leaves read on the residual stream itself (the norms)
_STREAM_LEAVES = ("ln1", "ln2", "ln1b", "ln2b", "final_norm")


def dense_splits(mesh, cfg: ModelConfig,
                 attn_rule: str = "auto") -> Dict[str, str]:
    """How each dense layer kind of ``cfg`` runs over ``model`` (see the
    module docstring): ``"heads"``, ``"q_heads_kv_whole"`` or
    ``"head_dim"`` (attention) or ``"whole"``, for the kinds the config
    has (``"attn"``, ``"mlp"``: the dense MLP, ``"mamba"``, ``"rwkv"``,
    ``"vocab"``).  The attention takes the reference's priority
    (``MeshPar.constraint("heads" | "kv_heads")``): kv heads divide
    ``model``; under ``attn_rule="qshard_kvrep"`` only, q heads divide
    and each rank's fall in one kv group; the head dim divides; else
    whole."""
    if attn_rule not in ATTN_RULES:
        raise ValueError(f"attn_rule {attn_rule!r}; expected one of "
                         f"{ATTN_RULES}")
    n = axis_size(mesh, "model")
    kinds = set(cfg.prologue + cfg.pattern)

    def heads(ok):
        return "heads" if ok else "whole"
    out = {}
    if kinds & set("ALS"):
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        if hkv % n == 0:
            out["attn"] = "heads"
        elif attn_rule == "qshard_kvrep" and h % n == 0 \
                and (h // hkv) % (h // n) == 0:
            out["attn"] = "q_heads_kv_whole"
        elif cfg.head_dim % n == 0:
            out["attn"] = "head_dim"
        else:
            out["attn"] = "whole"
        if "S" in kinds or not cfg.n_experts:
            out["mlp"] = heads(cfg.d_ff % n == 0)
    if "M" in kinds:
        out["mamba"] = heads((2 * cfg.d_model // cfg.ssm_head_dim) % n == 0)
    if "R" in kinds:
        out["rwkv"] = heads((cfg.d_model // cfg.ssm_head_dim) % n == 0
                            and cfg.d_ff % n == 0)
    out["vocab"] = heads(cfg.vocab_size % n == 0)
    return out


class MeshPar(Par):
    """The parallelism context bound to a ``DeviceMesh`` (see the module
    docstring).  ``moe`` picks the MoE region (``"tp"``: each rank keeps
    its ``model`` slice of the experts' hidden dim and the outputs are
    summed; ``"ep"``: tokens split on T over ``model`` and sent to their
    experts' owners); ``ulysses=True`` runs training and prefill
    attention as Ulysses sequence parallelism; ``attn_rule`` is the
    reference's ``NNCG_ATTN_RULE`` (``"auto"``, its default, or
    ``"qshard_kvrep"``: :func:`dense_splits`)."""

    def __init__(self, mesh, cfg: ModelConfig, *, moe: str = "tp",
                 ulysses: bool = False, attn_rule: str = "auto"):
        if moe not in MOE_RULES:
            raise ValueError(f"moe {moe!r}; expected one of {MOE_RULES}")
        self.mesh = mesh
        self.cfg = cfg
        self.dp = dp_axes(mesh)
        self.moe_rule = moe
        self.ulysses = bool(ulysses)
        self.attn_rule = attn_rule
        self.coll = Collectives(mesh)
        self.dense = dense_splits(mesh, cfg, attn_rule)
        # the residual stream's layout in the current forward (set by
        # :meth:`sequence`): this rank's chunk of the sequence, or whole
        self.chunked, self.seq_t = False, 0
        self.activations: Optional[str] = None  # the last forward's

    @property
    def model_n(self) -> int:
        return axis_size(self.mesh, "model")

    @property
    def model_rank(self) -> int:
        return self.coll.rank("model")

    def describe(self) -> dict:
        """The mesh, the MoE rule, Ulysses, the attention rule asked for
        (``attn_rule``), ``dense``: how each dense layer kind runs over
        ``model`` (:func:`dense_splits`; where Ulysses runs, it takes
        precedence and the attention's leaves are read whole),
        ``activations``: the residual stream's layout between the
        regions in the last forward (``"sequence"``: this rank's chunk
        of T; ``"whole"``; None before the first), and ``logits``: the
        loss's logits (``"vocab"``: this rank's vocabulary, or
        ``"whole"``)."""
        return {"mesh": {a: axis_size(self.mesh, a)
                         for a in axis_names(self.mesh)},
                "moe": self.moe_rule, "ulysses": self.ulysses,
                "attn_rule": self.attn_rule,
                "dense": dict(self.dense), "activations": self.activations,
                "logits": ("vocab" if self.dense_split("vocab") == "heads"
                           else "whole")}

    # ----------------------------------------------------- parameters --
    def param_specs(self, params):
        return param_specs(self.mesh, params, self.moe_rule)

    def place_params(self, params):
        """The whole parameter tree (the same on every rank) as DTensors
        placed by :meth:`param_specs` (DTensor leaves stay as they are)."""
        return tree_map(lambda t, s: t if is_dtensor(t) else place(
            t, self.mesh, s), params, self.param_specs(params))

    def warm_up(self, device) -> None:
        """One ``all_reduce`` on each axis's group from the current
        stream: NCCL makes a communicator at its first collective, which
        must not fall inside a CUDA graph capture."""
        for a in axis_names(self.mesh):
            self.coll.all_reduce(torch.zeros(1, device=device), a)

    def region_rule(self, t: Optional[int]) -> str:
        """The MoE region a sequence of ``t`` runs: ``"ep"`` where the
        rule asks for it and E and ``t`` divide the model axis, else
        ``"tp"`` (``t=None``: the rule as it is)."""
        if self.moe_rule == "ep" and self.cfg.n_experts % self.model_n == 0 \
                and (t is None or t % self.model_n == 0):
            return "ep"
        return "tp"

    def _region_dims(self, rule: str) -> Dict[str, Tuple[int, int]]:
        """Expert leaf name -> (dim from the end, whole size) of the dim
        the MoE region of ``rule`` splits over ``model`` (the dims of
        :func:`_moe_local_specs` and :func:`_ep_specs`)."""
        cfg = self.cfg
        if rule == "ep":
            return {n: (-3, cfg.n_experts) for n in ("wg", "wu", "wd")}
        fe = cfg.moe_d_ff or cfg.d_ff
        fs = fe * cfg.n_shared_experts
        return {"wg": (-1, fe), "wu": (-1, fe), "wd": (-2, fe),
                "shared_wg": (-1, fs), "shared_wu": (-1, fs),
                "shared_wd": (-2, fs)}

    def _region_specs(self, p, specs, rule: str):
        """``specs`` (the region's in-specs of the expert tree ``p``)
        with ``None`` for each leaf that arrived as this rank's block
        over ``model`` (its split dim short of the whole): it enters the
        region as it is."""
        dims = self._region_dims(rule)

        def leaf(path, t, spec):
            d = dims.get(path.split("/")[-1])
            return None if d is not None and t.shape[d[0]] != d[1] else spec
        return unflatten(p, [leaf(path, t, spec) for (path, t), spec
                             in spec_leaves(p, specs)])

    def gather(self, t, keep: Tuple[str, ...] = ()):
        """A DTensor's whole value as a plain tensor: all-gathered over
        each axis of more than one rank it is split over but those in
        ``keep`` (on an axis of one rank the local block is the whole);
        other leaves as they are."""
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Shard
        out = t.to_local()
        names = axis_names(self.mesh)
        for i in reversed(range(len(names))):
            pl = t.placements[i]
            if isinstance(pl, Shard) and self.mesh.size(i) > 1 \
                    and names[i] not in keep:
                out = self.coll.all_gather(out, names[i], pl.dim)
        return out

    def _kept(self, path: str, moe, attn_whole: bool) -> bool:
        """Whether the dense leaf at ``path`` is read as this rank's
        block over ``model`` (its layer runs split)."""
        parent, _, name = path.rpartition("/")
        kind = parent.rpartition("/")[2] if parent else "vocab"
        split = self.dense.get(kind, "whole")
        if parent in moe or split == "whole" or (kind == "attn"
                                                 and attn_whole):
            return False
        if split == "q_heads_kv_whole":
            return name in _Q_LEAVES
        return name in _SPLIT_LEAVES[kind]

    def local_params(self, params, t: Optional[int] = None,
                     cached: bool = False):
        """The parameters as plain tensors for a sequence of ``t``
        (``cached``: a prefill or decode step): each DTensor gathered
        whole, but for the leaves the model reads as this rank's blocks
        over ``model``, gathered over the data axes only: the dense
        leaves of every layer that runs split (:func:`dense_splits`;
        the attention's whole where Ulysses runs, a step without caches
        of a ``t`` it takes, and under ``"head_dim"`` but in a decode
        step, ``t`` 1 with caches), and the expert weights (leaves of a dict
        that holds a ``router``) whose ``model`` split is on the dim the
        MoE region of :meth:`region_rule` splits.  Plain tensors are
        taken as they are."""
        from torch.distributed.tensor import Shard
        flat = list(leaves_with_paths(params))
        moe = {path.rpartition("/")[0] for path, _ in flat
               if path.split("/")[-1] == "router"}
        dims = self._region_dims(self.region_rule(t)) if moe else {}
        model = axis_names(self.mesh).index("model")
        attn_whole = (t is not None and not cached
                      and self.ulysses_ok(self.cfg, t)) or (
            self.dense.get("attn") == "head_dim" and not (cached and t == 1))

        def leaf(path, x):
            if not is_dtensor(x):
                return x
            parent, _, name = path.rpartition("/")
            if self._kept(path, moe, attn_whole):
                return self.gather(x, keep=("model",))
            if parent in moe and name in dims:
                pl = x.placements[model]
                if isinstance(pl, Shard) and pl.dim == x.ndim + dims[name][0]:
                    return self.gather(x, keep=("model",))
            return self.gather(x)
        return unflatten(params, [leaf(path, x) for path, x in flat])

    def init_optimizer(self, optimizer, params):
        """``optimizer.init`` with the moments placed like ``params``."""
        state = optimizer.init(tree_map(_local, params))
        return state._replace(mu=self.wrap_like(state.mu, params),
                              nu=self.wrap_like(state.nu, params))

    def reduce_grads(self, grads, params):
        """This rank's blocks of the gradients summed over the data axes.
        ``grads`` are of :meth:`local_params`' tensors: per-rank partial
        sums, whole but for the blocks kept over ``model``.  Axis by
        axis in mesh order (as :func:`local_block` cuts): a data axis a
        leaf is split on is reduce-scattered on its dim, one it is not
        split on all-reduced; a ``model`` split is this rank's chunk of
        the whole gradient (every ``model`` rank holds it), or nothing
        for a block kept over ``model``.  Axes of one rank are skipped."""
        from torch.distributed.tensor import Shard
        names = axis_names(self.mesh)

        def one(g, p):
            if not is_dtensor(p):
                for a in self.dp:
                    if axis_size(self.mesh, a) > 1:
                        g = self.coll.all_reduce(g, a)
                return g
            kept = tuple(g.shape) != tuple(p.shape)
            for i, a in enumerate(names):
                if self.mesh.size(i) == 1:
                    continue
                pl = p.placements[i]
                split = isinstance(pl, Shard)
                if a in self.dp:
                    g = (self.coll.reduce_scatter(g, a, pl.dim) if split
                         else self.coll.all_reduce(g, a))
                elif split and not kept:
                    g = self.coll._take(g, a, pl.dim)
            return g
        with torch.no_grad():
            return tree_map(one, grads, params)

    def grad_norm(self, grads, params):
        """The whole gradient tree's global norm from this rank's blocks
        (:meth:`reduce_grads`): each leaf's sum of squares, all-reduced
        over the axes it is split on (one vector a mesh axis), then
        added in the order of ``optim.adamw.global_norm``."""
        from torch.distributed.tensor import Shard
        gs, ps = leaves(grads), leaves(params)
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in gs])
        for i, a in enumerate(axis_names(self.mesh)):
            split = [is_dtensor(p) and isinstance(p.placements[i], Shard)
                     for p in ps]
            if self.mesh.size(i) > 1 and any(split):
                mask = torch.tensor(split, device=sq.device)
                sq = torch.where(mask, self.coll.all_reduce(sq, a), sq)
        total = 0
        for s in sq.unbind(0):
            total = total + s
        return torch.sqrt(total)

    def optimizer_step(self, optimizer, grads, gnorm, opt_state, params):
        """The update on this rank's blocks: the gradients' blocks
        (:meth:`reduce_grads`), the norm of the whole (``gnorm``) for
        the clip, the blocks of the parameters updated in place and the
        new moments placed like them."""
        local = tree_map(_local, params)
        state = opt_state._replace(mu=tree_map(_local, opt_state.mu),
                                   nu=tree_map(_local, opt_state.nu))
        updates, state = optimizer.update(grads, state, local, norm=gnorm)
        with torch.no_grad():
            tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), local,
                     updates)
        return state._replace(mu=self.wrap_like(state.mu, params),
                              nu=self.wrap_like(state.nu, params))

    def wrap_like(self, tree, params):
        """This rank's blocks ``tree`` as DTensors placed like
        ``params``' (plain leaves of ``params``: as they are)."""
        from torch.distributed.tensor import DTensor
        return tree_map(lambda t, p: DTensor.from_local(
            t, self.mesh, p.placements, run_check=False)
            if is_dtensor(p) else t, tree, params)

    # -------------------------------------------------------- batches --
    def split(self, b: int) -> bool:
        """Whether a batch of ``b`` is split over the data axes (it
        stays whole on every data rank when it does not divide)."""
        return b % axis_size(self.mesh, *self.dp) == 0

    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """This rank's part of a global batch dict (views)."""
        shapes = {k: v for k, v in batch.items()}
        specs = batch_specs(self.mesh, self.cfg, shapes)
        return {k: local_block(v, self.mesh, specs[k])
                for k, v in batch.items()}

    def gather_batch(self, t: torch.Tensor, global_b: int) -> torch.Tensor:
        """Per-rank outputs of a split batch (batch dim first) gathered
        whole; a batch that was not split is returned as it is."""
        if not self.split(global_b):
            return t
        for a in reversed(self.dp):
            t = self.coll.gather_out(t, a, 0)
        return t

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank partial sum summed over the data axes (the same on
        every rank; backward: the identity, so each rank's gradients are
        its own part's)."""
        for a in self.dp:
            x = self.coll.all_reduce(x, a)
        return x

    # ------------------------------------------------------------ hooks --
    def seq_splits(self, t: int) -> bool:
        """Whether a sequence of ``t`` runs split over ``model`` between
        the regions: where ``t`` divides it (the reference's
        ``"activations"`` rule through ``spec_for``)."""
        return t % self.model_n == 0

    def sequence(self, params, t: int):
        """Fix the residual stream's layout for a forward over a global
        sequence of ``t`` (:meth:`seq_splits`).  Split, the norms'
        weights (read on this rank's chunk only) enter through
        ``replicated_in``, so their gradients are summed over ``model``:
        whole on every rank, as :meth:`reduce_grads` takes them; so do
        the attention's leaves under ``"head_dim"`` (each rank computes
        on its rows of T), unless Ulysses runs it."""
        self.chunked, self.seq_t = self.seq_splits(t), t
        self.activations = "sequence" if self.chunked else "whole"
        if not (self.chunked and torch.is_grad_enabled()):
            return params
        rows = self.dense.get("attn") == "head_dim" and not self.ulysses_ok(
            self.cfg, t)

        def read_on_chunk(path):
            parent, _, name = path.rpartition("/")
            return name in _STREAM_LEAVES or (
                rows and parent.rpartition("/")[2] == "attn")
        return unflatten(params, [
            self.coll.replicated_in(x, "model") if read_on_chunk(path) else x
            for path, x in leaves_with_paths(params)])

    def seq_len(self, x) -> int:
        return x.shape[1] * (self.model_n if self.chunked else 1)

    def last_position(self, x):
        """The last position, held by the last ``model`` rank, brought to
        every rank (one all-gather of each rank's last row); the stream
        is whole from here."""
        if not self.chunked:
            return x[:, -1:]
        self.chunked = False
        return self.coll.all_gather(x[:, -1:], "model", 1)[:, -1:]

    def constraint(self, x, kind: str):
        """The reference's ``"activations"`` rule: a whole (B, T, D)
        tensor entering the stream of a forward whose sequence splits is
        cut to this rank's chunk (backward: the chunks' gradients
        gathered); a chunk stays as it is.  Every other kind is the
        identity: the split regions cut their tensors themselves, and
        the loss's logits leave :func:`~repro_torch.models.lm.unembed`
        split over the vocabulary already."""
        if kind == "activations" and self.chunked and self.model_n > 1 \
                and x.shape[1] == self.seq_t:
            return self.coll.take(x, "model", 1)
        return x

    def dense_split(self, kind: str) -> str:
        return self.dense.get(kind, "whole")

    def cache_split(self, kind: str) -> int:
        return self.model_n if self.dense_split(kind) in ("heads",
                                                          "head_dim") else 1

    def region_in(self, x):
        if self.chunked:
            return self.coll.all_gather(x, "model", 1)
        return self.coll.replicated_in(x, "model")

    def region_out(self, x):
        if self.chunked:
            return self.coll.reduce_scatter(x, "model", 1)
        return self.coll.all_reduce(x, "model")

    def whole_in(self, x):
        return self.coll.gather_out(x, "model", 1) if self.chunked else x

    def whole_out(self, x):
        return self.coll.take(x, "model", 1) if self.chunked else x

    def replicated_in(self, x):
        return self.coll.replicated_in(x, "model")

    def model_sum(self, x):
        return self.coll.all_reduce(x, "model")

    def model_max(self, x):
        return self.coll.all_reduce_max(x, "model")

    def scatter_out(self, x, dim: int):
        return self.coll.reduce_scatter(x, "model", dim)

    def gather_out(self, x, dim: int):
        return self.coll.gather_out(x, "model", dim)

    def seq_gather(self, x):
        return self.coll.all_gather(x, "model", 1) if self.chunked else x

    def channels_out(self, x):
        """Gathered whole over the channels, or under sequence
        parallelism exchanged for this rank's chunk of T with every
        channel (one all-to-all; backward: the exchange back)."""
        if self.chunked:
            return self.coll.all_to_all(x, "model", 1, x.ndim - 1)
        return self.coll.gather_out(x, "model", -1)

    def narrow(self, x, dim: int, start: int, length: int):
        if length == x.shape[dim]:
            return x
        return self.coll.replicated_in(x, "model").narrow(dim, start, length)

    def halves(self, y):
        """Of ``2n`` column pieces ``[a_0 .. a_{n-1} | b_0 .. b_{n-1}]``
        rank r holds pieces 2r and 2r + 1 (its contiguous chunk) and
        needs a_r and b_r: each piece goes to rank ``piece mod n`` in
        one uneven all-to-all (over a ``model`` axis of one rank, ``y``
        as it is)."""
        n = self.model_n
        if n == 1:
            return y
        r = self.model_rank
        parts = y.unflatten(-1, (2, y.shape[-1] // 2)).movedim(-2, 0)
        dest = [(2 * r + i) % n for i in (0, 1)]
        src = [r // 2, (n + r) // 2]  # of a_r, then b_r
        order = sorted((0, 1), key=dest.__getitem__)
        got = self.coll.all_to_all_v(
            parts[list(order)], "model", [dest.count(j) for j in range(n)],
            [src.count(j) for j in range(n)])
        return got.movedim(0, -2).flatten(-2)

    def moe(self, x, p, cfg: ModelConfig):
        """x: (b, T, D) this rank's tokens, in the stream's layout -> the
        same layout.  EP where the rule asks for it and E and T divide
        the model axis, else TP: the whole sequence enters through
        :meth:`region_in` and the ranks' partial sums leave through
        :meth:`region_out` (under sequence parallelism an all-gather and
        a reduce-scatter over T; the capacity counts the whole call's
        tokens, as in the reference).  The reference also requires the
        global batch to divide the data axes; here the batch was split
        (or kept whole) before the stack, so the EP region never needs
        it."""
        if self.region_rule(self.seq_len(x)) == "ep":
            return self._moe_ep(x, p, cfg)

        def _moe(x_local, p_local):
            bl, tl, dl = x_local.shape
            return moe_mlp(x_local.reshape(bl * tl, dl), p_local,
                           top_k=cfg.top_k, act=cfg.act,
                           capacity_factor=cfg.capacity_factor
                           ).reshape(bl, tl, dl)

        y = shard_map(_moe, self.coll, (None, self._region_specs(
            p, _moe_local_specs(p), "tp")), (self.dp, None, None))(
                self.region_in(x), p)
        return self.region_out(y)

    def _moe_ep(self, x, p, cfg: ModelConfig):
        """Expert-parallel MoE: tokens split on T over 'model' (the
        stream's own chunk: T divides the axis), experts on E (full
        hidden), all_to_all routing."""
        assert self.chunked, "the EP region takes the stream's T chunk"
        group = self.coll.on("model")

        def _moe(x_local, p_local):
            bl, tl, dl = x_local.shape
            y = moe_mlp_ep(x_local.reshape(bl * tl, dl), p_local,
                           top_k=cfg.top_k, group=group, act=cfg.act,
                           capacity_factor=cfg.capacity_factor)
            return y.reshape(bl, tl, dl)

        return shard_map(_moe, self.coll, (None, self._region_specs(
            p, _ep_specs(p), "ep")), (self.dp, None, None))(x, p)

    def ulysses_ok(self, cfg: ModelConfig, t: int) -> bool:
        """Ulysses attention: q heads and T must divide the model axis;
        kv heads either divide (all_to_all) or are few enough to gather
        (GQA kv-replication).  Training / prefill only."""
        model_n = self.model_n
        if not (self.ulysses and cfg.n_heads and cfg.n_heads % model_n == 0
                and t % model_n == 0 and cfg.mrope_sections is None):
            return False
        if cfg.n_kv_heads % model_n == 0:
            return True
        h_loc = cfg.n_heads // model_n
        g = cfg.n_heads // cfg.n_kv_heads
        return h_loc % g == 0 or g % h_loc == 0  # group-aligned kv slice

    def ulysses_attention(self, x, p, cfg: ModelConfig, kind: str,
                          positions):
        """qkv on the stream's T chunk (T divides the axis) -> all_to_all
        (T <-> heads) -> full-T attention on H/model local heads ->
        all_to_all back to the chunk.  The weights are whole on every
        rank."""
        from ..models.attention_vjp import flash_mha, local_mha
        from ..models.layers import linear, rope
        coll, model_n = self.coll, self.model_n
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def _attn(x_loc, w, pos):
            b, t_loc, _ = x_loc.shape

            def proj(name, bias, heads):
                y = linear(x_loc, w[name], w.get(bias)).reshape(
                    b, t_loc, heads, dh)
                if heads % model_n == 0:
                    # T-split -> head-split (full T locally)
                    return coll.all_to_all(y, "model", 2, 1)
                # GQA kv-replication: gather the (small) kv over T, then
                # keep only the kv group(s) of this rank's q heads
                y = coll.all_gather(y, "model", 1)
                h_loc = h // model_n
                n_kv_loc = max(h_loc // (h // hkv), 1)
                start = (coll.rank("model") * h_loc) // (h // hkv)
                return y[:, :, start:start + n_kv_loc]

            q = rope(proj("wq", "bq", h), pos, cfg.rope_theta, cfg.rope_dim)
            k = rope(proj("wk", "bk", hkv), pos, cfg.rope_theta,
                     cfg.rope_dim)
            v = proj("wv", "bv", hkv)
            if kind == "L" and cfg.window is not None:
                o = local_mha(q, k, v, cfg.window)
            else:
                o = flash_mha(q, k, v, cfg.causal, None)
            o = coll.all_to_all(o, "model", 1, 2)
            return linear(o.reshape(b, t_loc, h * dh), w["wo"])

        w_specs = tree_map(lambda t: (None,) * t.ndim, p)
        return shard_map(_attn, coll, (None, w_specs, (self.dp, None)),
                         (self.dp, None, None))(x, p, positions)


def spec_leaves(tree, specs) -> list:
    """``((path, leaf), spec)`` of every leaf of ``tree`` with its spec
    in the congruent ``specs`` (whose tuples are leaves, not nodes)."""
    out = []
    tree_map(lambda _, s: out.append(s), tree, specs)
    return list(zip(leaves_with_paths(tree), out))
