"""Collectives on a mesh's named axes, and the port's ``shard_map``.

:class:`Collectives` wraps ``all_reduce``, ``all_gather``,
``all_to_all_single`` and ``reduce_scatter`` on the process group of
one named axis of a ``DeviceMesh``, with the tiled semantics of
``jax.lax``'s (a gathered or exchanged dim is split into the axis's
ranks' chunks in rank order).  Every wrapper issues its collective,
also on a group of one rank, so that a run on one card drives NCCL; on
the ``fake`` backend (the dry-run) the call returns at once.  Each call
is counted by kind (the HLO names: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``) with the bytes of its local operand;
the dry-run reads the counts where the JAX package parses its HLO.

The wrappers are autograd functions, so the regions they run in train.
Their backward follows the port's convention for activations: a tensor
that is replicated over an axis holds, on every rank, the whole
derivative of the loss.  So ``all_reduce``'s backward is the identity
(the sum's output is replicated), ``all_gather``'s a ``reduce_scatter``
(each rank's use of the gathered tensor contributes a part),
``all_to_all``'s (and ``all_to_all_v``'s) the inverse exchange,
``reduce_scatter``'s an ``all_gather``;
:meth:`Collectives.replicated_in` is the identity
forward and an ``all_reduce`` backward (a replicated tensor entering
rank-specific work), :meth:`Collectives.gather_out` gathers a split
tensor back to a replicated one (backward: each rank's own chunk), and
:meth:`Collectives.take` is its converse: this rank's chunk of a
replicated tensor (backward: the chunks' gradients gathered, so every
rank holds the whole).  :meth:`Collectives.all_reduce_max` is the one
collective outside autograd: the maximum over an axis, of a tensor that
carries no gradient.

:func:`shard_map` is the counterpart of ``jax.experimental.shard_map``
for the port's layout: activations are already split over the data
axes and replicated over the others, so it slices each input along the
dims its spec names a mapped axis on, runs the local function on plain
tensors, and gathers each output along the dims its out-spec names a
mapped axis on.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from ..core.tree import tree_map
from .mesh import axis_names

# torch renamed the tensor forms of these two; older releases have only
# the first names
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _chunks(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x as (n, *chunk) along ``dim`` (contiguous)."""
    return torch.stack(x.chunk(n, dim))


def _flat0(t: torch.Tensor) -> torch.Tensor:
    """(n, a, ...) as (n * a, ...): the ranks' blocks end to end on dim
    0, the layout the tensor forms of all-gather and reduce-scatter use."""
    return t.view((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


class Collectives:
    """The wrappers over ``mesh``'s axis groups, counting as they go
    (``count_by_kind``, ``bytes_by_kind``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.count_by_kind: Dict[str, int] = {}
        self.bytes_by_kind: Dict[str, int] = {}

    # ---------------------------------------------------------- axes --
    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def size(self, axis: str) -> int:
        return self.mesh.size(axis_names(self.mesh).index(axis))

    def rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    # -------------------------------------------------------- counts --
    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.bytes_by_kind[kind] = (self.bytes_by_kind.get(kind, 0)
                                    + x.numel() * x.element_size())

    def summary(self) -> dict:
        """The dry-run's ``collectives`` record."""
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": sum(self.bytes_by_kind.values())}

    def reset(self) -> None:
        self.count_by_kind.clear()
        self.bytes_by_kind.clear()

    # ------------------------------------------ the raw collectives --
    def _all_reduce(self, x, axis):
        self._count("all-reduce", x)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group(axis))
        return out

    def _all_gather(self, x, axis, dim):
        self._count("all-gather", x)
        n = self.size(axis)
        out = x.new_empty((n,) + tuple(x.shape))
        _all_gather(_flat0(out), x.contiguous(), group=self.group(axis))
        return torch.cat(out.unbind(0), dim)

    def _reduce_scatter(self, x, axis, dim):
        self._count("reduce-scatter", x)
        chunks = _chunks(x, self.size(axis), dim)
        out = x.new_empty(chunks.shape[1:])
        _reduce_scatter(out, _flat0(chunks), group=self.group(axis))
        return out

    def _all_to_all(self, x, axis, split_dim, concat_dim):
        self._count("all-to-all", x)
        chunks = _chunks(x, self.size(axis), split_dim)
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks, group=self.group(axis))
        return torch.cat(out.unbind(0), concat_dim)

    def _all_to_all_v(self, x, axis, send, recv):
        self._count("all-to-all", x)
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(recv), list(send),
                               group=self.group(axis))
        return out

    def _take(self, x, axis, dim):
        return x.chunk(self.size(axis), dim)[self.rank(axis)]

    def all_reduce_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The elementwise maximum over ``axis`` (replicated result) of a
        tensor that carries no gradient (counted as an all-reduce)."""
        self._count("all-reduce", x)
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group(axis))
        return out

    # ----------------------------------- the autograd-aware wrappers --
    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` (replicated result; backward: identity)."""
        return _Op.apply(x, self, "all_reduce", (axis,))

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order
        (backward: ``reduce_scatter``)."""
        return _Op.apply(x, self, "all_gather", (axis, dim))

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """The sum over ``axis``, this rank's chunk along ``dim``
        (backward: ``all_gather``)."""
        return _Op.apply(x, self, "reduce_scatter", (axis, dim))

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``x`` split along ``split_dim`` into the ranks' chunks, chunk
        j sent to rank j, the received chunks concatenated along
        ``concat_dim`` in rank order (``jax.lax.all_to_all(...,
        tiled=True)``)."""
        return _Op.apply(x, self, "all_to_all", (axis, split_dim, concat_dim))

    def all_to_all_v(self, x: torch.Tensor, axis: str, send, recv
                     ) -> torch.Tensor:
        """Uneven exchange along dim 0: ``x``'s first ``send[0]`` rows
        to rank 0, the next ``send[1]`` to rank 1, ...; ``recv[j]`` rows
        received from rank j, in rank order (backward: the exchange
        back, ``send`` and ``recv`` swapped)."""
        return _Op.apply(x, self, "all_to_all_v", (axis, tuple(send),
                                                   tuple(recv)))

    def replicated_in(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Identity; backward ``all_reduce`` over ``axis``."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x  # no backward to carry: nothing to record
        return _Op.apply(x, self, "replicated_in", (axis,))

    def gather_out(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """A split tensor gathered to a replicated one along ``dim``
        (backward: this rank's chunk of the replicated gradient)."""
        return _Op.apply(x, self, "gather_out", (axis, dim))

    def take(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of a replicated tensor
        (backward: the ranks' chunks of the gradient gathered whole)."""
        return _Op.apply(x, self, "take", (axis, dim))

    def on(self, axis: str) -> "Axis":
        return Axis(self, axis)


# forward and backward of each wrapper, in terms of the raw calls
_FORWARD = {
    "all_reduce": lambda c, x, a: c._all_reduce(x, a),
    "all_gather": lambda c, x, a, d: c._all_gather(x, a, d),
    "reduce_scatter": lambda c, x, a, d: c._reduce_scatter(x, a, d),
    "all_to_all": lambda c, x, a, s, d: c._all_to_all(x, a, s, d),
    "all_to_all_v": lambda c, x, a, s, r: c._all_to_all_v(x, a, s, r),
    "replicated_in": lambda c, x, a: x.view_as(x),
    "gather_out": lambda c, x, a, d: c._all_gather(x, a, d),
    "take": lambda c, x, a, d: c._take(x, a, d).contiguous(),
}
_BACKWARD = {
    "all_reduce": lambda c, g, a: g,
    "all_gather": lambda c, g, a, d: c._reduce_scatter(g, a, d),
    "reduce_scatter": lambda c, g, a, d: c._all_gather(g, a, d),
    "all_to_all": lambda c, g, a, s, d: c._all_to_all(g, a, d, s),
    "all_to_all_v": lambda c, g, a, s, r: c._all_to_all_v(g, a, r, s),
    "replicated_in": lambda c, g, a: c._all_reduce(g, a),
    "gather_out": lambda c, g, a, d: c._take(g, a, d).contiguous(),
    "take": lambda c, g, a, d: c._all_gather(g, a, d),
}


class _Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, op, args):
        ctx.coll, ctx.op, ctx.args = coll, op, args
        return _FORWARD[op](coll, x, *args)

    @staticmethod
    def backward(ctx, g):
        return _BACKWARD[ctx.op](ctx.coll, g, *ctx.args), None, None, None


class Axis:
    """One named axis of a :class:`Collectives`: what
    :func:`repro_torch.models.moe.moe_mlp_ep` and
    :func:`repro_torch.optim.compress.compress_allreduce` take as their
    ``group``."""

    def __init__(self, coll: Collectives, axis: str):
        self.coll, self.axis = coll, axis

    def size(self) -> int:
        return self.coll.size(self.axis)

    def rank(self) -> int:
        return self.coll.rank(self.axis)

    def all_reduce(self, x):
        return self.coll.all_reduce(x, self.axis)

    def all_gather(self, x, dim: int):
        return self.coll.all_gather(x, self.axis, dim)

    def reduce_scatter(self, x, dim: int):
        return self.coll.reduce_scatter(x, self.axis, dim)

    def all_to_all(self, x, split_dim: int, concat_dim: int):
        return self.coll.all_to_all(x, self.axis, split_dim, concat_dim)


def _names(entry, mapped) -> tuple:
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(n for n in names if n in mapped)


def shard_map(fn: Callable, coll: Collectives, in_specs: Sequence,
              out_specs, axes: Sequence[str] = ("model",)) -> Callable:
    """``fn`` over local slices: each input (a tensor or a tree of them,
    with a spec or a congruent tree of specs: tuples with an entry per
    dim of an axis name, a tuple of names or None) enters through
    :meth:`Collectives.replicated_in` on each of ``axes`` and is sliced
    along each dim whose entry names one of ``axes`` (nested in the
    entry's order), ``fn`` runs on the slices, and each output (one
    tensor, ``out_specs`` its spec) is gathered along each dim whose
    entry names one of ``axes``.  Entries naming other axes (the data
    axes, over which the caller's tensors are already split) are
    ignored; an input whose spec is ``None`` is already this rank's
    block and enters as it is (its gradient is this rank's own); an
    output whose spec names none of ``axes`` is returned as ``fn`` made
    it (replicated by ``fn``'s own collective)."""
    mapped = tuple(axes)

    def enter(t, spec):
        if spec is None:
            return t
        for a in mapped:
            t = coll.replicated_in(t, a)
        for dim, entry in enumerate(spec):
            for a in _names(entry, mapped):
                t = coll._take(t, a, dim)
        return t

    def run(*args):
        local = [tree_map(enter, a, s) for a, s in zip(args, in_specs)]
        y = fn(*local)
        for dim, entry in reversed(list(enumerate(out_specs))):
            for a in reversed(_names(entry, mapped)):
                y = coll.gather_out(y, a, dim)
        return y

    return run
