"""The parallelism context's hooks (the reference's ``Par``), as the
single-device no-op.

The model code calls these hooks where a mesh changes what runs;
:class:`repro_torch.launch.sharding.MeshPar` overrides them.  Besides the
reference's (``constraint``, ``moe``, Ulysses attention) there are the
hooks of the tensor-parallel dense layers: :meth:`Par.dense_split` names
how a layer kind runs over the ``model`` axis, and a split layer computes on
this rank's blocks of its weights (column-parallel products on its heads
or hidden units, row-parallel products back to the model width) between
:meth:`Par.region_in` and :meth:`Par.region_out`, the two conjugate
operators of Megatron-LM's tensor parallelism (with sequence
parallelism, an all-gather and a reduce-scatter over the sequence); a
layer that runs whole takes the whole sequence through
:meth:`Par.whole_in` and hands back the stream's layout through
:meth:`Par.whole_out`.  :meth:`Par.sequence` starts a forward: it fixes
the layout of the residual stream from the global sequence length.  Here
every layer is ``"whole"`` and every hook the identity.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.tree import tree_map
from .config import ModelConfig
from .moe import moe_mlp

class Par:
    """The parallelism context's hooks, as the single-device no-op."""

    model_rank = 0  # this rank's index on the ``model`` axis
    model_n = 1     # the ``model`` axis's ranks

    def constraint(self, x, kind: str):
        """Where the reference pins a layout: the identity."""
        return x

    def moe(self, x, p, cfg: ModelConfig):
        """The MoE MLP over the (B*T, D) tokens of x (B, T, D)."""
        b, t, d = x.shape
        return moe_mlp(x.reshape(b * t, d), p, top_k=cfg.top_k, act=cfg.act,
                       capacity_factor=cfg.capacity_factor).reshape(b, t, d)

    def ulysses_ok(self, cfg: ModelConfig, t: int) -> bool:
        return False

    # ------------------------------------------- the residual stream --
    def sequence(self, params, t: int):
        """Start a forward over a sequence of ``t``: fix the residual
        stream's layout, and return ``params`` as the forward reads them
        (here both as they are)."""
        return params

    def seq_len(self, x) -> int:
        """The global sequence length of the residual stream ``x``."""
        return x.shape[1]

    def last_position(self, x):
        """The stream's last position, (B, 1, D), whole from here on."""
        return x[:, -1:]

    def whole_in(self, x):
        """The stream entering a layer that runs whole: the whole
        sequence (backward: this rank's part of the gradient)."""
        return x

    def whole_out(self, x):
        """A whole layer's output handed back in the stream's layout
        (backward: the whole gradient)."""
        return x

    def local_params(self, params, t: Optional[int] = None,
                     cached: bool = False):
        """The parameters as the model reads them, for a sequence of
        ``t`` (``cached``: a prefill or decode step that writes caches):
        plain tensors."""
        return params

    def local_batch(self, batch):
        """This rank's part of a global batch dict."""
        return batch

    def gather_batch(self, t, global_b: int):
        """Per-rank outputs (batch dim first) of a batch of ``global_b``
        gathered whole."""
        return t

    def data_sum(self, x):
        """A per-rank partial sum summed over the data axes."""
        return x

    def reduce_grads(self, grads, params):
        """The gradients of :meth:`local_params`' tensors as the update
        takes them."""
        return grads

    def grad_norm(self, grads, params):
        """The global norm of the whole gradient tree."""
        from ..optim.adamw import global_norm
        return global_norm(grads)

    def optimizer_step(self, optimizer, grads, gnorm, opt_state, params):
        """One ``optimizer`` update of ``params`` in place (``gnorm``:
        the gradients' global norm); returns the new optimizer state."""
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            tree_map(lambda p, u: p.copy_((p + u).to(p.dtype)), params,
                     updates)
        return opt_state

    # ------------------------------------------ tensor parallelism --
    def dense_split(self, kind: str) -> str:
        """How the dense layers of ``kind`` (``"attn"``, ``"mlp"``,
        ``"mamba"``, ``"rwkv"`` or ``"vocab"``) run over ``model``:
        ``"heads"`` (on this rank's heads, hidden units or vocabulary
        rows), ``"q_heads_kv_whole"`` (attention: q heads split, k and v
        whole), ``"head_dim"`` (attention: a decode step on this rank's
        slice of the head dim, prefill and training on its rows of the
        sequence) or ``"whole"``."""
        return "whole"

    def cache_split(self, kind: str) -> int:
        """Over how many ranks the decode cache of a layer ``kind``
        (``"attn"``, ``"mamba"``, ``"rwkv"``) is split: on its heads, or
        on the head dim where the attention is ``"head_dim"``."""
        return 1

    def region_in(self, x):
        """The stream entering a split region, whole on every rank: the
        identity (backward: the sum over ``model`` of the ranks'
        parts)."""
        return x

    def region_out(self, x):
        """A row-parallel product's partial sums leaving a split region:
        their sum over ``model``, in the stream's layout (backward: the
        identity)."""
        return x

    def replicated_in(self, x):
        """A tensor that is whole on every rank entering rank-specific
        work: the identity (backward: the sum over ``model``)."""
        return x

    def model_sum(self, x):
        """Partial sums summed over ``model``, the same on every rank
        (backward: the identity)."""
        return x

    def model_max(self, x):
        """The maximum over ``model`` of a tensor without gradient."""
        return x

    def channels_out(self, x):
        """This rank's channels (last dim) of the whole sequence leaving a
        split region in the stream's layout: the channels gathered whole
        (backward: this rank's chunk)."""
        return x

    def scatter_out(self, x, dim: int):
        """Partial sums summed over ``model``, this rank's chunk along
        ``dim`` (backward: the chunks gathered)."""
        return x

    def gather_out(self, x, dim: int):
        """The ranks' chunks along ``dim`` gathered whole (backward: this
        rank's chunk)."""
        return x

    def seq_gather(self, x):
        """This rank's chunk of the sequence (dim 1) gathered whole from
        every rank's, where the stream is split (backward: the sum of
        the ranks' gradients, this rank's chunk of it)."""
        return x

    def narrow(self, x, dim: int, start: int, length: int):
        """``x[start:start + length]`` along ``dim`` of a replicated ``x``
        read in a split region (its gradient summed over ``model``);
        ``x`` itself when that is the whole of it."""
        return x if length == x.shape[dim] else x.narrow(dim, start, length)

    def local(self, x, dim: int, length: int):
        """This rank's ``length`` entries of a replicated ``x`` along
        ``dim`` (:meth:`narrow` from ``model_rank * length``)."""
        return self.narrow(x, dim, self.model_rank * length, length)

    def halves(self, y):
        """A column-parallel product whose whole columns are two halves
        ``[a | b]``, this rank holding one contiguous chunk of them, as
        ``[a_r | b_r]``: this rank's chunk of each half (Mamba2's
        ``w_in``).  Whole here."""
        return y


DEFAULT_PAR = Par()
