"""AdamW with global-norm clipping and a warmup + cosine schedule (the
port's copy of the JAX package's ``optim/adamw.py``).

The arithmetic is the reference's, op for op: moments are fp32 whatever
the parameter's type, the schedule is evaluated on the step as fp32, the
bias corrections ``b1 ** t`` and ``b2 ** t`` are fp32 powers of an fp32
step tensor, and the clip scale is ``min(1, clip_norm / (gn + 1e-9))``.
``init`` and ``update`` take and return the port's parameter trees
(nested dicts and lists of tensors, :mod:`repro_torch.core.tree`);
``update`` returns the updates, which the caller adds to the parameters
(``(p + u).to(p.dtype)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..core.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, the leaves added
    in the reference's order."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """step -> learning rate: linear warmup to ``peak_lr`` over
    ``warmup_steps``, then a cosine down to ``final_frac * peak_lr`` at
    ``total_steps``.  ``step`` is an integer tensor; the result is an
    fp32 tensor on its device."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clip((step - warmup_steps)
                          / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any             # fp32 tree of the params' shape
    nu: Any


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable, float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params, norm=None):
        """-> (updates, new state).  Runs without recording autograd.
        ``norm``: the global norm of the whole gradient tree, when
        ``grads``, ``state`` and ``params`` are one rank's blocks of
        theirs (the meshed train step); by default ``global_norm(grads)``."""
        with torch.no_grad():
            return self._update(grads, state, params, norm)

    def _update(self, grads, state: AdamWState, params, norm=None):
        step = state.step + 1
        if self.clip_norm is not None:
            gn = global_norm(grads) if norm is None else norm
            scale = torch.clamp_max(self.clip_norm / (gn + 1e-9), 1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)
        else:
            grads = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v
                      + (1 - self.b2) * torch.square(g), state.nu, grads)
        t = step.float()
        mu_hat_c = 1.0 / (1 - torch.pow(torch.tensor(
            self.b1, dtype=torch.float32, device=t.device), t))
        nu_hat_c = 1.0 / (1 - torch.pow(torch.tensor(
            self.b2, dtype=torch.float32, device=t.device), t))
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else self.learning_rate)
        updates = tree_map(
            lambda m, v, p: -lr * (m * mu_hat_c
                                   / (torch.sqrt(v * nu_hat_c) + self.eps)
                                   + self.weight_decay * p.float()),
            mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)
