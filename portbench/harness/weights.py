"""Random weights from the run's seed, drawn on the device in a few large
calls, in the tree layout and the types that ``LMSession(params=...)``
takes.

The layout (keys, shapes, types) is read from the program's parameter
tree on the ``meta`` device, which holds no numbers.  Every leaf is a
view of one flat buffer of its type, filled with N(0, 1) draws
(``normal_``) from one generator in chunks; each leaf is then scaled or mapped by its name:

* a matrix (two or more dims past a group axis): ``N(0, 1 / fan_in)``,
  ``fan_in`` the second-to-last dim (the embedding table's: the last);
* a norm weight or bias: ``N(0, 0.01)`` (norms scale by ``1 + w``);
* Mamba2's ``dt_bias``: the inverse softplus of a dt in [1e-3, 1e-1],
  ``A_log``: log of an A in [1, 16], ``D_skip``: ``1 + N(0, 0.01)``,
  as Mamba2 initialises them.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28  # elements drawn a call
SMALL = 0.1      # std of norm weights and biases
DT_RANGE = (1e-3, 1e-1)
A_RANGE = (1.0, 16.0)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _copy_layout(tree):
    if isinstance(tree, dict):
        return {k: _copy_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_layout(v) for v in tree]
    return None


def _stacked(path) -> bool:
    """Leaves under ``groups`` carry a leading group axis."""
    return bool(path) and path[0] == "groups"


def _fill(name: str, leaf: torch.Tensor, stacked: bool) -> None:
    """Map the N(0, 1) draw in ``leaf`` to the leaf's distribution."""
    dims = leaf.dim() - (1 if stacked else 0)
    if name == "dt_bias":
        lo, hi = (math.log(v) for v in DT_RANGE)
        dt = torch.exp(lo + (hi - lo) * torch.sigmoid(leaf.float()))
        leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif name == "A_log":
        lo, hi = A_RANGE
        leaf.copy_(torch.log(lo + (hi - lo) * torch.sigmoid(leaf.float())))
    elif name == "D_skip":
        leaf.mul_(SMALL).add_(1.0)
    elif dims >= 2:
        fan_in = leaf.shape[-1] if name == "embed" else leaf.shape[-2]
        leaf.mul_(fan_in ** -0.5)
    else:
        leaf.mul_(SMALL)


def draw_params(layout, seed: int, device) -> dict:
    """A parameter tree shaped like ``layout`` (the program's tree on the
    ``meta`` device), drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed))
    leaves = list(_leaves(layout))
    out = _copy_layout(layout)
    by_type = {}
    for path, meta in leaves:
        by_type.setdefault(meta.dtype, []).append((path, meta))
    for dtype, items in sorted(by_type.items(), key=lambda kv: str(kv[0])):
        total = sum(m.numel() for _, m in items)
        flat = torch.empty(total, dtype=dtype, device=device)
        for c0 in range(0, total, CHUNK):
            flat[c0:c0 + CHUNK].normal_(generator=gen)
        offset = 0
        for path, meta in items:
            leaf = flat[offset:offset + meta.numel()].view(meta.shape)
            offset += meta.numel()
            _fill(str(path[-1]), leaf, _stacked(path))
            _set(out, path, leaf)
    return out
