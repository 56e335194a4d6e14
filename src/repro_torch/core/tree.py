"""The port's parameter and optimizer trees: nested dicts, lists, tuples
and NamedTuples with tensors (or other leaves) at the ends.

Leaves are visited in the JAX package's tree order, dict keys sorted, so
a sum over the leaves adds in the reference's order, and each leaf's
path is the key the JAX checkpoint writes for it: dict keys, sequence
indices and NamedTuple fields by name, joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in the JAX package's order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from leaves_with_paths(sub, f"{prefix}/{key}" if prefix
                                     else key)


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest`` (matched by key and index), in :func:`leaves`'
    order; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree, values):
    """``tree``'s structure with ``values`` as its leaves, in
    :func:`leaves`' order."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
