"""Parameter trees: nested dicts and tuples (named tuples such as optimizer
states included) whose leaves are tensors, keyed by the JAX package's key
paths so that trees of the two packages compare leaf by leaf.  Traversal
follows each dict's insertion order and each tuple's field order."""
from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def _rebuild(tree: tuple, items) -> tuple:
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leaf-wise over same-structure trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(tree, (tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: PyTree, leaves: List) -> PyTree:
    """Rebuild ``like``'s structure from ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out
