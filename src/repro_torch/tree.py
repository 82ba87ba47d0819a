"""Trees of tensors: the part of ``jax.tree`` the port uses.

A tree is a dict, list, tuple or NamedTuple whose entries are trees, None
(an empty subtree, which stays None) or leaves (anything else: tensors,
numpy arrays, scalars). :func:`leaves` visits dict keys in sorted order, as
``jax.tree.leaves`` does, so a float sum over the leaves (the global
gradient norm, the compression error) adds them in the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable


def _rebuild(node, vals: list):
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def map(fn: Callable, tree, *rest):  # noqa: A001 (jax.tree.map's name)
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which have its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [map(fn, *kids) for kids in zip(tree, *rest)])
    return fn(tree, *rest)


def leaves(tree) -> list[Any]:
    """The leaves, dict keys in sorted order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for kid in tree for x in leaves(kid)]
    return [tree]


def unflatten(tree, values):
    """A tree with ``tree``'s structure whose leaves are taken from the
    iterable ``values`` in :func:`leaves` order."""
    it = iter(values)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (tuple, list)):
            return _rebuild(node, [walk(kid) for kid in node])
        return next(it)

    return walk(tree)
