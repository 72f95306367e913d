"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Dicts flatten in sorted key order, as ``jax.tree_util`` does, so leaf order
and the ``/``-joined key paths match the reference's checkpoint layout.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any

__all__ = ["tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_unflatten"]


def tree_flatten_with_path(tree: PyTree, prefix: tuple = ()):
    """[(path, leaf)] in sorted-key order; ``path`` is a tuple of keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_flatten_with_path(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """Rebuild ``like``'s structure from leaves in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves = tree_leaves(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])
