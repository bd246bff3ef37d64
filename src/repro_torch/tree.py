"""Nested-dict parameter trees, in ``jax.tree_util`` leaf order.

JAX flattens a dict by sorted key, recursively, so ``ravel_pytree`` of the
CNN's parameters lays out ``conv0/b, conv0/w, conv1/b, ...``. These
helpers walk the port's trees (nested dicts of tensors) in that same
order, which keeps flat vectors and wire planes coordinate-aligned with
the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def leaves(tree: Tree) -> list:
    """Leaves in sorted-key order (a non-dict is a single leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def paths(tree: Tree, prefix: tuple = ()) -> list[tuple]:
    """Key paths of the leaves, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    return [prefix]


def from_leaves(key_paths: list[tuple], values: list) -> Tree:
    """Inverse of :func:`paths`/:func:`leaves`."""
    if key_paths == [()]:
        return values[0]
    out: dict = {}
    for path, value in zip(key_paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:  # noqa: A001
    """``jax.tree_util.tree_map`` over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
