"""Nested-dict parameter trees, in ``jax.tree_util`` leaf order.

JAX flattens a dict by sorted key, recursively, so ``ravel_pytree`` of the
CNN's parameters lays out ``conv0/b, conv0/w, conv1/b, ...``. These
helpers walk the port's trees (nested dicts of tensors) in that same
order, which keeps flat vectors and wire planes coordinate-aligned with
the JAX package. ``pytree_hash`` fingerprints such a tree.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable

import numpy as np
import torch

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


def pytree_hash(tree: Tree) -> str:
    """Stable content hash of a tree (a scenario fingerprint): sha256 over
    the sorted key paths and every leaf's dtype, shape and bytes (tensors
    are copied to the host). The port's own digest: it is not the JAX
    package's, which hashes JAX's treedef repr."""
    h = hashlib.sha256(repr(paths(tree)).encode())
    for leaf in leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]
