"""Rule-based partition specs for every tree the launchers lay out (the
port of ``repro.dist.sharding``).

Layout model (logical-axis names over 2D/3D/4D meshes, resolved by
:mod:`repro_torch.dist.plan`):

  * ``model``        tensor/expert parallelism: attention heads, SwiGLU
    hidden, the MoE expert axis, the vocab of the (un)tied embedding;
  * ``data`` (+ ``pod``) FSDP: one non-model dim of every large weight in
    ``mode="train"``; serving replicates params over ``data``;
  * ``seq``          sequence parallelism of long-prefill activations.

This module owns the *leaf-name -> logical-dim-names* tables (verbatim
from the JAX package); the *logical-name -> mesh-axis* rules live in
:func:`repro_torch.dist.plan.default_rules`. The stacked-layer leading
axis is never sharded (names right-aligned, ``protect_leading``), and
every assignment is divisibility-checked.

The trees are the port's nested dicts (:mod:`repro_torch.tree`), whose
key paths match the JAX package's leaf for leaf. Specs are plain
:class:`~repro_torch.dist.plan.PartitionSpec` trees; :func:`shard_tree`
and :func:`gather_tree` cut a tree into, and rebuild it from, each rank's
local pieces as plain tensors. Placing parameters as DTensors (FSDP, TP)
is not done here.
"""
from __future__ import annotations

from typing import Any, Mapping

from repro_torch import tree as tree_util
from repro_torch.dist.plan import MeshPlan, PartitionSpec as P, _entry_axes, make_plan

Pytree = Any

_STACKED_TOP_KEYS = ("layers", "enc_layers")


# ------------------------------------------------------------- dim tables

# Per-leaf logical names for the *natural* (unstacked) trailing dims,
# right-aligned. None -> explicitly replicated.
_ATTN_DIMS = {
    "wq": ("embed", "heads", "head_dim"),       # (d, H, hd)
    "wk": ("embed", "kv_heads", "head_dim"),    # (d, KV, hd)
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),       # (H, hd, d)
}
_MOE_DIMS = {
    "router": ("embed", None),                  # (d, E): router replicated on E
    # expert parallelism on E; f stays replicated even when E does not
    # divide the model axis (grok's 8e on a 16-wide axis)
    "wg": ("expert", "embed", None),            # (E, d, f)
    "wu": ("expert", "embed", None),
    "wd": ("expert", None, "embed"),            # (E, f, d)
}
_MLP_DIMS = {
    "wg": ("embed", "mlp"),                     # (d, f)
    "wu": ("embed", "mlp"),
    "wd": ("mlp", "embed"),                     # (f, d)
}
_TM_DIMS = {                                    # rwkv6 time-mix
    "wr": ("embed", "heads"), "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wg": ("embed", "heads"),                   # (d, d): columns = H*hd
    "wo": ("heads", "embed"),
    "wa": ("embed", None), "wb": (None, "embed"),   # decay LoRA
    "u": ("heads", "head_dim"),                 # (H, hd) bonus
}
_CM_DIMS = {                                    # rwkv6 channel-mix
    "wk": ("embed", "mlp"),                     # (d, f)
    "wv": ("mlp", "embed"),                     # (f, d)
    "wr": ("embed", None),                      # (d, d) gate
}
_MAMBA_DIMS = {
    "w_in": ("embed", "mamba_inner"),           # (d, 2*din + 2*N + H)
    "w_out": ("mamba_inner", "embed"),          # (din, d)
    "conv": (None, None),                       # (K, C) depthwise: tiny
}
_PARENT_DIMS = {
    "attn": _ATTN_DIMS,
    "xattn": _ATTN_DIMS,
    "moe": _MOE_DIMS,
    "mlp": _MLP_DIMS,
    "tm": _TM_DIMS,
    "cm": _CM_DIMS,
    "mamba": _MAMBA_DIMS,
}

# KV/state caches carry a leading L axis; names cover the natural
# per-layer rank, right-aligned, so the L axis replicates automatically.
_CACHE_DIMS = {
    "k": ("batch", "cache_seq", "kv_heads", "head_dim"),   # (B, Lc, KV, hd)
    "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "mem_k": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "mem_v": ("batch", "cache_seq", "kv_heads", "head_dim"),
    "s": ("batch", "heads", None, None),        # rwkv wkv state (B, H, hd, hd)
    "ssm": ("batch", "heads", None, None),      # mamba state (B, H, N, hd)
    "x_tm": ("batch", None),                    # token-shift carries (B, D)
    "x_cm": ("batch", None),
    "conv": ("batch", None, None),              # (B, K-1, C)
}


def _leaf_dims(keys: tuple) -> tuple:
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) > 1 else ""
    if name == "table":  # embed / lm_head: (V, d), vocab on model
        return ("vocab", "embed")
    if parent == "vis_proj" and name == "w":
        return ("embed", "heads")
    return tuple(_PARENT_DIMS.get(parent, {}).get(name, ()))


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn, tree: Pytree) -> Pytree:
    """``fn(key_path, leaf)`` over a nested dict (a non-dict is one leaf
    with the empty path)."""
    key_paths = tree_util.paths(tree)
    return tree_util.from_leaves(
        key_paths, [fn(p, x) for p, x in zip(key_paths, tree_util.leaves(tree))])


# ---------------------------------------------------------- plan-first API

def param_specs(plan: MeshPlan, params: Pytree) -> Pytree:
    """Spec tree matching ``params`` leaf for leaf, resolved through
    ``plan``'s rule table."""
    def one(keys, leaf):
        stacked = bool(keys) and keys[0] in _STACKED_TOP_KEYS
        return plan.spec(_shape(leaf), _leaf_dims(keys), protect_leading=stacked)

    return _map_with_path(one, params)


def data_specs(plan: MeshPlan, batch: Pytree, *, leading: str = "batch") -> Pytree:
    """Shard the leading dim of every leaf by the rule for ``leading``
    (``"batch"`` for global batches, ``"clients"`` for fleet stacks); all
    other dims replicate."""
    def one(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return plan.spec(shape, (leading,), align="left")

    return tree_util.map(one, batch)


def cache_specs_plan(plan: MeshPlan, cache: Pytree) -> Pytree:
    """Specs for decode caches: batch over FSDP axes, KV heads / state
    heads over ``model``, ring metadata (``slot_pos``, ``pos``) replicated."""
    def one(keys, leaf):
        name = keys[-1] if keys else ""
        return plan.spec(_shape(leaf), _CACHE_DIMS.get(name, ()))

    return _map_with_path(one, cache)


# --------------------------------------------------- mesh-first wrappers

def make_param_specs(mesh, params: Pytree, *, mode: str = "train",
                     dp_override=None) -> Pytree:
    """Spec tree matching ``params``: ``mode="train"`` shards one non-model
    dim of each large weight over the FSDP axes, ``mode="serve"`` keeps
    tensor parallelism only; ``dp_override`` restricts the FSDP axes."""
    return param_specs(make_plan(mesh, mode=mode, dp_override=dp_override), params)


def batch_specs(mesh, batch: Pytree, *, dp_override=None) -> Pytree:
    """Shard the leading (global-batch) dim of every leaf over the FSDP
    axes, divisibility permitting."""
    return data_specs(make_plan(mesh, dp_override=dp_override), batch)


def cache_specs(mesh, cache: Pytree, *, dp_override=None) -> Pytree:
    return cache_specs_plan(make_plan(mesh, dp_override=dp_override), cache)


def make_opt_specs(mesh, opt_state: Pytree, param_specs: Pytree) -> Pytree:
    """Specs for optimizer state: sub-trees shaped like the params (adam's
    ``mu``/``nu``, momentum buffers) inherit ``param_specs``; scalars
    replicate. ``mesh`` is unused (the JAX signature)."""
    del mesh
    pkeys = tree_util.paths(param_specs)

    def rec(node):
        if isinstance(node, dict) and node and tree_util.paths(node) == pkeys:
            return param_specs
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, P):
            return type(node)(rec(v) for v in node)
        return P()

    return rec(opt_state)


# ------------------------------------------------------ local pieces

def shard_tree(plan: MeshPlan, tree: Pytree, specs: Pytree,
               coord: Mapping[str, int]) -> Pytree:
    """Each leaf's piece at mesh coordinate ``coord`` (``plan.local_slice``
    of its spec), as a plain tensor: a view of the leaf, no copy."""
    return tree_util.map(lambda x, s: x[plan.local_slice(s, x.shape, coord)], tree, specs)


def gather_tree(plan: MeshPlan, pieces: Mapping[tuple, Pytree], specs: Pytree) -> Pytree:
    """Inverse of :func:`shard_tree`: ``pieces`` maps each mesh coordinate
    (a tuple of indices in ``plan.axis_sizes`` order) to its
    :func:`shard_tree` output; each leaf is rebuilt by writing every piece
    at its slice (replicated pieces write the same values)."""
    names = tuple(plan.axis_sizes)
    coords = list(pieces)
    first = pieces[coords[0]]
    key_paths = tree_util.paths(first)
    spec_leaves = tree_util.leaves(specs)
    out = []
    for i, (spec, leaf0) in enumerate(zip(spec_leaves, tree_util.leaves(first))):
        full_shape = [n * plan.axis_size(_entry_axes(spec[d] if d < len(spec) else None))
                      for d, n in enumerate(leaf0.shape)]
        full = leaf0.new_empty(full_shape)
        for c in coords:
            coord = dict(zip(names, c))
            full[plan.local_slice(spec, full_shape, coord)] = tree_util.leaves(pieces[c])[i]
        out.append(full)
    return tree_util.from_leaves(key_paths, out)
