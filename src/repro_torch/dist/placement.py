"""Parameter and optimizer-state placement as DTensors (the port of the
JAX launchers' ``jax.device_put(tree, plan.named(specs))``).

A placed leaf is a ``torch.distributed.tensor.DTensor`` on the plan's
``DeviceMesh`` with the placements of its spec (``dist.plan.placements``):
each rank holds ``plan.local_slice`` of the whole, so FSDP and TP state is
1/n a rank. 0-d leaves (the optimizer's step count) stay plain tensors,
the same on every rank.

  * :func:`place_tree`: a tree of whole tensors, the same on every rank,
    to DTensors. Each rank cuts its own slice (a copy; a leaf the rank
    holds whole shares the caller's storage), so placing moves no data;
    the layout is the one ``distribute_tensor`` gives;
  * :func:`full_tree`: DTensors back to whole tensors on every rank
    (all-gathers through ``dist.collectives``), for checkpoints and tests;
  * :func:`init_params_local`: ``model.init_params``' draws, each leaf
    drawn whole (a stacked leaf one layer at a time) and cut to the
    rank's slice at once, so no rank ever holds the whole model: leaf for
    leaf the slice of ``init_params(cfg, seed)``;
  * :func:`place_opt_state`: optimizer state through ``make_opt_specs``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.dist import collectives
from repro_torch.dist.plan import MeshPlan, PartitionSpec as P, mesh_coord, placements
from repro_torch.dist.sharding import _STACKED_TOP_KEYS, make_opt_specs, param_specs

Tree = Any


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _from_local(plan: MeshPlan, local: torch.Tensor, spec: P, shape) -> Any:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, plan.mesh, placements(spec, plan.mesh), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def place_tree(plan: MeshPlan, tree: Tree, specs: Optional[Tree] = None) -> Tree:
    """Whole tensors -> DTensors laid out by ``specs`` (default: the
    plan's ``param_specs``)."""
    if plan.mesh is None:
        raise ValueError("place_tree needs a plan built on a DeviceMesh")
    specs = param_specs(plan, tree) if specs is None else specs
    coord = mesh_coord(plan.mesh)

    def one(t, spec):
        if t.ndim == 0:
            return t
        local = t[plan.local_slice(spec, t.shape, coord)]
        if local.shape != t.shape:            # a slice: its own storage, so the whole can go
            local = local.clone()
        return _from_local(plan, local, spec, t.shape)

    return tree_util.map(one, tree, specs)


@torch.no_grad()
def full_tensor(t) -> torch.Tensor:
    """A DTensor's whole tensor on every rank (a plain tensor as it is):
    each sharded dim all-gathered over its mesh axes, the minor axis first."""
    from repro_torch.dist.parallel import _is_dtensor, spec_of

    if not _is_dtensor(t):
        return t
    mesh, out = t.device_mesh, t.to_local()
    for d, ent in enumerate(spec_of(t)):
        axes = (ent,) if isinstance(ent, str) else tuple(ent or ())
        for a in reversed(axes):
            out = collectives.all_gather(out, mesh.get_group(a), a, d)
    return out


def full_tree(tree: Tree) -> Tree:
    """DTensors -> whole tensors (every rank gets them)."""
    return tree_util.map(full_tensor, tree)


def init_params_local(cfg, plan: MeshPlan, seed: int = 0, device=None,
                      param_dtype: Optional[torch.dtype] = None) -> Tree:
    """``model.init_params(cfg, seed, device, param_dtype)`` placed by the
    plan's ``param_specs``, each rank materializing only its slices (module
    docstring). Shapes come from ``model.abstract_params``."""
    from repro_torch.models import model

    if plan.mesh is None:
        raise ValueError("init_params_local needs a plan built on a DeviceMesh")
    abstract = model.abstract_params(cfg)
    spec_leaves = tree_util.leaves(param_specs(plan, abstract))
    spec_of = dict(zip(tree_util.paths(abstract), spec_leaves))
    shape_of = {p: tuple(t.shape) for p, t in zip(tree_util.paths(abstract),
                                                  tree_util.leaves(abstract))}
    coord = mesh_coord(plan.mesh)

    def cut(path, t):
        spec = spec_of[path]
        if path[0] in _STACKED_TOP_KEYS:          # one layer of a stacked leaf
            spec = P(*spec[1:])
        return t[plan.local_slice(spec, t.shape, coord)].clone()

    local = model.init_params(cfg, seed, device=device, param_dtype=param_dtype, cut=cut)
    key_paths = tree_util.paths(local)
    return tree_util.from_leaves(key_paths, [
        _from_local(plan, t, spec_of[p], shape_of[p])
        for p, t in zip(key_paths, tree_util.leaves(local))])


def place_opt_state(plan: MeshPlan, opt_state: Tree, pspecs: Tree) -> Tree:
    """Optimizer state of whole tensors -> DTensors: the sub-trees shaped
    like the params take ``pspecs`` (``make_opt_specs``), scalars stay."""
    return place_tree(plan, opt_state, make_opt_specs(plan.mesh, opt_state, pspecs))
