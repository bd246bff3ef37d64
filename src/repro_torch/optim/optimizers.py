"""Tree optimizers on the port's parameter trees (the port of
``repro.optim.optimizers``).

Each optimizer is an ``Optimizer(init, update)`` pair, as in the JAX
package:

  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  params = apply_updates(params, updates)

Trees are nested dicts of tensors (``repro_torch.tree``). The moments are
fp32 whatever the parameter dtype; ``apply_updates`` casts ``p + u`` back to
``p.dtype``. The arithmetic keeps the JAX code's order, Python constants
round to fp32 where the JAX code's weakly typed ones do, the bias
corrections ``b**t`` are fp32 powers of an fp32 step count, and every
division is by a tensor (torch turns a division by a Python scalar into a
multiply by its reciprocal). ``global_norm`` adds the leaves' sums in
:func:`repro_torch.tree.leaves` order, JAX's ``tree_leaves`` order. The
functions run under ``torch.no_grad()``: an optimizer step is not
differentiated.

DTensor leaves (parameters placed by ``dist.placement``; their gradients
and moments share the placements) are updated on their local tensors and
rewrapped with the same placements: every operation is elementwise, so the
local update is the update of the rank's slice, and no operation goes
through DTensor's dispatch. ``global_norm`` of sharded leaves sums each
leaf's local sum of squares over the mesh axes that shard it
(``dist.collectives``), one all-reduce per set of axes, and adds the leaf
sums in leaf order: the unsharded norm up to the rounding of the partial
sums (rtol 1e-6 in fp32 at the tests' sizes); with every leaf replicated,
the unsharded norm bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tree_util

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], tuple[Tree, Tree]]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _local_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``tree_util.map(fn, ...)`` with each DTensor leaf's local tensor in
    its place, the result rewrapped with the first tree's leaf's placements."""
    def one(x, *ys):
        if not _dtensor(x):
            return fn(x, *ys)
        from torch.distributed.tensor import DTensor

        out = fn(x.to_local(), *(y.to_local() if _dtensor(y) else y for y in ys))
        return DTensor.from_local(out, x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree_util.map(one, tree, *rest)


def _step0(params: Tree) -> torch.Tensor:
    """The int32 step count 0, on the device of the parameters."""
    return torch.zeros((), dtype=torch.int32, device=tree_util.leaves(params)[0].device)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    return _local_map(lambda p, u: (p + u).to(p.dtype), params, updates)


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    """fp32 sqrt of the sum of squares of every leaf (module docstring for
    DTensor leaves)."""
    leaves = tree_util.leaves(tree)
    sums = [torch.sum(torch.square(_f32(x.to_local() if _dtensor(x) else x))) for x in leaves]
    if any(_dtensor(x) for x in leaves):
        from repro_torch.dist import collectives
        from repro_torch.dist.parallel import spec_of

        groups: dict = {}
        for i, x in enumerate(leaves):
            if not _dtensor(x):
                continue
            mesh = x.device_mesh
            axes = tuple(sorted({a for ent in spec_of(x) if ent is not None
                                 for a in ((ent,) if isinstance(ent, str) else ent)
                                 if mesh.size(mesh.mesh_dim_names.index(a)) > 1}))
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            mesh = leaves[idx[0]].device_mesh
            part = torch.stack([sums[i] for i in idx])
            for a in axes:
                part = collectives.all_reduce(part, mesh.get_group(a), a)
            for j, i in enumerate(idx):
                sums[i] = part[j]
    return torch.sqrt(sum(sums))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    """``grads * min(1, max_norm / max(norm, 1e-9))`` and the norm."""
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm),
                          torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9))
    return _local_map(lambda g: g * scale, grads), norm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    @torch.no_grad()
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": _local_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params):
        del params
        if momentum == 0.0:
            ups = _local_map(lambda g: -lr * _f32(g), grads)
            return ups, {"step": state["step"] + 1}
        mu = _local_map(lambda m, g: momentum * m + _f32(g), state["mu"], grads)
        ups = _local_map(lambda m: -lr * m, mu)
        return ups, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update)


def _adam_core(lr: float, b1: float, b2: float, eps: float, weight_decay: float) -> Optimizer:
    @torch.no_grad()
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "mu": _local_map(z, params),
                "nu": _local_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(torch.float32)
        mu = _local_map(lambda m, g: b1 * m + (1 - b1) * _f32(g), state["mu"], grads)
        nu = _local_map(lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
                        state["nu"], grads)
        bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * _f32(p)
            return u

        ups = _local_map(upd, mu, nu, params)
        return ups, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)
