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


def _step0(params: Tree) -> torch.Tensor:
    """The int32 step count 0, on the device of the parameters."""
    return torch.zeros((), dtype=torch.int32, device=tree_util.leaves(params)[0].device)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_util.map(lambda p, u: (p + u).to(p.dtype), params, updates)


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    """fp32 sqrt of the sum of squares of every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(_f32(leaf)))
                          for leaf in tree_util.leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    """``grads * min(1, max_norm / max(norm, 1e-9))`` and the norm."""
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm),
                          torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9))
    return tree_util.map(lambda g: g * scale, grads), norm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    @torch.no_grad()
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": tree_util.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update(grads, state, params):
        del params
        if momentum == 0.0:
            ups = tree_util.map(lambda g: -lr * _f32(g), grads)
            return ups, {"step": state["step"] + 1}
        mu = tree_util.map(lambda m, g: momentum * m + _f32(g), state["mu"], grads)
        ups = tree_util.map(lambda m: -lr * m, mu)
        return ups, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update)


def _adam_core(lr: float, b1: float, b2: float, eps: float, weight_decay: float) -> Optimizer:
    @torch.no_grad()
    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"step": _step0(params), "mu": tree_util.map(z, params),
                "nu": tree_util.map(z, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(torch.float32)
        mu = tree_util.map(lambda m, g: b1 * m + (1 - b1) * _f32(g), state["mu"], grads)
        nu = tree_util.map(lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
                           state["nu"], grads)
        bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

        def upd(m, v, p):
            u = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u - lr * weight_decay * _f32(p)
            return u

        ups = tree_util.map(upd, mu, nu, params)
        return ups, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)
