"""Local SGD step of an FL client (Fig. 1 step 3), the port of
``repro.fl.client.sgd_scan_body``."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_util


def sgd_step(loss_fn: Callable, lr: float) -> Callable:
    """One SGD step ``step(params, batch) -> (params, loss, grad_norm_sq)``.

    ``loss_fn(params, batch)`` is a pure function of a parameter tree;
    ``grad_norm_sq`` is the squared gradient norm summed over the leaves in
    sorted-key order (the JAX body's ``tree_leaves`` order). The step is
    ``torch.func``-transformable, so the fleet runs it under ``vmap``.
    """
    grad_and_loss = torch.func.grad_and_value(loss_fn)

    def step(params, batch):
        grads, loss = grad_and_loss(params, batch)
        gsq = sum(torch.sum(torch.square(g)) for g in tree_util.leaves(grads))
        params = tree_util.map(lambda w, g: w - lr * g, params, grads)
        return params, loss, gsq

    return step
