"""FL client: tau local SGD updates (Fig. 1 step 3), the port of
``repro.fl.client``."""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device


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


def _local_sgd(loss_fn: Callable, tau: int, params: dict, batches: dict, lr: float):
    """tau SGD steps over pre-stacked minibatches (leading axis tau).

    Returns ``(new_params, g_mean, g_var)``: the mean squared gradient norm
    (the G_i^2 observation) and the population variance of the per-step
    norms (sigma_i^2, ``jnp.var``'s ``correction=0``). The fleet runs this
    under ``vmap`` over its scheduled slots.
    """
    step = sgd_step(loss_fn, lr)
    p, gsq_acc, gsqs = params, 0.0, []
    for t in range(tau):
        p, _loss, gsq = step(p, {"x": batches["x"][t], "y": batches["y"][t]})
        gsq_acc = gsq_acc + gsq
        gsqs.append(gsq)
    return p, gsq_acc / tau, torch.var(torch.stack(gsqs), correction=0)


class FLClient:
    """Holds the local dataset on the device and runs local updates on
    demand. Minibatch indices come from ``np.random.default_rng(seed +
    cid)``, as in the JAX package, so both draw the same batches."""

    def __init__(
        self, cid: int, data: dict, loss_fn: Callable, batch_size: int = 32,
        seed: int = 0, device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        dev = resolve_device(device)
        self.cid = cid
        self.data = {
            "x": torch.as_tensor(np.asarray(data["x"]), dtype=torch.float32).to(dev),
            "y": torch.as_tensor(np.asarray(data["y"]).astype(np.int64)).to(dev),
        }
        self.loss_fn = loss_fn
        self.d_size = int(self.data["x"].shape[0])
        self.batch_size = min(batch_size, self.d_size)
        self.rng = np.random.default_rng(seed + cid)

    def _draw_batches(self, tau: int) -> dict:
        idx = self.rng.integers(0, self.d_size, size=(tau, self.batch_size))
        idx = torch.from_numpy(idx).to(self.data["x"].device)
        return {"x": self.data["x"][idx], "y": self.data["y"][idx]}

    def local_update(self, params: dict, tau: int, lr: float):
        """Returns (theta_i^{n,tau}, G_i^2 estimate, sigma_i^2 estimate)."""
        new_params, g_sq, g_var = _local_sgd(self.loss_fn, tau, params,
                                             self._draw_batches(tau), lr)
        return new_params, float(g_sq), float(g_var)
