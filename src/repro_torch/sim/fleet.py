"""Stacked client fleet: padded per-client datasets on the device + local
SGD for the scheduled slots (the port of ``repro.sim.fleet``).

All U client datasets live in four tensors padded to a common ``N_max``.
Each round the engine gathers the S = min(U, C) scheduled clients' rows
(:func:`gather_active`), trains them with one ``torch.func.vmap`` of the
tau-step SGD over the slot axis (:func:`fleet_local_sgd`), and scatters the
G²/σ² observations back (:func:`scatter_slots`). Minibatch indices are an
input, (S, tau, B) in ``[0, n_s)``, drawn by the round's entropy source, so
padding rows are never sampled and a test can replay the JAX package's
per-slot draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.fl.client import _local_sgd
from repro_torch.obs.profile import scope as _profile_scope


@dataclasses.dataclass(frozen=True)
class Fleet:
    """All U client datasets as stacked, padded tensors."""

    x: torch.Tensor          # (U, N_max, H, W, C) fp32
    y: torch.Tensor          # (U, N_max) int64
    n_samples: torch.Tensor  # (U,) int64 true per-client sizes (mask)
    d_sizes: np.ndarray      # host copy of n_samples for setup-time math

    @property
    def n_clients(self) -> int:
        return int(self.x.shape[0])


def build_fleet(datasets: list[dict], device) -> Fleet:
    """Stack ``make_federated_datasets`` output on ``device``, one client
    at a time (no host-side copy of the padded fleet)."""
    sizes = np.array([d["x"].shape[0] for d in datasets], dtype=np.int64)
    n_max = int(sizes.max())
    u = len(datasets)
    xs = torch.zeros((u, n_max) + datasets[0]["x"].shape[1:], dtype=torch.float32,
                     device=device)
    ys = torch.zeros((u, n_max), dtype=torch.int64, device=device)
    for i, d in enumerate(datasets):
        xs[i, : sizes[i]].copy_(torch.from_numpy(d["x"]))
        ys[i, : sizes[i]].copy_(torch.from_numpy(d["y"].astype(np.int64)))
    return Fleet(x=xs, y=ys, n_samples=torch.tensor(sizes, device=device), d_sizes=sizes)


def gather_active(fleet: Fleet, slots: torch.Tensor):
    """(S,) slot client ids (-1 padded) -> ``(x_s, y_s, n_s)`` with leading
    axis S; padding slots gather client 0 and are masked downstream."""
    cid = torch.clamp(slots, min=0)
    return fleet.x[cid], fleet.y[cid], fleet.n_samples[cid]


def scatter_slots(slots: torch.Tensor, obs: torch.Tensor, n_clients: int) -> torch.Tensor:
    """(S,) per-slot observations -> (U,) per-client, zeros elsewhere
    (real slots are injective, so the add is an exact scatter)."""
    mask = slots >= 0
    cid = torch.clamp(slots, min=0)
    zero = torch.zeros((n_clients,), dtype=obs.dtype, device=obs.device)
    return zero.index_add(0, cid, torch.where(mask, obs, torch.zeros_like(obs)))


def fleet_local_sgd(
    loss_fn: Callable,
    tau: int,
    params: dict,
    x_s: torch.Tensor,        # (S, N_max, H, W, C)
    y_s: torch.Tensor,        # (S, N_max)
    batch_idx: torch.Tensor,  # (S, tau, B) int64 in [0, n_s)
    lr: float,
):
    """tau local SGD steps for every gathered client at once.

    Returns ``(stacked_params, g_mean, g_var)``: each params leaf with a
    leading S axis, and the per-slot G_i^2 (mean squared gradient norm) and
    sigma_i^2 (population variance of the per-step norms) observations.
    """
    rows = torch.arange(x_s.shape[0], device=x_s.device)[:, None, None]
    xb, yb = x_s[rows, batch_idx], y_s[rows, batch_idx]    # (S, tau, B, ...)

    def one_client(x, y):
        return _local_sgd(loss_fn, tau, params, {"x": x, "y": y}, lr)

    with _profile_scope("fleet_local_sgd"):
        return torch.func.vmap(one_client)(xb, yb)


def ema_update(ema: torch.Tensor, obs: torch.Tensor, a: torch.Tensor,
               decay: float = 0.7, floor: float = 0.0) -> torch.Tensor:
    """Masked EMA: scheduled clients blend in the new observation."""
    blended = decay * ema + (1.0 - decay) * torch.clamp(obs, min=floor)
    return torch.where(a > 0, blended, ema)
