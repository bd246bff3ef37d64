"""Per-round channel rates on the device (the port of ``repro.sim.channel``).

The same physics as the numpy :class:`repro_torch.wireless.channel.ChannelModel`
— (K, zeta) Rician small-scale fading, TR 38.901 UMa-style log-distance
path loss, ``v = B log2(1 + p h / (B N0))`` — as fp32 tensor ops on the
(A, U) client->AP distances. The Rician normals come in as arguments (two
(A, U, C) draws from the round's entropy source), so the function is pure
and a test can feed it the JAX package's own draws. The static client drop
is set-up: :meth:`SimChannel.from_host_model` shares the numpy model's
single-BS drop exactly (A = 1); :meth:`SimChannel.from_topology` drops a
cell-free scenario's clients from two uniform draws.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.wireless.channel import ChannelModel, ChannelParams


def path_loss_db(distances: torch.Tensor, params: ChannelParams) -> torch.Tensor:
    """TR 38.901 UMa LOS fit, elementwise over any distances shape."""
    carrier = torch.tensor(params.carrier_ghz, dtype=torch.float32, device=distances.device)
    return 28.0 + 22.0 * torch.log10(distances) + 20.0 * torch.log10(carrier)


def large_scale(distances: torch.Tensor, params: ChannelParams) -> torch.Tensor:
    """Linear large-scale power gain (path loss + antenna gain)."""
    db = -path_loss_db(distances, params) + params.antenna_gain_db
    return torch.pow(10.0, db / 10.0)


def ap_gains(normals_x: torch.Tensor, normals_y: torch.Tensor,
             params: ChannelParams, distances: torch.Tensor) -> torch.Tensor:
    """(A, U, C) per-AP linear power gains from two (A, U, C) standard
    normal draws (the in-phase and quadrature scatter)."""
    k, zeta = params.rician_k, params.rician_zeta
    los = math.sqrt(k / (k + 1.0) * zeta)
    nlos_std = math.sqrt(zeta / (2.0 * (k + 1.0)))
    x = los + nlos_std * normals_x
    y = nlos_std * normals_y
    small_scale = x**2 + y**2
    return small_scale * large_scale(distances, params)[:, :, None]


def effective_gains(gains: torch.Tensor, distances: torch.Tensor,
                    params: ChannelParams, association: str) -> torch.Tensor:
    """(A, U, C) per-AP gains -> effective (U, C) uplink gains (``best``:
    the strongest large-scale AP serves; ``combine``: sum over APs)."""
    if association == "combine":
        return torch.sum(gains, dim=0)
    if association != "best":
        raise ValueError(f"association must be best/combine, got {association!r}")
    ap_star = torch.argmax(large_scale(distances, params), dim=0)   # (U,)
    return torch.take_along_dim(gains, ap_star[None, :, None], dim=0)[0]


def draw_rates(normals_x: torch.Tensor, normals_y: torch.Tensor,
               params: ChannelParams, distances: torch.Tensor,
               association: str = "best") -> torch.Tensor:
    """(U, C) achievable uplink rates [bit/s] for one round (eq. 14)."""
    gains = effective_gains(ap_gains(normals_x, normals_y, params, distances),
                            distances, params, association)
    snr = params.p_tx * gains / params.noise_power
    return params.bandwidth * torch.log2(1.0 + snr)


@dataclasses.dataclass(frozen=True)
class SimChannel:
    """Frozen channel geometry: params + (A, U) distances on the device."""

    params: ChannelParams
    distances: torch.Tensor    # (A, U) static client drop, fp32
    association: str = "best"

    @classmethod
    def from_host_model(cls, model: ChannelModel, device) -> "SimChannel":
        """Share the numpy model's client drop (single BS, A = 1)."""
        d = torch.tensor(model.distances, dtype=torch.float32, device=device)
        return cls(params=model.params, distances=d[None, :])

    @classmethod
    def from_topology(cls, u_r: torch.Tensor, u_phi: torch.Tensor,
                      params: ChannelParams, topology) -> "SimChannel":
        """Drop via a cell-free ``repro_torch.sim.scenario.Topology`` from
        its two (U,) uniform draws, on their device."""
        return cls(params=params, distances=topology.drop(u_r, u_phi, params),
                   association=topology.association)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(A, U, C) of one round's fading draw."""
        return (int(self.distances.shape[0]), self.params.n_clients,
                self.params.n_channels)
