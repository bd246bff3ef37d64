"""Scenarios as data (the port of ``repro.sim.scenario``).

A :class:`Scenario` carries one whole experiment configuration:

  topology  — AP positions + association rule (cell-free multi-AP geometry;
              A = 1 with ``mode="single_bs"`` is the legacy single-BS layout)
  channel   — the :class:`repro_torch.wireless.channel.ChannelParams` physics
  data      — the client data partition (sizes mu/beta + Dirichlet alpha)
  policy    — which per-round controller the engine runs (QCCF greedy/GA or
              one of the paper's baselines)
  lyapunov  — the drift-plus-penalty constants (V, target_q for the eps
              probe, and the heterogeneity-aware scheduling weight)
  faults    — the fault-injection gate (:class:`FaultSpec`)

``build_sim(scenario=...)`` takes a Scenario or a registered preset name
(``single_bs``, ``cellfree_a4``, ``noniid_a01``, ``single_bs_faulty``).
The cell-free drop takes its uniforms as arguments (:meth:`Topology.drop`),
so a test can hand it the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.wireless.channel import ChannelParams, ap_ring_layout

# Policy selectors understood by the engine ("qccf" is the greedy path,
# "qccf_ga" the GA of Algorithm 1; the rest are the paper's baselines).
POLICIES = ("qccf", "qccf_ga", "no_quant", "channel_allocate",
            "principle", "same_size")

ASSOCIATIONS = ("best", "combine")


@dataclasses.dataclass(frozen=True)
class Topology:
    """A access points + association rule.

    ``mode="single_bs"`` keeps the legacy drop (radial distances from one
    BS at the origin, the numpy ``ChannelModel``'s). ``mode="cellfree"``
    drops clients as xy positions and serves them from ``ap_xy``;
    ``association`` reduces the (A, U, C) per-AP gains to the (U, C)
    uplink: ``best`` serves each client from its strongest large-scale AP,
    ``combine`` sums the gains over all APs. Both are the identity at A = 1.
    """

    ap_xy: np.ndarray          # (A, 2) AP positions [m]
    mode: str = "single_bs"    # "single_bs" | "cellfree"
    association: str = "best"  # "best" | "combine"

    def __post_init__(self) -> None:
        if self.mode not in ("single_bs", "cellfree"):
            raise ValueError(f"Topology.mode must be single_bs/cellfree, got {self.mode!r}")
        if self.association not in ASSOCIATIONS:
            raise ValueError(
                f"Topology.association must be one of {ASSOCIATIONS}, got {self.association!r}")
        ap = np.asarray(self.ap_xy, np.float64)
        if ap.ndim != 2 or ap.shape[1] != 2:
            raise ValueError(f"Topology.ap_xy must be (A, 2), got {ap.shape}")
        if self.mode == "single_bs" and ap.shape[0] != 1:
            raise ValueError("single_bs means exactly one AP")
        object.__setattr__(self, "ap_xy", ap)

    @property
    def n_aps(self) -> int:
        return int(self.ap_xy.shape[0])

    def drop(self, u_r: torch.Tensor, u_phi: torch.Tensor,
             params: ChannelParams) -> torch.Tensor:
        """(A, U) fp32 client->AP distances of a cell-free drop from two (U,)
        uniform draws: polar positions r = R sqrt(u_r), phi = 2 pi u_phi,
        Euclidean distance to every AP, floored at ``params.near_field_m``.
        (The single-BS drop is the numpy ``ChannelModel``'s.)"""
        if self.mode != "cellfree":
            raise ValueError("the single-BS drop is the numpy ChannelModel's")
        r = params.radius_m * torch.sqrt(u_r)
        phi = 2.0 * math.pi * u_phi
        xy = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=1)     # (U, 2)
        ap = torch.tensor(self.ap_xy, dtype=torch.float32, device=u_r.device)  # (A, 2)
        diff = xy[None, :, :] - ap[:, None, :]
        # sqrt of the summed squares, as jnp.linalg.norm computes it
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        return torch.clamp(d, min=params.near_field_m)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Client data partition: sizes D_i ~ N(mu, beta), Dirichlet(alpha)
    label skew; ``None`` sizes defer to the task defaults."""

    mu: Optional[float] = None
    beta: Optional[float] = None
    alpha_dirichlet: float = 0.5


@dataclasses.dataclass(frozen=True)
class LyapunovSpec:
    """Drift-plus-penalty constants + the heterogeneity scheduling weight:
    excluding client i costs ``(1 + hetero_weight * KL_i)`` times more in
    the data term (0 is the heterogeneity-blind objective)."""

    v_weight: float = 100.0
    target_q: float = 6.0
    hetero_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault-injection gate: all-zero rates run the fault-free round with
    the fault-free draws; any rate > 0 switches ``enabled`` on.

      outage_p / outage_corr — per-client outage process; a client in
          outage is scheduled but never delivers. Markov with
          P(down | was down) = p + corr (1 - p), P(down | was up) =
          p (1 - corr); corr = 0 is i.i.d., the stationary rate is p.
      fade_p / fade_db — with prob ``fade_p`` a client's realized rate is
          its planned rate times ``10^(-fade_db/10)``; a realized round time
          past ``t_max`` screens the slot.
      corrupt_p / corrupt_frac — with prob ``corrupt_p`` a slot's index and
          sign planes get a ``corrupt_frac`` fraction of entries XORed with
          random bytes; caught by the range screen.
      nan_p — with prob ``nan_p`` a slot's update is replaced by all-NaN
          (or all-Inf) before the wire; its range is non-finite.
    """

    outage_p: float = 0.0
    outage_corr: float = 0.0
    fade_p: float = 0.0
    fade_db: float = 10.0
    corrupt_p: float = 0.0
    corrupt_frac: float = 0.01
    nan_p: float = 0.0

    def __post_init__(self) -> None:
        for f in ("outage_p", "fade_p", "corrupt_p", "nan_p"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{f}={v} outside [0, 1]")
        if not 0.0 <= self.outage_corr < 1.0:
            raise ValueError(f"FaultSpec.outage_corr={self.outage_corr} outside [0, 1)")
        if not 0.0 < self.corrupt_frac <= 1.0:
            raise ValueError(f"FaultSpec.corrupt_frac={self.corrupt_frac} outside (0, 1]")
        if self.fade_db < 0.0:
            raise ValueError(f"FaultSpec.fade_db={self.fade_db} < 0")

    @property
    def enabled(self) -> bool:
        return (self.outage_p > 0 or self.fade_p > 0
                or self.corrupt_p > 0 or self.nan_p > 0)

    def dyn_vector(self) -> np.ndarray:
        """fp32 [outage_p, outage_corr, fade_p, fade_mult, corrupt_p,
        corrupt_frac, nan_p] with ``fade_mult = 10^(-fade_db/10)``."""
        return np.array(
            [self.outage_p, self.outage_corr, self.fade_p,
             10.0 ** (-self.fade_db / 10.0), self.corrupt_p,
             self.corrupt_frac, self.nan_p], np.float32)


FAULTS_OFF = FaultSpec()


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One whole experiment configuration as data."""

    name: str
    topology: Topology
    channel: ChannelParams
    data: DataSpec = DataSpec()
    policy: str = "qccf"
    lyapunov: LyapunovSpec = LyapunovSpec()
    faults: FaultSpec = FAULTS_OFF

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; one of {POLICIES}")

    def with_faults(self, faults: FaultSpec) -> "Scenario":
        return dataclasses.replace(self, faults=faults)

    def with_policy(self, policy: str) -> "Scenario":
        return dataclasses.replace(self, policy=policy)

    def with_fleet(self, n_clients: int, n_channels: int) -> "Scenario":
        return dataclasses.replace(
            self, channel=dataclasses.replace(self.channel, n_clients=n_clients,
                                              n_channels=n_channels))


# --------------------------------------------------------------- presets

ScenarioBuilder = Callable[..., Scenario]
_REGISTRY: dict[str, ScenarioBuilder] = {}


def register_scenario(name: str, builder: ScenarioBuilder) -> None:
    """Register a preset builder (keywords ``n_clients``, ``n_channels``
    -> Scenario); ``get_scenario(name, ...)`` resolves it."""
    _REGISTRY[name] = builder


def get_scenario(name: str, *, n_clients: int = 64,
                 n_channels: Optional[int] = None, **kw) -> Scenario:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(_REGISTRY)}")
    c = n_clients if n_channels is None else n_channels
    return _REGISTRY[name](n_clients=n_clients, n_channels=c, **kw)


def scenario_names() -> list[str]:
    return sorted(_REGISTRY)


def _single_bs(n_clients: int, n_channels: int, **kw) -> Scenario:
    """The paper's own setup: one BS at the origin."""
    return Scenario(
        name="single_bs",
        topology=Topology(ap_xy=np.zeros((1, 2)), mode="single_bs"),
        channel=ChannelParams(n_clients=n_clients, n_channels=n_channels),
        **kw,
    )


def _cellfree_a4(n_clients: int, n_channels: int,
                 association: str = "combine", **kw) -> Scenario:
    """Four APs on a half-radius ring serving a cell-free uplink."""
    params = ChannelParams(n_clients=n_clients, n_channels=n_channels)
    return Scenario(
        name="cellfree_a4",
        topology=Topology(ap_xy=ap_ring_layout(4, 0.5 * params.radius_m),
                          mode="cellfree", association=association),
        channel=params,
        **kw,
    )


def _noniid_a01(n_clients: int, n_channels: int, **kw) -> Scenario:
    """Single BS with Dirichlet(0.1) label skew and the heterogeneity-aware
    scheduling weight on."""
    kw.setdefault("data", DataSpec(alpha_dirichlet=0.1))
    kw.setdefault("lyapunov", LyapunovSpec(hetero_weight=1.0))
    return Scenario(
        name="noniid_a01",
        topology=Topology(ap_xy=np.zeros((1, 2)), mode="single_bs"),
        channel=ChannelParams(n_clients=n_clients, n_channels=n_channels),
        **kw,
    )


def _single_bs_faulty(n_clients: int, n_channels: int, **kw) -> Scenario:
    """Single BS under a bursty 10 % outage process plus occasional deep
    fades."""
    kw.setdefault("faults", FaultSpec(outage_p=0.1, outage_corr=0.5,
                                      fade_p=0.05, fade_db=10.0))
    return dataclasses.replace(
        _single_bs(n_clients=n_clients, n_channels=n_channels, **kw),
        name="single_bs_faulty",
    )


register_scenario("single_bs", _single_bs)
register_scenario("cellfree_a4", _cellfree_a4)
register_scenario("noniid_a01", _noniid_a01)
register_scenario("single_bs_faulty", _single_bs_faulty)
