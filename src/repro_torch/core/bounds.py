"""Convergence-bound terms (paper Sec. III, Theorems 1-2; Sec. IV eq. 20/21).

Theorem 2 bounds the accumulated gradient norm by three parts:
  1. loss descent 2/eta * (F(theta^0) - F(theta^N))      -- fixed,
  2. quantization error  L/2 * sum_n sum_i w_i^n * Z theta_max^2 / (4(2^q-1)^2),
  3. data property       terms in sigma_i^2, G_i^2 and scheduling (1 - a_i w_i).

The optimization detaches parts 2 and 3 as long-term constraints C7 and C6
with budgets eps2 / eps1 and coefficients

  A1 = 2 eta^2 L^2 (2 tau^3 - 3 tau^2 + tau) / (3 - 6 eta^2 L^2 tau^2)
  A2 = eta L tau + eta^2 L^2 (tau^2 - tau) / (1 - 2 eta^2 L^2 tau^2)

This module computes those coefficients and the per-round contributions that
feed the Lyapunov queues.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BoundConstants:
    """Hyper-parameters of the convergence bound."""

    eta: float  # learning rate
    tau: int    # local updates per round
    lipschitz: float  # L-smoothness constant

    def __post_init__(self) -> None:
        if self.eta * self.lipschitz >= 1.0:
            raise ValueError(
                f"Theorem 1 requires eta*L < 1, got {self.eta * self.lipschitz}"
            )
        if 2 * (self.eta * self.tau * self.lipschitz) ** 2 >= 1.0:
            raise ValueError(
                "Theorem 2 requires 2 eta^2 tau^2 L^2 < 1, got "
                f"{2 * (self.eta * self.tau * self.lipschitz) ** 2}"
            )

    @property
    def a1(self) -> float:
        eta, tau, L = self.eta, self.tau, self.lipschitz
        num = 2.0 * eta**2 * L**2 * (2 * tau**3 - 3 * tau**2 + tau)
        den = 3.0 - 6.0 * eta**2 * L**2 * tau**2
        return num / den

    @property
    def a2(self) -> float:
        eta, tau, L = self.eta, self.tau, self.lipschitz
        return eta * L * tau + eta**2 * L**2 * (tau**2 - tau) / (
            1.0 - 2.0 * eta**2 * L**2 * tau**2
        )


def data_term(
    consts: BoundConstants,
    a: np.ndarray,        # (U,) participation in {0,1}
    w_full: np.ndarray,   # (U,) static weights D_i / sum_j D_j
    w_round: np.ndarray,  # (U,) round weights a_i D_i / D^n (0 if out)
    g_sq: np.ndarray,     # (U,) gradient-norm-bound estimates squared
    sigma_sq: np.ndarray, # (U,) minibatch-variance estimates
    hetero: np.ndarray | None = None,  # (U,) scheduling multiplier (>= 1)
) -> float:
    """Per-round contribution to C6 (the eps1 constraint, eq. 20).

    ``hetero`` (when given) scales the *scheduling-exclusion* component
    only: leaving out a client with multiplier m costs m times more, so a
    Lyapunov controller schedules high-KL (label-skewed) clients more
    eagerly. The drift components are per-round sampling noise and do not
    depend on which clients were excluded, so they stay unscaled. ``None``
    (or all-ones) restores the heterogeneity-blind eq. 20 exactly.
    """
    tau = consts.tau
    g_sched = g_sq if hetero is None else g_sq * hetero
    sched = 4.0 * tau * np.sum((1.0 - a * w_full) * g_sched)
    drift = consts.a1 * np.sum(w_round * g_sq) + consts.a2 * np.sum(w_round * sigma_sq)
    return float(sched + drift)


def quant_term(
    consts: BoundConstants,
    w_round: np.ndarray,   # (U,)
    z: int,
    theta_max: np.ndarray,  # (U,) per-client model ranges
    q: np.ndarray,          # (U,) quantization levels (>=1); ignored where w=0
) -> float:
    """Per-round contribution to C7 (the eps2 constraint, eq. 21):
    L/2 * sum_i w_i^n * Z theta_max_i^2 / (4 (2^{q_i}-1)^2)."""
    levels = np.maximum(2.0 ** np.asarray(q, dtype=np.float64) - 1.0, 1e-12)
    per_client = z * np.asarray(theta_max, np.float64) ** 2 / (4.0 * levels**2)
    return float(consts.lipschitz / 2.0 * np.sum(np.asarray(w_round) * per_client))


def downlink_term(
    consts: BoundConstants,
    z: int,
    theta: float,   # broadcast range: max |target| of the downlink payload
    q: int,         # downlink quantization level
) -> float:
    """Per-round contribution of a quantized server->client broadcast to C7:
    L/2 * Z theta^2 / (4 (2^q - 1)^2).

    The broadcast error is common to every client (the round weights sum to
    one), so unlike :func:`quant_term` there is no per-client ``w_round``
    sum — one Lemma-1 variance bound at the broadcast range/level. The
    engine feeds the *previous* round's realized term into the current
    decision (the error a client trains on this round was injected by last
    round's broadcast).
    """
    levels = max(2.0 ** float(q) - 1.0, 1e-12)
    return float(consts.lipschitz / 2.0 * z * float(theta) ** 2
                 / (4.0 * levels**2))


def realized_terms(
    consts: BoundConstants,
    a_real: np.ndarray,     # (U,) REALIZED participation (post-screen)
    d_sizes: np.ndarray,    # (U,)
    g_sq: np.ndarray,       # (U,) normalized G^2 estimates (decision inputs)
    sigma_sq: np.ndarray,   # (U,)
    theta_max: np.ndarray,  # (U,) pre-update range estimates
    q: np.ndarray,          # (U,) executed levels (>= 1 where scheduled)
    z: int,
    hetero: np.ndarray | None = None,
    dl_term: float = 0.0,
) -> tuple[float, float]:
    """Eq. 20/21 re-evaluated at the *realized* participation.

    Under fault injection a scheduled slot can fail to deliver (outage,
    realized timeout, screened payload). The Lyapunov queues must then be
    fed what actually happened, not what the controller planned: a failed
    client re-enters the scheduling-exclusion sum ``(1 - a w_full)`` exactly
    like a client that was never scheduled, and drops out of the round
    weights ``w_round``. Same inputs the planned terms saw (normalized
    G^2/sigma^2, pre-update theta_max, the decision's q), only ``a``
    differs — so with zero realized faults these reduce to the planned
    terms exactly.
    """
    a = np.asarray(a_real, np.float64)
    d = np.asarray(d_sizes, np.float64)
    w_full = d / np.sum(d)
    d_n = float(np.sum(a * d))
    w_round = a * d / max(d_n, 1e-12)
    dt = data_term(consts, a, w_full, w_round, g_sq, sigma_sq, hetero)
    qt = quant_term(consts, w_round, z, theta_max, np.maximum(q, 1))
    return float(dt), float(qt + dl_term)
