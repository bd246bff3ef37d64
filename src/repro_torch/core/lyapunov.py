"""Lyapunov virtual queues and drift-plus-penalty (paper Sec. V-A, eq. 23-26).

Two virtual queues track the long-term convergence constraints:

  lambda1^{n+1} = max(lambda1^n + data_term^n   - eps1, 0)   (eq. 23)
  lambda2^{n+1} = max(lambda2^n + quant_term^n  - eps2, 0)   (eq. 24)

Satisfying C6/C7 is equivalent to mean-rate stability of the queues.
The per-round objective (eq. 26, dropping the constant A0) is

  J^n = (lambda1 - eps1) * data_term
      + (lambda2 - eps2) * quant_term_unscaled
      + V * total_energy
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LyapunovState:
    lambda1: float = 0.0
    lambda2: float = 0.0
    eps1: float = 1.0
    eps2: float = 1.0
    v: float = 100.0  # penalty weight V (energy vs. FL performance trade-off)
    # The paper's eq. 26 keeps the cross terms as (lambda - eps) * x, which
    # REWARDS violating the constraint whenever the queue is shorter than
    # its budget (lambda < eps): at cold start and again at equilibrium the
    # controller then schedules nobody and training stalls. The standard
    # drift expansion 1/2 (max(lambda + x - eps, 0))^2 - 1/2 lambda^2
    # <= lambda * (x - eps) + 1/2 (x - eps)^2 gives the sound cross term
    # lambda * x (lambda >= 0): violation is never rewarded. We default to
    # the sound form; set paper_drift=True for the literal eq. 26.
    paper_drift: bool = False

    @property
    def coef1(self) -> float:
        return (self.lambda1 - self.eps1) if self.paper_drift else self.lambda1

    @property
    def coef2(self) -> float:
        return (self.lambda2 - self.eps2) if self.paper_drift else self.lambda2

    @property
    def eps2_for_kkt(self) -> float:
        """The KKT solver consumes (lambda2 - eps2_for_kkt) as the quant
        coefficient; 0 in the sound form."""
        return self.eps2 if self.paper_drift else 0.0

    def step(self, data_term: float, quant_term: float) -> "LyapunovState":
        """Advance the queues after a round (eq. 23/24)."""
        return dataclasses.replace(
            self,
            lambda1=max(self.lambda1 + data_term - self.eps1, 0.0),
            lambda2=max(self.lambda2 + quant_term - self.eps2, 0.0),
        )

    def drift_plus_penalty(
        self, data_term: float, quant_term: float, energy: float
    ) -> float:
        """J^n of P2 (eq. 27) for a candidate decision."""
        return (
            self.coef1 * data_term
            + self.coef2 * quant_term
            + self.v * energy
        )

    @property
    def mean_rate(self) -> tuple[float, float]:
        return self.lambda1, self.lambda2


def queue_stability_trace(
    terms1: list[float], terms2: list[float], eps1: float, eps2: float
) -> tuple[list[float], list[float]]:
    """Offline helper: evolve both queues over recorded per-round terms.

    Used in tests to assert mean-rate stability lim E[lambda^n]/n = 0.
    """
    l1, l2 = 0.0, 0.0
    t1, t2 = [], []
    for a, b in zip(terms1, terms2):
        l1 = max(l1 + a - eps1, 0.0)
        l2 = max(l2 + b - eps2, 0.0)
        t1.append(l1)
        t2.append(l2)
    return t1, t2
