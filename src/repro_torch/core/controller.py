"""QCCF per-round controller (paper Sec. V, steps 1 of Fig. 1).

Wires together: Lyapunov queues (eq. 23/24) -> GA over (a, R) (Algorithm 1)
-> per-client KKT closed form over (f, q) (eq. 41/42) -> queue update.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import bounds
from repro_torch.core.genetic import (
    Decision,
    GAConfig,
    RoundContext,
    SystemParams,
    run_ga,
)
from repro_torch.core.lyapunov import LyapunovState


@dataclasses.dataclass
class ControllerLog:
    """Per-round trace used by benchmarks and EXPERIMENTS.md plots."""

    rounds: list[int] = dataclasses.field(default_factory=list)
    energy: list[float] = dataclasses.field(default_factory=list)
    q_levels: list[np.ndarray] = dataclasses.field(default_factory=list)
    participation: list[np.ndarray] = dataclasses.field(default_factory=list)
    lambda1: list[float] = dataclasses.field(default_factory=list)
    lambda2: list[float] = dataclasses.field(default_factory=list)


class QCCFController:
    """Server-side decision maker. One instance per FL experiment."""

    def __init__(
        self,
        n_clients: int,
        sysp: SystemParams,
        v_weight: float,
        eps1: float,
        eps2: float,
        ga: GAConfig = GAConfig(),
        seed: int = 0,
        paper_drift: bool = False,
        prime_queues: bool = False,
    ) -> None:
        self.n_clients = n_clients
        self.sysp = sysp
        self.ga = ga
        self.v_weight = v_weight
        # paper_drift=True uses the literal eq. 26 cross term (lambda - eps)
        # which rewards constraint violation while lambda < eps (training
        # stalls at cold start and at equilibrium); the default uses the
        # sound lambda * x expansion — see LyapunovState. prime_queues
        # starts the queues at eps (only meaningful with paper_drift).
        l1 = eps1 if prime_queues else 0.0
        l2 = eps2 if prime_queues else 0.0
        self.lyap = LyapunovState(lambda1=l1, lambda2=l2, eps1=eps1, eps2=eps2,
                                  v=v_weight, paper_drift=paper_drift)
        self.q_prev = np.full(n_clients, 2.0)  # warm start for Taylor/Case-5
        self.last_assign: Optional[np.ndarray] = None
        self.round = 0
        self.log = ControllerLog()
        self._seed = seed

    def decide(self, ctx: RoundContext) -> Decision:
        """Step 1 (Decision): produce (a, R, q, f) for this round."""
        seeds = [self.last_assign] if self.last_assign is not None else None
        dec = run_ga(
            ctx,
            self.sysp,
            self.lyap,
            self.v_weight,
            cfg=self.ga,
            q_prev=self.q_prev,
            seed=self._seed + self.round,
            seed_chromosomes=seeds,
        )
        self.last_assign = dec.assign
        for i in range(self.n_clients):
            if dec.a[i]:
                self.q_prev[i] = dec.q[i]
        return dec

    def commit(self, dec: Decision) -> None:
        """After the round executes: advance the virtual queues (eq. 23/24)."""
        self.lyap = self.lyap.step(dec.data_term, dec.quant_term)
        self.log.rounds.append(self.round)
        self.log.energy.append(dec.total_energy)
        self.log.q_levels.append(dec.q.copy())
        self.log.participation.append(dec.a.copy())
        self.log.lambda1.append(self.lyap.lambda1)
        self.log.lambda2.append(self.lyap.lambda2)
        self.round += 1


def auto_epsilons(
    ctx: RoundContext, sysp: SystemParams, target_q: float = 6.0
) -> tuple[float, float]:
    """Heuristic budgets eps1/eps2: the per-round bound terms of a nominal
    schedule-everyone / quantize-at-target_q policy. Keeps the queues near
    equilibrium so the drift term is informative from round one."""
    consts = sysp.bound_constants()
    u = ctx.d_sizes.shape[0]
    a = np.ones(u, dtype=np.int64)
    w_full = ctx.d_sizes / np.sum(ctx.d_sizes)
    eps1 = bounds.data_term(consts, a, w_full, w_full, ctx.g_sq, ctx.sigma_sq)
    eps2 = bounds.quant_term(
        consts, w_full, ctx.z, ctx.theta_max, np.full(u, target_q)
    )
    return float(eps1), float(eps2)
