"""Round records and the Policy interface of the FL experiments (the part
of ``repro.fl.trainer`` the fleet simulator uses; ``FLExperiment``, the
object-based round loop, is not ported yet: ROADMAP.md Queue 1, item 6)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.genetic import Decision, RoundContext


@dataclasses.dataclass
class RoundRecord:
    round: int
    energy: float
    cum_energy: float
    accuracy: float
    loss: float
    n_scheduled: int
    q_levels: np.ndarray
    latency: float
    payload_bits: float
    # per-client assigned uplink rate [bit/s], 0 where unscheduled — q_i is
    # driven jointly by (v_i, D_i), so analyses of Remark 1/2 behaviour need
    # the realized rate to condition on.
    rates: Optional[np.ndarray] = None


@dataclasses.dataclass
class ExperimentResult:
    name: str
    records: list[RoundRecord]

    @property
    def cum_energy(self) -> np.ndarray:
        return np.array([r.cum_energy for r in self.records])

    @property
    def accuracy(self) -> np.ndarray:
        return np.array([r.accuracy for r in self.records])

    def summary(self) -> dict:
        last = self.records[-1]
        return {
            "name": self.name,
            "rounds": len(self.records),
            "final_accuracy": last.accuracy,
            "total_energy_J": last.cum_energy,
            "mean_q": float(np.mean([r.q_levels[r.q_levels > 0].mean()
                                     for r in self.records if (r.q_levels > 0).any()] or [0])),
        }


class Policy:
    """Interface: produce a Decision each round, observe the outcome."""

    name = "policy"

    def decide(self, ctx: RoundContext) -> Decision:
        raise NotImplementedError

    def commit(self, dec: Decision) -> None:
        pass
