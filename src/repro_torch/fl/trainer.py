"""The 5-step FL round loop (paper Fig. 1) with pluggable decision policies
(the port of ``repro.fl.trainer``).

One ``FLExperiment`` = server + U clients + wireless simulator + a policy
(QCCF or a baseline from ``repro_torch.fl.baselines``). Each round:
  1. Decision   : policy produces (a, R, q, f) from channel states + stats
  2. Broadcast  : global model to scheduled clients (downlink, free)
  3. Local+Quant: tau local SGD steps, then q_i-bit stochastic quantization
  4. Upload     : energy/latency accounted from eq. 14-17
  5. Aggregate  : theta^n = sum_i w_i^n Q(theta_i^{n,tau})   (eq. 2)

The model and the clients' data live on the experiment's device; the
decision, the channel and the estimators' state are numpy on the host, as
in the JAX package. The quantizer's uniforms come from an entropy source
(:class:`UploadEntropy` by default), asked once per scheduled client in
client order for one tensor per leaf: the JAX package splits its key the
same way, so a test can hand the port JAX's own uniforms.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import quantization
from repro_torch.core.genetic import Decision, RoundContext, SystemParams
from repro_torch.device import exact_fp32, resolve_device
from repro_torch.fl.client import FLClient
from repro_torch.obs.profile import annotate as _annotate
from repro_torch.wireless.channel import ChannelModel

Tree = Any


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


class UploadEntropy:
    """The uploads' stochastic-rounding uniforms from one ``torch.Generator``
    on ``device`` seeded with ``seed`` (the JAX runtime's ``PRNGKey(seed)``
    chain). A parity test passes an object with the same method that
    returns the JAX package's uniforms."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def upload_uniforms(self, shapes: Sequence[tuple]) -> list[torch.Tensor]:
        """One fp32 tensor in [0, 1) of each shape (one client's leaves)."""
        return [torch.rand(shape, generator=self.generator, device=self.device)
                for shape in shapes]


class FLExperiment:
    """The object runtime: ``run(n)`` plays n rounds of Fig. 1 over
    ``clients`` on ``device`` (``cuda`` unless the caller passes another;
    raises without CUDA). ``init_params`` is a ``repro_torch.models.cnn``
    parameter tree; ``eval_fn(params) -> (accuracy, loss)`` as floats.
    ``entropy`` replaces the default :class:`UploadEntropy`.
    ``theta_max_fn`` is accepted for the JAX signature and unused there
    too."""

    def __init__(
        self,
        clients: list[FLClient],
        init_params: Tree,
        eval_fn: Callable[[Tree], tuple[float, float]],
        channel: ChannelModel,
        sysp: SystemParams,
        policy: Policy,
        *,
        lr: float = 0.05,
        seed: int = 0,
        theta_max_fn: Optional[Callable[[Tree], float]] = None,
        device=None,
        entropy: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        self.clients = clients
        self.params = tree_util.map(lambda t: t.to(self.device), init_params)
        self.eval_fn = eval_fn
        self.channel = channel
        self.sysp = sysp
        self.policy = policy
        self.lr = lr
        self.entropy = UploadEntropy(seed, self.device) if entropy is None else entropy
        self.z = quantization.pytree_size(init_params)
        self.d_sizes = np.array([c.d_size for c in clients], dtype=np.float64)
        # online estimator state (EMA of G^2 / sigma^2 per client)
        u = len(clients)
        self.g_sq = np.full(u, 1.0)
        self.sigma_sq = np.full(u, 1.0)
        self.theta_max = np.full(u, 1.0)
        self._cum_energy = 0.0

    def _context(self) -> RoundContext:
        # G_i^2 / sigma_i^2 enter the bound terms linearly, so only their
        # RELATIVE per-client magnitudes inform scheduling; normalizing to
        # mean 1 keeps the queue dynamics stationary as the true gradient
        # norms shrink during training.
        g = self.g_sq / max(float(np.mean(self.g_sq)), 1e-12)
        s = self.sigma_sq / max(float(np.mean(self.sigma_sq)), 1e-12)
        return RoundContext(
            rates=self.channel.draw_rates(),
            d_sizes=self.d_sizes,
            g_sq=g,
            sigma_sq=s,
            theta_max=self.theta_max.copy(),
            z=self.z,
        )

    def run(self, n_rounds: int, eval_every: int = 1, verbose: bool = False
            ) -> ExperimentResult:
        # every round in full fp32 with deterministic cuDNN, as the fleet
        # engine runs: the card's numbers are the fp32 reference's
        with exact_fp32():
            return self._run(n_rounds, eval_every, verbose)

    def _run(self, n_rounds: int, eval_every: int, verbose: bool) -> ExperimentResult:
        records: list[RoundRecord] = []
        acc, loss = self.eval_fn(self.params)
        for n in range(n_rounds):
            ctx = self._context()
            with _annotate("fl_decide"):
                dec = self.policy.decide(ctx)
            v_assigned = np.zeros(len(self.clients))
            for c, cid in enumerate(dec.assign):
                if cid >= 0:
                    v_assigned[cid] += float(ctx.rates[cid, c])

            uploads = []
            weights = []
            d_n = float(np.sum(dec.a * self.d_sizes))
            payload = 0.0
            with _annotate("fl_local_quant"):
                for i, client in enumerate(self.clients):
                    if not dec.a[i]:
                        continue
                    theta_i, g_sq, sig_sq = client.local_update(
                        self.params, self.sysp.tau, self.lr
                    )
                    self.g_sq[i] = 0.7 * self.g_sq[i] + 0.3 * g_sq
                    self.sigma_sq[i] = (
                        0.7 * self.sigma_sq[i] + 0.3 * max(sig_sq, 1e-8)
                    )
                    q_i = int(max(dec.q[i], 1))
                    u01 = self.entropy.upload_uniforms(
                        [tuple(leaf.shape) for leaf in tree_util.leaves(theta_i)])
                    quantized, tmax = quantization.quantize_pytree(u01, theta_i, q_i)
                    self.theta_max[i] = float(tmax)
                    uploads.append(quantized)
                    weights.append(self.d_sizes[i] / d_n)
                    payload += quantization.payload_bits(self.z, q_i)

            if uploads:
                with _annotate("fl_aggregate"):
                    # eq. 2 in the JAX order, 0 + w_0 theta_0 + w_1 theta_1 + ...,
                    # each float64 weight rounded to fp32 in the product
                    self.params = tree_util.map(
                        lambda *leaves: sum(w * leaf for w, leaf in zip(weights, leaves)),
                        *uploads,
                    )

            self.policy.commit(dec)
            self._cum_energy += dec.total_energy
            if (n + 1) % eval_every == 0 or n == n_rounds - 1:
                acc, loss = self.eval_fn(self.params)
            records.append(
                RoundRecord(
                    round=n,
                    energy=dec.total_energy,
                    cum_energy=self._cum_energy,
                    accuracy=acc,
                    loss=loss,
                    n_scheduled=int(dec.a.sum()),
                    q_levels=dec.q.copy(),
                    latency=float(dec.latency.max() if dec.a.any() else 0.0),
                    payload_bits=payload,
                    rates=v_assigned,
                )
            )
            if verbose:
                print(
                    f"[{self.policy.name}] r{n:03d} acc={acc:.3f} "
                    f"E={self._cum_energy:.3f}J sched={int(dec.a.sum())} "
                    f"q={dec.q[dec.a.astype(bool)] if dec.a.any() else []}"
                )
        return ExperimentResult(self.policy.name, records)
