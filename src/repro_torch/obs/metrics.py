"""Per-round metric taps: the ``RoundMetrics`` record and its gate (the port
of ``repro.obs.metrics``).

The fleet round computes a :class:`RoundMetrics` per round when the sim was
built with ``telemetry=MetricsConfig(enabled=True)``: the Lyapunov drift
terms, the comp/comm/timeout energy split, quantization-level statistics
with the Theorem-3 value before integerization, the realized quantization
MSE against the unquantized aggregate, timeout counts, the per-round
corr(q, D) (the paper's Remark 2 diagnostic), the GA fitness spread in the
GA modes, and the downlink and fault counters when those are on. The taps
stay on the device as 0-d tensors and are stacked to (N,) with the round's
other outputs: no host sync per round.

Gating: every tap sits behind the config, so a sim built without telemetry
(``None`` or ``enabled=False``) runs the same operations as one that never
heard of it, and turning it on adds outputs without changing any.

``decision_metrics`` serves both runs: the compiled round calls it on the
decision's tensors, and ``run_host_policy`` calls it through
``decision_metrics_host`` on fp32 tensors built from the host decision, on
the sim's device. Fields whose inputs are exact in both (the integer
schedule, q levels, dataset sizes: q_mean/q_max, corr_q_d, n_timeout) then
come out bit-equal; the float fields that depend on the host's f64 scalar
KKT (energy splits, drift terms) agree to ~1e-5.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Telemetry gate. Frozen and hashable: it selects what a round
    computes, it never rides through one.

    enabled     master switch; False runs the untapped round.
    quant_mse   tap ||agg - exact||^2 / Z against the unquantized update
                (one extra (S, Z) product per round).
    ga_fitness  tap the best/median population fitness in the GA modes
                (``ga_best``/``ga_median`` are NaN in the others).
    """

    enabled: bool = False
    quant_mse: bool = True
    ga_fitness: bool = True


METRICS_OFF = MetricsConfig()


@dataclasses.dataclass
class RoundMetrics:
    """Per-round taps, each a 0-d fp32 tensor (or (N,) once stacked)."""

    data_term: Any      # eq. 20 drift (lambda1 queue input)
    quant_term: Any     # eq. 21 drift (lambda2 queue input)
    energy_comp: Any    # sum of tau_e*alpha*gamma*D_i*f_i^2 over spenders
    energy_comm: Any    # total energy minus the compute part
    energy_timeout: Any # energy burned by clients that timed out (a=0)
    n_timeout: Any      # count of energy>0 & a=0 clients (baseline pathology)
    q_mean: Any         # mean integer q over scheduled clients
    q_max: Any          # max integer q this round
    q_cont_mean: Any    # mean Theorem-3 pre-integerization q (baselines: raw policy level)
    quant_mse: Any      # ||agg - sum_s w_s theta_s||^2 / Z (NaN if untapped)
    corr_q_d: Any       # Pearson corr(q_i, D_i) over scheduled (Remark 2; NaN if undefined)
    ga_best: Any        # final-generation best J0 (NaN for non-GA modes)
    ga_median: Any      # final-generation median population J0 (NaN likewise)
    dl_payload_bits: Any  # downlink broadcast payload (NaN when downlink off)
    dl_mse: Any         # ||broadcast - exact aggregate||^2 / Z (NaN if off/untapped)
    n_dropped: Any      # scheduled slots lost to client outage (NaN when faults off)
    n_screened: Any     # all scheduled-but-failed slots: outage + realized timeout + corrupt/non-finite (NaN likewise)
    n_timeout_real: Any # planned successes turned realized timeouts by fades (NaN likewise)


METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(RoundMetrics))


def _sums(*vecs: torch.Tensor) -> list[torch.Tensor]:
    """fp32 sums of equal-length vectors. On the card, one ``torch.sum``
    over the stack. On the CPU, in index order: the JAX package's CPU
    taps of a small fleet (the tests' U = 8) add in index order, where
    torch's vectorized CPU sum parts from them in the last bit, and
    corr(q, D)'s centred sums are not exact in any order."""
    stacked = torch.stack(vecs)
    if stacked.device.type != "cpu":
        return list(torch.sum(stacked, dim=1))
    acc = torch.zeros(stacked.shape[0], dtype=stacked.dtype)
    for i in range(stacked.shape[1]):
        acc = acc + stacked[:, i]
    return list(acc)


def decision_metrics(
    a: torch.Tensor,          # (U,) participation {0,1}
    q: torch.Tensor,          # (U,) integer levels (0 where out)
    q_cont: torch.Tensor,     # (U,) continuous pre-integerization q
    f: torch.Tensor,          # (U,) CPU frequency (0 where no energy spent)
    energy: torch.Tensor,     # (U,) per-client round energy
    d_sizes: torch.Tensor,    # (U,) dataset sizes
    data_term: torch.Tensor,  # scalar
    quant_term: torch.Tensor, # scalar
    sysp,                     # SystemParams (tau_e/alpha/gamma)
) -> RoundMetrics:
    """The taps of one decision, on its device: a :class:`RoundMetrics`
    with the quant_mse / ga_* / downlink / fault slots NaN (the round
    fills them from the wire, the search and the screen when on)."""
    f32 = torch.float32
    af = (a > 0).to(f32)
    spent = energy > 0.0
    d32 = d_sizes.to(f32)
    zero = torch.zeros_like(energy)

    comp_i = sysp.tau_e * sysp.alpha * sysp.gamma * d32 * f**2
    timed_out = spent & (af == 0.0)
    qf = q.to(f32)
    e_comp, e_total, e_timeout, n_timeout, n, q_sum, qc_sum, d_sum = _sums(
        torch.where(spent, comp_i, zero), energy.to(f32), torch.where(timed_out, energy, zero),
        timed_out.to(f32), af, qf * af, q_cont.to(f32) * af, d32 * af)
    n_safe = torch.clamp(n, min=1.0)
    q_mean = q_sum / n_safe
    q_max = torch.amax(qf)
    qc_mean = qc_sum / n_safe

    # Pearson corr(q, D) over the scheduled set (Remark 2): NaN when the
    # round has < 2 participants or a degenerate variance
    d_mean = d_sum / n_safe
    dq = (qf - q_mean) * af
    dd = (d32 - d_mean) * af
    cov, var_q, var_d = _sums(dq * dd, dq * dq, dd * dd)
    denom = torch.sqrt(var_q * var_d)
    nan = torch.full((), math.nan, dtype=f32, device=energy.device)
    corr = torch.where((n >= 2.0) & (denom > 0.0), cov / torch.clamp(denom, min=1e-30), nan)

    return RoundMetrics(
        data_term=torch.as_tensor(data_term).to(f32),
        quant_term=torch.as_tensor(quant_term).to(f32),
        energy_comp=e_comp, energy_comm=e_total - e_comp,
        energy_timeout=e_timeout, n_timeout=n_timeout,
        q_mean=q_mean, q_max=q_max, q_cont_mean=qc_mean,
        quant_mse=nan, corr_q_d=corr, ga_best=nan, ga_median=nan,
        dl_payload_bits=nan, dl_mse=nan,
        n_dropped=nan, n_screened=nan, n_timeout_real=nan,
    )


def decision_metrics_host(
    a: np.ndarray, q: np.ndarray, q_cont: np.ndarray, f: np.ndarray,
    energy: np.ndarray, d_sizes: np.ndarray, data_term: float,
    quant_term: float, sysp,
    quant_mse: Optional[float] = None,
    ga_best: Optional[float] = None,
    ga_median: Optional[float] = None,
    dl_payload_bits: Optional[float] = None,
    dl_mse: Optional[float] = None,
    n_dropped: Optional[float] = None,
    n_screened: Optional[float] = None,
    n_timeout_real: Optional[float] = None,
    device: Any = "cpu",
) -> dict:
    """Host replay of :func:`decision_metrics`: the same function on fp32
    tensors built from the host decision's arrays on ``device`` (the sim's,
    so the sums run as the round's do), hence every field whose inputs are
    exact in both runs comes out bit-equal to the round's tap. Returns a
    plain dict ready for a ledger ``round`` row."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    rm = decision_metrics(
        t(a, torch.int32), t(q, torch.int32), t(q_cont, torch.float32),
        t(f, torch.float32), t(energy, torch.float32), t(d_sizes, torch.float32),
        t(np.float32(data_term), torch.float32), t(np.float32(quant_term), torch.float32),
        sysp,
    )
    out = metrics_to_dict(rm)
    given = dict(quant_mse=quant_mse, ga_best=ga_best, ga_median=ga_median,
                 dl_payload_bits=dl_payload_bits, dl_mse=dl_mse, n_dropped=n_dropped,
                 n_screened=n_screened, n_timeout_real=n_timeout_real)
    out.update({k: float(v) for k, v in given.items() if v is not None})
    return out


def metrics_to_dict(rm: RoundMetrics) -> dict:
    """RoundMetrics (scalars or (N,) stacks) -> {field: numpy value}."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return {name: host(getattr(rm, name)) for name in METRIC_FIELDS}
