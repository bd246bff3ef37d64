"""The fleet simulator's round on the device (the port of ``repro.sim.engine``).

``build_sim`` mirrors the JAX package's setup (same synthetic datasets, same
client drop, same eps1/eps2 calibration for a given seed), for the legacy
single-BS path or a scenario (``repro_torch.sim.scenario``);
``FleetSim.run_compiled`` then runs the rounds as an eager loop on the
device. One round:

  decision   — by ``policy_mode``: greedy channels + vectorised KKT
               (``greedy``, ``repro_torch.sim.policy``), the GA over
               channel assignments with the KKT fitness (``compiled-ga``,
               ``repro_torch.sim.search``), or one of the paper's four
               baselines (``no_quant``, ``channel_allocate``, ``principle``,
               ``same_size``), on the round's (U, C) rates
  compaction — gather the S = min(U, C) scheduled clients onto the slot
               axis; everything below is O(S)
  local work — tau-step SGD of the S slots under one ``torch.func.vmap``
  wire       — eq.-4 stochastic quantization of the S slot vectors into
               Zpad-shaped u8/u16 index planes + u8 sign planes
  faults     — (``faults=FaultSpec(...)`` only) NaN/Inf bursts before the
               wire, plane corruption after it, and the screen
               (``screen_slots``): a slot that failed enters the aggregate
               with weight 0 and the eq.-2 weights renormalize over the rest
  aggregate  — fused dequantize + eq.-2 weighted sum through the CUDA
               ``aggregate`` kernel (``repro_torch.kernels``), one launch
  downlink   — (``downlink="quant"|"delta"`` only) the aggregate is
               broadcast through eq.-4 quantization; clients start the next
               round from what they decode, and its error term enters the
               next decision
  scatter    — masked EMA updates of the (U,) G²/σ²/θ estimators
  queues     — Lyapunov lambda1/lambda2 updates (at the realized
               participation under faults)

``run_host_policy`` lets a host Policy (the numpy oracles of each mode,
``make_host_policy``) make the decisions while the slot work runs through
the same ``_exec_round`` as the compiled round. The round's random draws
come from an entropy source (``repro_torch.sim.entropy``), in one order
for both runs; each run starts from the source's state when the sim was
built, so two runs of one sim are the same run. Every round runs in full
fp32 with cuDNN's deterministic algorithms (``repro_torch.device.exact_fp32``),
whatever flags the caller set, and the caller's flags come back after the
run. ``run_compiled(n, segment=k, ckpt_dir=d)`` checkpoints the
state at every segment boundary (``repro_torch.ckpt``), the entropy
source's generator state included, and ``resume_compiled(d)`` finishes a
run from its latest checkpoint.

Telemetry (``telemetry=MetricsConfig(enabled=True)``, ``repro_torch.obs``)
adds per-round taps that stay on the device and are stacked into
``SimResult.metrics``; a ledger (``ledger=Ledger(path)``) gets a run
header, one row per round and the run's timing after every run, and a
``resume`` event per checkpoint saved or loaded. Both only add outputs:
with telemetry on or off every other output is the same, bit for bit.

Each layer of a round runs inside a profiler range
(``repro_torch.obs.profile.scope``), so a ``torch.profiler`` trace gives
every launch and every idle stretch of the device a layer: ``draw_inputs``
(each call into the entropy source), ``greedy_assign``, ``decision_terms``
and ``kkt_solve`` (``repro_torch.sim.policy``), ``gather_active``,
``fleet_local_sgd``, ``quantize_wire``, ``wire_aggregate``, ``eval_model``,
``round_state`` (the queue state before the decision, the slot compaction,
the scatter and queue updates after the slot work) and ``results_to_host``
(a segment's one copy to the host). The ranges are siblings, none inside
another but the kernel's own ``cuda_aggregate`` inside ``wire_aggregate``,
and a round is told by their order; no loop step has a range of its own.
Outside a capture a range costs one context-manager entry.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import ckpt
from repro_torch import tree as tree_util
from repro_torch.core import bounds
from repro_torch.core import quantization as core_quant
from repro_torch.core.controller import auto_epsilons
from repro_torch.core.genetic import GAConfig, RoundContext, SystemParams
from repro_torch.data.synthetic import (
    SyntheticImageTask, gaussian_sizes, hetero_kl, make_federated_datasets,
    make_test_set,
)
from repro_torch.device import exact_fp32, resolve_device
from repro_torch.fl import baselines as fl_baselines
from repro_torch.fl.experiment import TASKS, task_data_sizes
from repro_torch.fl.trainer import ExperimentResult, RoundRecord
from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quant as sq
from repro_torch.models import cnn
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsConfig
from repro_torch.obs.profile import scope as _profile_scope
from repro_torch.sim import policy as fast_policy
from repro_torch.sim import search
from repro_torch.sim.channel import SimChannel, draw_rates
from repro_torch.sim.entropy import DeviceEntropy
from repro_torch.sim.fleet import (
    Fleet, build_fleet, ema_update, fleet_local_sgd, gather_active,
    scatter_slots,
)
from repro_torch.sim.scenario import FAULTS_OFF, FaultSpec, get_scenario
from repro_torch.wireless.channel import ChannelModel, ChannelParams

LANES = sq.LANES
# Zpad is Z rounded up to 64-row tiles of 128 lanes, the JAX engine's
# aggregate tile: it fixes the (S, Zpad) uniform draws a test replays
_ZPAD_ROWS = 64

# scenario policy names -> engine modes (the engine keeps its historical
# mode names; scenarios speak the POLICIES vocabulary)
POLICY_MODE_ALIASES = {"qccf": "greedy", "qccf_ga": "compiled-ga"}
POLICY_MODES = ("greedy", "host-ga", "compiled-ga", "no_quant", "channel_allocate",
                "principle", "same_size")
# the modes whose queue terms carry the heterogeneity multiplier and the
# downlink term (the baselines are blind to both, as in the JAX package)
_QCCF_MODES = ("greedy", "compiled-ga", "host-ga")
# the checkpoint kind a segmented run writes
_SEGMENT_KIND = "sim_segment"


# ------------------------------------------------------------------ faults
#
# Functions of one round's draws (``entropy.FaultDraws``) and the fault
# vector ``fv`` = ``FaultSpec.dyn_vector()`` on the device: [outage_p,
# outage_corr, fade_p, fade_mult, corrupt_p, corrupt_frac, nan_p].

def draw_outage(u_out: torch.Tensor, out_state: torch.Tensor, fv: torch.Tensor) -> torch.Tensor:
    """(U,) bool outage of the (optionally Markov) client process from (U,)
    uniforms; ``out_state`` is last round's state (1.0 = was down).
    P(down | was down) = p + corr (1 - p), P(down | was up) = p (1 - corr)."""
    p, corr = fv[0], fv[1]
    thresh = torch.where(out_state > 0, p + corr * (1.0 - p), p * (1.0 - corr))
    return u_out < thresh


def draw_fade(u_fade: torch.Tensor, fv: torch.Tensor):
    """((U,) bool fade hit, (U,) realized-rate multiplier: fade_mult where
    hit, 1.0 elsewhere)."""
    hit = u_fade < fv[2]
    return hit, torch.where(hit, fv[3], torch.ones_like(u_fade))


def inject_burst(u_burst: torch.Tensor, slots: torch.Tensor, flat_s: torch.Tensor,
                 fv: torch.Tensor) -> torch.Tensor:
    """NaN/Inf gradient bursts: with prob nan_p a scheduled slot's update is
    replaced (half the bursts NaN, half +Inf) before the wire, so its range
    is non-finite and the screen rejects it."""
    hit = (u_burst < fv[6]) & (slots >= 0)
    val = torch.where(u_burst < 0.5 * fv[6], torch.full_like(u_burst, math.nan),
                      torch.full_like(u_burst, math.inf))
    return torch.where(hit[:, None], val[:, None], flat_s)


def corrupt_planes(u_hit: torch.Tensor, u_site: torch.Tensor, bits: torch.Tensor,
                   idx: torch.Tensor, signs: torch.Tensor, fv: torch.Tensor):
    """Wire corruption: with prob corrupt_p a slot's index and sign planes
    get a corrupt_frac fraction of entries XORed with the random bytes
    ``bits`` (the same sites and bytes for both planes). The XOR runs in
    int32 (torch's CPU uint16 has none) and casts back to each plane's
    dtype."""
    flip = (u_hit < fv[4])[:, None] & (u_site < fv[5])
    idx32, signs32 = idx.to(torch.int32), signs.to(torch.int32)
    idx_c = torch.where(flip, idx32 ^ bits, idx32).to(idx.dtype)
    signs_c = torch.where(flip, signs32 ^ bits, signs32).to(signs.dtype)
    return idx_c, signs_c


def screen_slots(slots, q_slot, d_slot, v_slot, f_slot, theta, idx, signs,
                 down_u, fade_mult_u, fade_hit_u, sysp: SystemParams, z):
    """The graceful-degradation screen: per-slot delivery verdict + fault
    counters, shared by the compiled round and the host replay.

    A slot delivers iff it was scheduled, its client is not in outage, its
    realized (fade-scaled) round time meets t_max, its range is finite and
    its planes pass the range check (index <= 2^q - 1, sign byte <= 1). An
    un-faded slot is never a timeout: the decision already met t_max.
    Returns ``(ok, n_dropped, n_timeout_real, n_screened)``, the counts as
    fp32 scalars; n_screened counts every scheduled slot that failed.
    """
    sm = slots >= 0
    cid = torch.clamp(slots, min=0)
    drop = down_u[cid] & sm
    f_hit = fade_hit_u[cid] & sm
    mult = fade_mult_u[cid]
    qf = torch.clamp(q_slot, min=1).to(torch.float32)
    t_com = (z * qf + z + fast_policy.RANGE_BITS) / torch.clamp(v_slot * mult, min=1e-6)
    t_cmp = sysp.tau_e * sysp.gamma * d_slot / torch.clamp(f_slot, min=1.0)
    timeout = f_hit & (t_cmp + t_com > sysp.t_max)
    plane_ok = sq.plane_in_range(idx, q_slot) & (torch.amax(signs, dim=1) <= 1)
    ok = sm & ~drop & ~timeout & torch.isfinite(theta) & plane_ok
    f32 = torch.float32
    return (ok, torch.sum(drop.to(f32)), torch.sum(timeout.to(f32)),
            torch.sum((sm & ~ok).to(f32)))


# ---------------------------------------------------------------- downlink

@dataclasses.dataclass(frozen=True)
class DownlinkConfig:
    """The server->client broadcast wire.

    mode    "off"   — fp32 broadcast: the round and its draws as without a
                      downlink;
            "quant" — quantize the aggregate at ``q_bits`` (eq. 4 on the
                      flat model, one shared range); the next round's local
                      SGD starts from the decoded model;
            "delta" — quantize the aggregate minus the previous broadcast
                      instead; clients rebuild prev + decoded delta.
    q_bits  the broadcast's level (payload Z*q_bits + Z + 32 bits).
    """

    mode: str = "off"
    q_bits: int = 8

    def __post_init__(self) -> None:
        if self.mode not in ("off", "quant", "delta"):
            raise ValueError(f"downlink mode must be off/quant/delta, got {self.mode!r}")
        if not 1 <= int(self.q_bits) <= 16:
            raise ValueError(
                f"downlink q_bits={self.q_bits} outside the wire format's 1..16 "
                "(uint16 index plane)")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


DOWNLINK_OFF = DownlinkConfig()


@dataclasses.dataclass
class SimResult:
    """Stacked per-round arrays, (N, ...)-shaped numpy."""

    name: str
    energy: np.ndarray        # (N,)
    accuracy: np.ndarray      # (N,)
    loss: np.ndarray          # (N,)
    n_scheduled: np.ndarray   # (N,)
    q_levels: np.ndarray      # (N, U)
    latency: np.ndarray       # (N,)
    payload_bits: np.ndarray  # (N,)
    rates: np.ndarray         # (N, U) assigned uplink rates
    lambda1: np.ndarray       # (N,)
    lambda2: np.ndarray       # (N,)
    # telemetry taps ({field: (N,) fp32}, see repro_torch.obs.metrics); None
    # unless the sim was built with telemetry enabled
    metrics: Optional[dict] = None

    @property
    def cum_energy(self) -> np.ndarray:
        return np.cumsum(self.energy)

    def to_result(self) -> ExperimentResult:
        """Adapt to the object-based ``ExperimentResult`` API."""
        cum = self.cum_energy
        records = [
            RoundRecord(
                round=n,
                energy=float(self.energy[n]),
                cum_energy=float(cum[n]),
                accuracy=float(self.accuracy[n]),
                loss=float(self.loss[n]),
                n_scheduled=int(self.n_scheduled[n]),
                q_levels=self.q_levels[n].copy(),
                latency=float(self.latency[n]),
                payload_bits=float(self.payload_bits[n]),
                rates=self.rates[n].copy(),
            )
            for n in range(len(self.energy))
        ]
        return ExperimentResult(self.name, records)


def _stack_out(outs: list) -> dict:
    """Per-round output dicts of a segment -> one dict of (n, ...) numpy
    arrays, the telemetry taps flattened to a ``{field: (n,)}`` sub-dict
    (one copy to the host for all of them)."""
    with _profile_scope("results_to_host"):
        out = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
               for k in outs[0] if k != "metrics"}
        if "metrics" in outs[0]:
            fields = obs_metrics.METRIC_FIELDS
            taps = torch.stack([torch.stack([getattr(o["metrics"], f) for o in outs])
                                for f in fields]).cpu().numpy()
            out["metrics"] = dict(zip(fields, taps))
    return out


def _concat_out(parts: list) -> dict:
    """Concatenate per-segment :func:`_stack_out` dicts along the round
    axis (the checkpoint's and the result's format)."""
    return {k: ({kk: np.concatenate([p[k][kk] for p in parts]) for kk in v}
                if isinstance(v, dict) else np.concatenate([p[k] for p in parts]))
            for k, v in parts[0].items()}


def _pad_len(z: int) -> int:
    tile = _ZPAD_ROWS * LANES
    return ((z + tile - 1) // tile) * tile


def _quantize_wire(u01: torch.Tensor, flat_s: torch.Tensor, q: torch.Tensor,
                   q_cap: int, zpad: int):
    """(S, Z) slot params + per-slot q -> Zpad-shaped wire planes.

    Eq.-4 stochastic rounding with a per-slot level, driven by the (S, Zpad)
    uniforms ``u01``; the index dtype is u8 up to ``q_cap`` = 8, else u16.
    Padding coordinates are exact zeros (index 0, sign 0). ``theta`` is the
    range over the real Z coordinates. Returns (idx, signs, theta).
    """
    with _profile_scope("quantize_wire"):
        theta = torch.amax(torch.abs(flat_s), dim=1)                    # (S,)
        flat_p = F.pad(flat_s, (0, zpad - flat_s.shape[1]))
        safe = torch.where(theta > 0, theta, torch.ones_like(theta))
        levels = sq.levels_of(torch.clamp(q, min=1))                      # (S,)
        scaled = torch.abs(flat_p) * (levels / safe)[:, None]
        lower = torch.floor(scaled)
        frac = scaled - lower
        idx = torch.minimum(lower + (u01 < frac).to(torch.float32), levels[:, None])
        dtype = torch.uint8 if q_cap <= 8 else torch.uint16
        return idx.to(dtype), (flat_p < 0).to(torch.uint8), theta


class FleetSim:
    """Holds the static setup; ``run_compiled`` runs the rounds."""

    def __init__(
        self,
        fleet: Fleet,
        init_params: dict,
        loss_fn,
        eval_fn,                    # (flat_params) -> (acc, loss) tensors
        channel: SimChannel,
        sysp: SystemParams,
        *,
        eps1: float,
        eps2: float,
        v_weight: float = 100.0,
        lr: float = 0.05,
        batch_size: int = 32,
        q_cap: int = 8,
        seed: int = 0,
        hetero: Optional[np.ndarray] = None,  # (U,) scheduling multiplier
        name: str = "sim_qccf",
        entropy: Any = None,
        host_channel: Optional[ChannelModel] = None,
        policy_mode: str = "greedy",  # engine mode or scenario policy name
        ga_config: Optional[GAConfig] = None,
        downlink: Optional[DownlinkConfig] = None,
        faults: Optional[FaultSpec] = None,
        telemetry: Optional[MetricsConfig] = None,
        ledger: Optional[obs_ledger.Ledger] = None,
    ) -> None:
        if telemetry is not None and not isinstance(telemetry, MetricsConfig):
            raise TypeError(f"telemetry must be a MetricsConfig or None, got {type(telemetry)}")
        if ledger is not None and not isinstance(ledger, obs_ledger.Ledger):
            raise TypeError(f"ledger must be a repro_torch.obs Ledger or None, got {type(ledger)}")
        flat0, self._meta = ops.flatten_pytree(init_params)
        self.device = flat0.device
        self.flat0 = flat0
        self.z = int(flat0.shape[0])
        self.fleet = fleet
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.channel = channel
        self.sysp = sysp
        self.eps1, self.eps2 = float(eps1), float(eps2)
        self.v_weight = float(v_weight)
        self.lr = float(lr)
        self.batch_size = int(batch_size)
        self.q_cap = int(q_cap)
        self._zpad = _pad_len(self.z)
        self.seed = int(seed)
        self.name = name
        self.host_channel = host_channel
        policy_mode = POLICY_MODE_ALIASES.get(policy_mode, policy_mode)
        if policy_mode not in POLICY_MODES:
            raise ValueError(f"policy_mode {policy_mode!r} is none of {POLICY_MODES} "
                             f"or their aliases {sorted(POLICY_MODE_ALIASES)}")
        self.policy_mode = policy_mode
        # engine default: repair (drop infeasible clients), the greedy path's
        # feasibility semantics; pass a GAConfig for the paper's fitness-0 rule
        self.ga_config = GAConfig(repair_infeasible=True) if ga_config is None else ga_config
        u = fleet.n_clients
        self.hetero = None if hetero is None else np.asarray(hetero, np.float64)
        self._hetero = (torch.ones((u,), dtype=torch.float32, device=self.device)
                        if hetero is None else
                        torch.tensor(hetero, dtype=torch.float32, device=self.device))
        self._eps = torch.tensor([self.eps1, self.eps2], dtype=torch.float32,
                                 device=self.device)
        self.entropy = DeviceEntropy(self.seed, self.device) if entropy is None else entropy
        # a sequential source's state before any round: every run starts
        # from it, as every JAX run starts from the same round keys (a
        # replay source keyed by the round is stateless and has none)
        stateful = hasattr(self.entropy, "get_state") and hasattr(self.entropy, "set_state")
        self._entropy0 = self.entropy.get_state() if stateful else None
        self.downlink = DOWNLINK_OFF if downlink is None else downlink
        self.faults = FAULTS_OFF if faults is None else faults
        self._fv = (torch.tensor(self.faults.dyn_vector(), device=self.device)
                    if self.faults.enabled else None)
        if self.downlink.enabled:
            levels = 2.0 ** float(self.downlink.q_bits) - 1.0
            # a tensor divisor: torch divides by a Python float as a
            # multiply by its reciprocal on the card
            self._dl_den = torch.tensor(4.0 * levels**2, dtype=torch.float32,
                                        device=self.device)
            # the broadcast's payload, the telemetry's dl_payload_bits tap
            self._dl_bits = torch.tensor(core_quant.payload_bits(self.z, self.downlink.q_bits),
                                         dtype=torch.float32, device=self.device)
        # telemetry (repro_torch.obs): the gate selects what a round
        # computes; the ledger is the JSONL sink every run writes through
        self.metrics_cfg = obs_metrics.METRICS_OFF if telemetry is None else telemetry
        self.ledger = obs_ledger.Ledger(None) if ledger is None else ledger
        # Z as a device scalar: the MSE taps' true division (see _dl_den)
        self._z_t = torch.tensor(float(self.z), dtype=torch.float32, device=self.device)

    def unravel(self, flat: torch.Tensor) -> dict:
        return ops.unflatten_pytree(flat, self._meta)

    def _dyn(self) -> dict:
        """The scenario's continuous leaves (the JAX engine's dynamic jit
        arguments): what a checkpoint's ``dyn_hash`` fingerprints."""
        dyn = {"distances": self.channel.distances, "hetero": self._hetero, "eps": self._eps}
        if self._fv is not None:
            dyn["faults"] = self._fv
        return dyn

    # ------------------------------------------------------------ round body

    def _aggregate(self, idx, signs, theta, w_slot, q_slot):
        """Masked eq.-2 aggregation over S wire planes -> (Zpad,) fp32,
        one launch of the fused dequantize + weighted-sum kernel."""
        s = idx.shape[0]
        with _profile_scope("wire_aggregate"):
            out = sq.aggregate(
                idx.reshape(s, -1, LANES),
                signs.reshape(s, -1, LANES),
                theta,
                w_slot,
                torch.clamp(q_slot, min=1),
            )
        return out.reshape(-1)

    def _downlink_apply(self, u01: torch.Tensor, new_flat: torch.Tensor,
                        flat: torch.Tensor):
        """The quantized server->client broadcast of the aggregate, from (Z,)
        uniforms. Returns ``(bcast, dl_next)``: the model every client
        decodes (next round's start), and the realized bound term
        L/2 * Z theta_d^2 / (4 (2^q - 1)^2) that the next decision adds to
        its quant term. ``delta`` encodes aggregate - previous broadcast."""
        dl = self.downlink
        if dl.mode == "quant":
            bcast, theta_d = core_quant.quantize_array(u01, new_flat, dl.q_bits)
        else:
            deq, theta_d = core_quant.quantize_array(u01, new_flat - flat, dl.q_bits)
            bcast = flat + deq
        dl_next = self.sysp.lipschitz / 2.0 * self.z * theta_d**2 / self._dl_den
        return bcast, dl_next

    def _decide(self, rates, g_n, s_n, theta_max, lam1, lam2, ridx: int, dl_term=None,
                with_stats: bool = False):
        """The round's decision in this sim's ``policy_mode``. The
        heterogeneity multiplier and the downlink term reach greedy and the
        GA only; the baselines and SameSize are blind to both. In the GA
        modes ``with_stats`` returns ``(decision, GA taps)`` instead (see
        ``search.ga_decide``); the other modes ignore it."""
        sysp, z, mode = self.sysp, self.z, self.policy_mode
        d_sizes = self.fleet.n_samples.to(torch.float32)
        base = (rates, d_sizes, g_n, s_n, theta_max)
        if mode in ("compiled-ga", "same_size"):
            u, c = rates.shape
            with _profile_scope("draw_inputs"):
                draws = self.entropy.ga_draws(ridx, u, c, self.ga_config)
            if mode == "compiled-ga":
                return search.ga_decide(
                    draws, *base, lam1, lam2, sysp, z, self.v_weight,
                    cfg=self.ga_config, q_cap=self.q_cap, hetero=self._hetero,
                    dl_term=dl_term, with_stats=with_stats)
            return search.baseline_same_size(
                draws, *base, lam1, lam2, sysp, z, self.v_weight,
                cfg=self.ga_config, q_cap=self.q_cap, with_stats=with_stats)
        if mode == "no_quant":
            return fast_policy.baseline_no_quant(*base, sysp, z, self.q_cap)
        if mode == "channel_allocate":
            return fast_policy.baseline_channel_allocate(*base, sysp, z, self.q_cap)
        if mode == "principle":
            return fast_policy.baseline_principle(ridx, *base, sysp, z, self.q_cap)
        if mode != "greedy":
            raise ValueError(f"{mode!r} decides on the host; use run() or run_host_policy")
        return fast_policy.decide(*base, lam2, sysp, z, self.v_weight,
                                  q_cap=self.q_cap, hetero=self._hetero, dl_term=dl_term)

    def _exec_round(self, flat, slots, q_slot, wd_slot, ridx: int, with_eval: bool,
                    v_slot=None, f_slot=None, out_state=None):
        """The slot work of one round for a decision already compacted to
        the slot axis: gather -> tau-step SGD -> eq.-4 quantize -> one
        ``aggregate`` launch -> downlink -> eval. Shared by ``_round_body``
        and ``run_host_policy``, so a host policy that makes the compiled
        round's decisions replays it exactly.

        ``wd_slot`` holds the eq.-2 weights; with faults on it holds the
        slots' data sizes instead, and the weights renormalize here over the
        slots the screen passes, from ``v_slot``/``f_slot`` (assigned rate,
        CPU frequency) and ``out_state`` (last round's outages).

        Returns ``(new_flat, g_obs, s_obs, theta, acc, loss, extra)``, the
        observations per slot; ``extra`` holds, with faults on, the screen's
        verdict ``ok``, the new ``out_state`` and the fault counters, and
        with the downlink on, ``dl_next`` and ``dl_payload_bits``. With the
        ``quant_mse`` tap on it also holds ``quant_mse``, the realized wire
        error ||agg - sum_s w_s theta_s||^2 / Z (NaN when nothing was
        delivered), and with the downlink ``dl_mse``, the broadcast's error
        against the exact aggregate; the tap adds operations and changes
        none.
        """
        faults_on, dl_on = self.faults.enabled, self.downlink.enabled
        tap_mse = self.metrics_cfg.enabled and self.metrics_cfg.quant_mse
        x_s, y_s, n_s = gather_active(self.fleet, slots)
        with _profile_scope("draw_inputs"):
            batch_idx = self.entropy.batch_indices(ridx, n_s, self.sysp.tau, self.batch_size)
        stacked, g_obs, s_obs = fleet_local_sgd(
            self.loss_fn, self.sysp.tau, self.unravel(flat), x_s, y_s, batch_idx, self.lr,
        )
        s = slots.shape[0]
        flat_s = torch.cat([leaf.reshape(s, -1) for leaf in tree_util.leaves(stacked)],
                           dim=1)                          # (S, Z)
        with _profile_scope("draw_inputs"):
            u01 = self.entropy.uniforms(ridx, s, self._zpad)
        extra = {}
        if faults_on:
            with _profile_scope("draw_inputs"):
                draws = self.entropy.fault_draws(ridx, self.fleet.n_clients, s, self._zpad)
            down_u = draw_outage(draws.outage, out_state, self._fv)
            fade_hit_u, fade_mult_u = draw_fade(draws.fade, self._fv)
            flat_s = inject_burst(draws.burst, slots, flat_s, self._fv)
        if dl_on:
            with _profile_scope("draw_inputs"):
                u_dl = self.entropy.downlink_uniforms(ridx, self.z)
        idx, signs, theta = _quantize_wire(u01, flat_s, q_slot, self.q_cap, self._zpad)
        if faults_on:
            # corruption, then the screen: a failed slot's range AND weight
            # are zeroed (a NaN range with weight 0 would still poison the
            # kernel's coefficient) and eq. 2 renormalizes over the rest
            idx, signs = corrupt_planes(draws.hit, draws.site, draws.bits, idx, signs,
                                        self._fv)
            ok, n_dropped, n_timeout_real, n_screened = screen_slots(
                slots, q_slot, wd_slot, v_slot, f_slot, theta, idx, signs,
                down_u, fade_mult_u, fade_hit_u, self.sysp, self.z)
            d_eff = wd_slot * ok.to(torch.float32)
            d_n = torch.sum(d_eff)
            w_slot = d_eff / torch.clamp(d_n, min=1e-12)
            agg = self._aggregate(idx, signs, torch.where(ok, theta, torch.zeros_like(theta)),
                                  w_slot, q_slot)
            any_payload = d_n > 0
            new_flat = torch.where(any_payload, agg[: self.z], flat)
            extra.update(ok=ok, out_state=down_u.to(torch.float32), n_dropped=n_dropped,
                         n_timeout_real=n_timeout_real, n_screened=n_screened)
        else:
            w_slot = wd_slot
            agg = self._aggregate(idx, signs, theta, w_slot, q_slot)
            any_payload = torch.sum(w_slot) > 0
            new_flat = torch.where(any_payload, agg[: self.z], flat)
        if tap_mse:
            # against the unquantized eq.-2 aggregate of the delivered slots
            # (a screened slot's update may be NaN/Inf: zero it, weight 0)
            flat_ok = flat_s if not faults_on else torch.where(
                extra["ok"][:, None], flat_s, torch.zeros_like(flat_s))
            exact = torch.einsum("s,sz->z", w_slot, flat_ok)
            mse = torch.sum((agg[: self.z] - exact) ** 2) / self._z_t
            extra["quant_mse"] = torch.where(any_payload, mse, torch.full_like(mse, math.nan))
        if dl_on:
            # the carried model becomes what the clients decode
            exact_flat = new_flat
            new_flat, extra["dl_next"] = self._downlink_apply(u_dl, new_flat, flat)
            extra["dl_payload_bits"] = core_quant.payload_bits(self.z, self.downlink.q_bits)
            if tap_mse:
                extra["dl_mse"] = torch.sum((new_flat - exact_flat) ** 2) / self._z_t
        if with_eval:
            with _profile_scope("eval_model"):
                acc, loss = self.eval_fn(new_flat)
        else:
            acc = loss = torch.zeros((), dtype=torch.float32, device=self.device)
        return new_flat, g_obs, s_obs, theta, acc, loss, extra

    def _round_body(self, carry, ridx: int, with_eval: bool):
        flat, g_sq, sigma_sq, theta_max, lam1, lam2 = carry[:6]
        faults_on, dl_on = self.faults.enabled, self.downlink.enabled
        # carry slots after the six: last round's downlink term, then the
        # (U,) Markov outage state (1.0 = the client was down)
        dl_prev = carry[6] if dl_on else None
        out_state = carry[-1] if faults_on else None
        with _profile_scope("draw_inputs"):
            rates = self.entropy.rates(ridx, self.channel)
        with _profile_scope("round_state"):
            g_n = g_sq / torch.clamp(torch.mean(g_sq), min=1e-12)
            s_n = sigma_sq / torch.clamp(torch.mean(sigma_sq), min=1e-12)
        mcfg = self.metrics_cfg
        # the GA's fitness taps exist only when asked for
        tap_ga = (mcfg.enabled and mcfg.ga_fitness
                  and self.policy_mode in ("compiled-ga", "same_size"))
        dec = self._decide(rates, g_n, s_n, theta_max, lam1, lam2, ridx, dl_prev,
                           with_stats=tap_ga)
        ga_stats = None
        if tap_ga:
            dec, ga_stats = dec
        # ---- active-set compaction: everything below is on the S slots
        u = self.fleet.n_clients
        with _profile_scope("round_state"):
            slots = dec.slots                                  # (S,) ids, -1 pad
            sm = slots >= 0
            smf = sm.to(torch.float32)
            cid = torch.clamp(slots, min=0)
            q_slot = dec.q[cid] * sm.to(dec.q.dtype)
            d_sizes = self.fleet.n_samples.to(torch.float32)
            d_slot = d_sizes[cid] * smf
            if faults_on:
                v_slot, f_slot = dec.v_assigned[cid] * smf, dec.f[cid] * smf
            else:
                w_slot = d_slot / torch.clamp(torch.sum(d_slot), min=1e-12)   # eq. 2 weights
        if faults_on:
            new_flat, g_obs, s_obs, theta, acc, loss, extra = self._exec_round(
                flat, slots, q_slot, d_slot, ridx, with_eval,
                v_slot=v_slot, f_slot=f_slot, out_state=out_state)
        else:
            new_flat, g_obs, s_obs, theta, acc, loss, extra = self._exec_round(
                flat, slots, q_slot, w_slot, ridx, with_eval)
        with _profile_scope("round_state"):
            if faults_on:
                # only delivered slots feed the estimators, and the queues get
                # the realized terms: a failed client counts as unscheduled
                ok = extra["ok"]
                a_real = scatter_slots(slots, ok.to(torch.float32), u)
                qccf = self.policy_mode in _QCCF_MODES
                data_t, quant_t = fast_policy.realized_terms(
                    a_real, d_sizes, g_n, s_n, theta_max, dec.q, self.sysp, self.z,
                    hetero=self._hetero if qccf else None,
                    dl_term=dl_prev if qccf else None)
                zero = torch.zeros_like(g_obs)
                g_sq = ema_update(g_sq, scatter_slots(slots, torch.where(ok, g_obs, zero), u),
                                  a_real)
                sigma_sq = ema_update(sigma_sq,
                                      scatter_slots(slots, torch.where(ok, s_obs, zero), u),
                                      a_real, floor=1e-8)
                theta_max = torch.where(a_real > 0, scatter_slots(slots, theta, u), theta_max)
            else:
                data_t, quant_t = dec.data_term, dec.quant_term
                g_sq = ema_update(g_sq, scatter_slots(slots, g_obs, u), dec.a)
                sigma_sq = ema_update(sigma_sq, scatter_slots(slots, s_obs, u), dec.a,
                                      floor=1e-8)
                theta_max = torch.where(dec.a > 0, scatter_slots(slots, theta, u), theta_max)
            lam1 = torch.clamp(lam1 + data_t - self._eps[0], min=0.0)
            lam2 = torch.clamp(lam2 + quant_t - self._eps[1], min=0.0)
            out = {
                "energy": torch.sum(dec.energy),
                "accuracy": acc,
                "loss": loss,
                "n_scheduled": torch.sum(dec.a),
                "q_levels": dec.q,
                "latency": torch.amax(dec.latency),
                "payload_bits": dec.payload_bits,
                "rates": dec.v_assigned,
                "lambda1": lam1,
                "lambda2": lam2,
            }
            new_carry = (new_flat, g_sq, sigma_sq, theta_max, lam1, lam2)
            if dl_on:
                new_carry += (extra["dl_next"],)
            if faults_on:
                out.update({k: extra[k] for k in ("n_dropped", "n_timeout_real", "n_screened")})
                new_carry += (extra["out_state"],)
            if mcfg.enabled:
                out["metrics"] = self._round_metrics(dec, d_sizes, extra, ga_stats)
        return new_carry, out

    def _round_metrics(self, dec, d_sizes, extra: dict, ga_stats) -> obs_metrics.RoundMetrics:
        """The round's telemetry taps, on the device: the decision's
        (``obs.metrics.decision_metrics``) with the wire, GA, downlink and
        fault slots filled where those are on."""
        rm = obs_metrics.decision_metrics(
            dec.a, dec.q, dec.q_cont, dec.f, dec.energy, d_sizes,
            dec.data_term, dec.quant_term, self.sysp)
        fill = {}
        if "quant_mse" in extra:
            fill["quant_mse"] = extra["quant_mse"]
        if ga_stats is not None:
            fill.update(ga_stats)
        if self.downlink.enabled:
            # the broadcast's payload (eq.-5 format) and, tapped, its error
            fill["dl_payload_bits"] = self._dl_bits
            if "dl_mse" in extra:
                fill["dl_mse"] = extra["dl_mse"]
        if self.faults.enabled:
            fill.update({k: extra[k] for k in ("n_dropped", "n_screened", "n_timeout_real")})
        return dataclasses.replace(rm, **fill)

    # ---------------------------------------------------------------- runs

    def _rewind(self) -> None:
        """Put the entropy source back to its state when the sim was built,
        so a run is a pure function of the sim (``resume_compiled`` restores
        the checkpoint's state instead)."""
        if self._entropy0 is not None:
            self.entropy.set_state(self._entropy0)

    def _init_carry(self):
        u = self.fleet.n_clients
        ones = torch.ones((u,), dtype=torch.float32, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        carry = (self.flat0, ones, ones, ones, zero, zero)  # never updated in place
        if self.downlink.enabled:
            carry += (zero,)                                 # no broadcast yet
        if self.faults.enabled:
            carry += (torch.zeros((u,), dtype=torch.float32, device=self.device),)
        return carry

    def run_compiled(self, n_rounds: int, with_eval: bool = True,
                     segment: Optional[int] = None,
                     ckpt_dir: Optional[str] = None) -> SimResult:
        """Run ``n_rounds`` rounds as an eager loop on the device (the JAX
        engine's one-scan entry point, same name; every mode but
        ``host-ga``). ``final_flat`` holds the last model and
        ``run_seconds`` the wall time, results copied back.

        ``segment=k`` runs ceil(n/k) segments of k rounds, the same rounds
        on the same draws; with ``ckpt_dir`` the state after every interior
        segment is checkpointed there (``repro_torch.ckpt``), and
        :meth:`resume_compiled` finishes the run from the latest one."""
        if self.policy_mode == "host-ga":
            raise ValueError("host-ga decides on the host per round; use run() or "
                             "run_host_policy")
        if segment is None:
            if ckpt_dir is not None:
                raise ValueError("ckpt_dir requires segment=k (a segmented run)")
            segment = max(int(n_rounds), 1)
        elif segment < 1:
            raise ValueError(f"segment={segment} must be >= 1")
        self._rewind()
        return self._run_segments(n_rounds, with_eval, int(segment), ckpt_dir)

    def _run_segments(self, n_rounds: int, with_eval: bool, segment: int,
                      ckpt_dir: Optional[str], *, start: int = 0, carry=None,
                      parts: Optional[list] = None,
                      entry: str = "run_compiled") -> SimResult:
        """Rounds ``start`` to ``n_rounds`` in segments of ``segment``, each
        segment's per-round results copied to the host at its end; the
        carry threads through unchanged, so the trajectory is the
        unsegmented one. The ledger gets the run as ``entry``."""
        t0 = time.perf_counter()
        carry = self._init_carry() if carry is None else carry
        parts = [] if parts is None else list(parts)
        with torch.no_grad(), exact_fp32():
            for b in range(start, n_rounds, segment):
                e = min(b + segment, n_rounds)
                outs = []
                for n in range(b, e):
                    carry, out = self._round_body(carry, n, with_eval)
                    outs.append(out)
                parts.append(_stack_out(outs))
                if ckpt_dir is not None and e < n_rounds:
                    self._save_segment(ckpt_dir, e, n_rounds, segment, with_eval, carry,
                                       parts)
        self.final_flat = carry[0]
        self.run_seconds = time.perf_counter() - t0
        o = _concat_out(parts)
        f64 = np.float64
        res = SimResult(
            name=self.name,
            energy=o["energy"].astype(f64), accuracy=o["accuracy"].astype(f64),
            loss=o["loss"].astype(f64), n_scheduled=o["n_scheduled"],
            q_levels=o["q_levels"], latency=o["latency"].astype(f64),
            payload_bits=o["payload_bits"].astype(f64),
            rates=o["rates"].astype(f64), lambda1=o["lambda1"].astype(f64),
            lambda2=o["lambda2"].astype(f64),
            metrics=dict(o["metrics"]) if "metrics" in o else None,
        )
        self._write_run_ledger(entry, n_rounds, res, self.run_seconds)
        return res

    def _save_segment(self, ckpt_dir: str, next_round: int, n_rounds: int, segment: int,
                      with_eval: bool, carry, parts: list) -> None:
        """Checkpoint the carry, the rounds so far and the entropy source's
        generator state: a sequential generator is part of the state, where
        the JAX engine's draws are a pure function of the round key."""
        tree = {
            "carry": {f"c{i:02d}": leaf for i, leaf in enumerate(carry)},
            "out": _concat_out(parts),
        }
        if hasattr(self.entropy, "get_state"):
            tree["entropy"] = self.entropy.get_state()
        ckpt.save_checkpoint(ckpt_dir, next_round, tree, extra={
            "kind": _SEGMENT_KIND, "next_round": int(next_round),
            "n_rounds": int(n_rounds), "segment": int(segment),
            "with_eval": bool(with_eval), "seed": self.seed,
            "dyn_hash": tree_util.pytree_hash(self._dyn()),
            "sim_name": self.name, "device_type": self.device.type,
        })
        self.ledger.write("resume", step=int(next_round), action="save", dir=str(ckpt_dir))

    def resume_compiled(self, ckpt_dir: str) -> SimResult:
        """Finish a segmented :meth:`run_compiled` from its latest checkpoint:
        checks the checkpoint against this sim (kind, seed, the scenario's
        leaves, carry arity, device type), restores the carry, the rounds
        already run and the entropy source's generator state, and runs the
        remaining segments: the result equals the unsegmented run's."""
        tree, meta = ckpt.load_checkpoint(ckpt_dir)
        if meta.get("kind") != _SEGMENT_KIND:
            raise ckpt.CheckpointError(
                f"{ckpt_dir!r} holds a {meta.get('kind') or 'non-sim'} checkpoint, "
                "not a segmented-run one")
        if int(meta["seed"]) != self.seed:
            raise ckpt.CheckpointError(f"checkpoint seed {meta['seed']} != sim seed {self.seed}")
        dyn_hash = tree_util.pytree_hash(self._dyn())
        if meta.get("dyn_hash") != dyn_hash:
            raise ckpt.CheckpointError(
                "checkpoint was taken under different scenario leaves "
                f"(hash {meta.get('dyn_hash')} != {dyn_hash})")
        if meta.get("device_type") != self.device.type:
            raise ckpt.CheckpointError(
                f"checkpoint was taken on {meta.get('device_type')}, this sim runs on "
                f"{self.device.type}: a generator state resumes on its own device type")
        carry_d = tree["carry"]
        carry = tuple(torch.as_tensor(carry_d[k], device=self.device) for k in sorted(carry_d))
        n_ref = len(self._init_carry())
        if len(carry) != n_ref:
            raise ckpt.CheckpointError(
                f"carry has {len(carry)} slots, this sim needs {n_ref} "
                "(the downlink/faults gates must match the checkpointing sim)")
        stateful = hasattr(self.entropy, "set_state")
        if ("entropy" in tree) != stateful:
            raise ckpt.CheckpointError(
                "the checkpoint's entropy state does not fit this sim's entropy source "
                f"(saved: {'entropy' in tree}, this source keeps state: {stateful})")
        if ("metrics" in tree["out"]) != self.metrics_cfg.enabled:
            raise ckpt.CheckpointError(
                "the checkpoint's rounds were run with telemetry "
                f"{'on' if 'metrics' in tree['out'] else 'off'}, this sim has it "
                f"{'on' if self.metrics_cfg.enabled else 'off'}")
        if stateful:
            self.entropy.set_state(tree["entropy"])
        self.ledger.write("resume", step=int(meta["next_round"]), action="load",
                          dir=str(ckpt_dir))
        return self._run_segments(
            int(meta["n_rounds"]), bool(meta["with_eval"]), int(meta["segment"]), ckpt_dir,
            start=int(meta["next_round"]), carry=carry, parts=[tree["out"]],
            entry="resume_compiled")

    # -------------------------------------------------------------- sharding

    def shard_clients(self, mesh, axis: str = "data") -> None:
        """Distribute the client axis over the ``DeviceMesh`` axis ``axis``
        through the logical-axis plan (``make_plan(mesh, client_axis=axis)``,
        ``data_specs(..., leading="clients")``): when U divides the axis,
        this rank keeps only its clients' rows of ``fleet.x`` and
        ``fleet.y``; otherwise the spec replicates and the fleet stays
        whole, as the JAX package's divisibility rule does. ``n_samples``
        stays whole (the decision reads all U sizes).

        The round stays replicated: every rank of the mesh runs the same
        rounds on the same draws, and the slots' rows are assembled by a
        collective (``fleet.gather_active``), so a sharded run is bit-equal
        to the unsharded one on the same device type. Every rank must run
        the same calls; a segmented run checkpoints on each rank into the
        directory that rank is given (a checkpoint holds no fleet rows).
        The port keeps no compiled state to clear."""
        from repro_torch.dist.plan import make_plan, mesh_coord
        from repro_torch.dist.sharding import data_specs, shard_tree

        fleet = self.fleet
        if fleet.group is not None:
            raise ValueError("shard_clients: this sim's fleet is sharded already")
        plan = make_plan(mesh, client_axis=axis)
        rows = {"x": fleet.x, "y": fleet.y}
        specs = data_specs(plan, rows, leading="clients")
        ent = specs["x"][0]
        if ent is None:
            return                    # U does not divide the axis: replicated
        coord = mesh_coord(mesh)
        mine = shard_tree(plan, rows, specs, coord)
        self.fleet = dataclasses.replace(
            fleet, x=mine["x"].clone(), y=mine["y"].clone(),
            client_offset=plan.local_slice(specs["x"], fleet.x.shape, coord)[0].start,
            group=mesh.get_group(ent))

    # ------------------------------------------------------------- ledger

    def _ledger_header(self, entry: str, n_rounds: int) -> None:
        """One run header per run: scenario fingerprint, fleet shape,
        policy, telemetry gate (the ledger stamps the git rev and the torch
        version)."""
        self.ledger.run_header(
            self.name, entry,
            scenario_hash=tree_util.pytree_hash(self._dyn()),
            policy=self.policy_mode,
            u=int(self.fleet.n_clients),
            c=int(self.channel.params.n_channels),
            z=int(self.z), rounds=int(n_rounds), seed=self.seed,
            telemetry=self.metrics_cfg.enabled,
            downlink=self.downlink.mode,
        )

    @staticmethod
    def _ledger_row(res: SimResult, n: int) -> dict:
        """Round n of a SimResult -> a ledger round row (the RoundRecord
        columns plus the telemetry taps when present)."""
        row = dict(
            energy=float(res.energy[n]), accuracy=float(res.accuracy[n]),
            loss=float(res.loss[n]), n_scheduled=int(res.n_scheduled[n]),
            latency=float(res.latency[n]),
            payload_bits=float(res.payload_bits[n]),
            lambda1=float(res.lambda1[n]), lambda2=float(res.lambda2[n]),
        )
        if res.metrics is not None:
            row.update({k: float(v[n]) for k, v in res.metrics.items()})
        return row

    def _write_run_ledger(self, entry: str, n_rounds: int, res: SimResult,
                          run_s: float) -> None:
        if not self.ledger.enabled:
            return
        self._ledger_header(entry, n_rounds)
        for n in range(n_rounds):
            self.ledger.round_row(n, **self._ledger_row(res, n))
        self.ledger.timing("run", run_s, entry=entry, rounds=int(n_rounds))

    # ------------------------------------------------- host policies

    def make_host_ga_policy(self) -> search.HostGAPolicy:
        """The host GA controller paired to this sim's constants and
        ``ga_config``: the oracle that replays a ``compiled-ga`` run."""
        return search.HostGAPolicy(
            self.sysp, self.eps1, self.eps2, self.v_weight,
            cfg=self.ga_config, q_cap=self.q_cap, hetero=self.hetero,
        )

    def make_host_policy(self):
        """The host Policy mirroring this sim's mode on the shared draws: the
        oracle ``run_host_policy`` replays against ``run_compiled``."""
        mode = self.policy_mode
        if mode == "greedy":
            return fast_policy.HostFastPolicy(
                self.sysp, self.eps1, self.eps2, self.v_weight,
                q_cap=self.q_cap, hetero=self.hetero,
            )
        if mode in ("compiled-ga", "host-ga"):
            return self.make_host_ga_policy()
        if mode == "no_quant":
            return fl_baselines.NoQuantPolicy(self.sysp)
        if mode == "channel_allocate":
            return fl_baselines.ChannelAllocatePolicy(self.sysp)
        if mode == "principle":
            return fl_baselines.PrinciplePolicy(self.sysp)
        assert mode == "same_size", mode
        return fl_baselines.SameSizePolicy(self.make_host_ga_policy())

    def run(self, n_rounds: int, with_eval: bool = True) -> ExperimentResult:
        """Mode dispatch: ``run_compiled`` for every device mode, the host
        GA controller through ``run_host_policy`` for ``host-ga``. Always
        returns an ``ExperimentResult``."""
        if self.policy_mode == "host-ga":
            return self.run_host_policy(self.make_host_ga_policy(), n_rounds,
                                        channel="sim", with_eval=with_eval)
        return self.run_compiled(n_rounds, with_eval=with_eval).to_result()

    def run_host_policy(self, policy, n_rounds: int, channel: str = "sim",
                        with_eval: bool = True) -> ExperimentResult:
        """Per-round host decisions: ``policy`` (a ``repro_torch.fl`` Policy,
        e.g. ``make_host_policy()``) decides in numpy; the slot work runs
        through ``_exec_round`` on the device, as in ``run_compiled``.

        ``channel="sim"`` takes the rates from the entropy source, the same
        numbers ``run_compiled`` sees, so a host policy that mirrors the
        compiled one reproduces it decision for decision. ``channel="host"``
        takes them from the numpy ``ChannelModel`` stream instead (what an
        object-based experiment would see); the sim's rates are drawn all
        the same and dropped, so the batch and quantizer draws stay those
        of ``run_compiled``. The GA's draws go to a policy that takes them
        (``set_round_draws``), in the compiled round's order, and with the
        downlink on last round's broadcast term to one that takes it
        (``set_downlink_term``). Under faults the screen's verdicts replay
        the compiled round's: only delivered slots update the estimators,
        and the policy commits the terms at the realized participation.

        Decisions above ``q_cap`` are clamped to it for execution and in the
        records: the index planes are sized for ``q_cap`` levels (build with
        ``q_cap=16`` for baselines that quantize up to 16 bits).

        With telemetry on, ``last_host_metrics`` holds one dict of taps per
        round, in the compiled run's schema (``obs.metrics.decision_metrics_host``
        on the host decision, on the sim's device; the wire, downlink and
        fault taps from ``_exec_round``); the host GA records no
        ``ga_median``. With a ledger, the run is written to it as
        ``run_host_policy``.
        """
        if channel not in ("sim", "host"):
            raise ValueError(f"channel must be sim or host, got {channel!r}")
        if channel == "host" and self.host_channel is None:
            raise ValueError('channel="host" needs the sim built with a host ChannelModel')
        u = self.fleet.n_clients
        c = self.channel.params.n_channels
        dev = self.device
        faults_on, dl_on = self.faults.enabled, self.downlink.enabled
        mcfg = self.metrics_cfg
        qccf = self.policy_mode in _QCCF_MODES
        consts = self.sysp.bound_constants()
        d_sizes = self.fleet.d_sizes.astype(np.float64)
        g_sq, sigma_sq, theta_max = np.ones(u), np.ones(u), np.ones(u)
        flat = self.flat0
        # the compiled round's carry slots: last broadcast's term, outages
        dl_prev = 0.0
        out_state = torch.zeros((u,), dtype=torch.float32, device=dev) if faults_on else None
        records: list[RoundRecord] = []
        # per-round taps of this replay (the compiled run's schema)
        host_metrics: list[dict] = []
        cum = 0.0
        self._rewind()
        t0 = time.perf_counter()
        with torch.no_grad(), exact_fp32():
            for n in range(n_rounds):
                sim_rates = self.entropy.rates(n, self.channel)
                if channel == "sim":
                    rates = sim_rates.cpu().numpy().astype(np.float64)
                else:
                    rates = self.host_channel.draw_rates()
                ctx = RoundContext(
                    rates=rates, d_sizes=d_sizes,
                    g_sq=g_sq / max(float(np.mean(g_sq)), 1e-12),
                    sigma_sq=sigma_sq / max(float(np.mean(sigma_sq)), 1e-12),
                    theta_max=theta_max.copy(), z=self.z,
                )
                if hasattr(policy, "set_round_draws"):
                    policy.set_round_draws(self.entropy.ga_draws(n, u, c, self.ga_config))
                if dl_on and hasattr(policy, "set_downlink_term"):
                    policy.set_downlink_term(dl_prev)
                dec = policy.decide(ctx)
                # the continuous-q tap: KKT policies attach the clipped q_hat,
                # the baselines fall back to their level before the clamp
                q_cont_host = getattr(dec, "q_cont", np.asarray(dec.q, np.float64).copy())
                # clamp into the wire format: an index plane sized for q_cap
                # would wrap above it
                q_exec = np.clip(dec.q, 1, self.q_cap) * dec.a
                dec.q = np.where(dec.a > 0, q_exec, dec.q * 0)
                # the compiled round's slot derivation: drop unkept channels,
                # stable channel-order slots
                assign = np.asarray(dec.assign)
                a_np = np.asarray(dec.a)
                assign_kept = np.where((assign >= 0) & (a_np[np.clip(assign, 0, u - 1)] > 0),
                                       assign, -1)
                slots = fast_policy.compact_slots_host(assign_kept, u)
                mask = slots >= 0
                cids = np.maximum(slots, 0)
                # the replay trains exactly the slot set: a decision whose
                # participation disagrees with its channels would train the
                # wrong clients, so it fails here
                sched_from_slots = np.sort(cids[mask])
                sched_from_a = np.flatnonzero(a_np > 0)
                if not np.array_equal(sched_from_slots, sched_from_a):
                    raise ValueError(
                        f"policy decision inconsistent: participation a="
                        f"{sched_from_a.tolist()} vs channel-assigned clients "
                        f"{sched_from_slots.tolist()}: every scheduled client must hold "
                        "exactly one channel")
                # eq.-2 weights in fp32, the compiled round's own arithmetic
                # (integer sizes sum exactly in fp32)
                d_slot = np.where(mask, d_sizes[cids], 0.0).astype(np.float32)
                w_slot = d_slot / np.maximum(d_slot.sum(dtype=np.float32), np.float32(1e-12))
                q_slot = np.where(mask, q_exec[cids], 0)
                v_assigned = np.zeros(u)
                for ch, cid in enumerate(assign):
                    if cid >= 0:
                        v_assigned[cid] += float(ctx.rates[cid, ch])
                fault_kw = {}
                if faults_on:
                    # the screen's inputs, compacted as the compiled round's:
                    # fp32 casts of the host decision's rate and frequency
                    fault_kw = dict(
                        v_slot=torch.as_tensor(np.where(mask, v_assigned[cids], 0.0),
                                               dtype=torch.float32, device=dev),
                        f_slot=torch.as_tensor(np.where(mask, np.asarray(dec.f)[cids], 0.0),
                                               dtype=torch.float32, device=dev),
                        out_state=out_state)
                flat, g_obs, s_obs, theta, acc, loss, extra = self._exec_round(
                    flat, torch.as_tensor(slots, device=dev),
                    torch.as_tensor(q_slot.astype(np.int64), device=dev),
                    torch.as_tensor(d_slot if faults_on else w_slot, device=dev), n,
                    with_eval, **fault_kw)
                g_obs, s_obs, theta = (t.cpu().numpy() for t in (g_obs, s_obs, theta))
                # only delivered slots feed the estimators (every scheduled
                # slot when faults are off)
                upd = mask
                if faults_on:
                    upd = mask & extra["ok"].cpu().numpy()
                    out_state = extra["out_state"]
                sel = cids[upd]
                g_sq[sel] = 0.7 * g_sq[sel] + 0.3 * g_obs[upd]
                sigma_sq[sel] = 0.7 * sigma_sq[sel] + 0.3 * np.maximum(s_obs[upd], 1e-8)
                theta_max[sel] = theta[upd]
                planned_dt, planned_qt = float(dec.data_term), float(dec.quant_term)
                if faults_on:
                    # the queues take the terms at the realized participation
                    a_real = np.zeros(u)
                    a_real[sel] = 1.0
                    dec.data_term, dec.quant_term = bounds.realized_terms(
                        consts, a_real, d_sizes, ctx.g_sq, ctx.sigma_sq, ctx.theta_max,
                        np.maximum(np.asarray(dec.q), 1), self.z,
                        hetero=self.hetero if qccf else None,
                        dl_term=dl_prev if (dl_on and qccf) else 0.0)
                policy.commit(dec)
                cum += dec.total_energy
                records.append(RoundRecord(
                    round=n, energy=dec.total_energy, cum_energy=cum,
                    accuracy=float(acc), loss=float(loss),
                    n_scheduled=int(dec.a.sum()), q_levels=dec.q.copy(),
                    latency=float(dec.latency.max() if dec.a.any() else 0.0),
                    payload_bits=float(np.sum(np.where(
                        dec.a > 0, self.z * np.maximum(dec.q, 1) + self.z + 32.0, 0.0))),
                    rates=v_assigned,
                ))
                if mcfg.enabled:
                    host_metrics.append(self._host_metrics(
                        a_np, dec, q_cont_host, d_sizes, planned_dt, planned_qt, extra))
                if dl_on:
                    dl_prev = float(extra["dl_next"])
        self.final_flat = flat
        self.run_seconds = time.perf_counter() - t0
        self.last_host_metrics = host_metrics if mcfg.enabled else None
        result = ExperimentResult(getattr(policy, "name", "host_policy"), records)
        if self.ledger.enabled:
            self._ledger_header("run_host_policy", n_rounds)
            for n, rec in enumerate(records):
                row = dict(energy=rec.energy, accuracy=rec.accuracy, loss=rec.loss,
                           n_scheduled=rec.n_scheduled, latency=rec.latency,
                           payload_bits=rec.payload_bits)
                if mcfg.enabled:
                    row.update(host_metrics[n])
                self.ledger.round_row(n, **row)
            self.ledger.timing("run", self.run_seconds, entry="run_host_policy",
                               rounds=int(n_rounds))
        return result

    def _host_metrics(self, a_np, dec, q_cont, d_sizes, data_term: float, quant_term: float,
                      extra: dict) -> dict:
        """One host round's taps, the compiled round's fields: the decision's
        through ``decision_metrics_host`` (planned drift terms, as the
        compiled tap takes them), the wire, downlink and fault taps of
        ``_exec_round``, and the host GA's best J0 where it has one."""
        def tap(name):
            return float(extra[name]) if name in extra else None

        return obs_metrics.decision_metrics_host(
            a_np, np.asarray(dec.q), np.asarray(q_cont), np.asarray(dec.f),
            np.asarray(dec.energy), d_sizes, data_term, quant_term, self.sysp,
            quant_mse=tap("quant_mse"), ga_best=getattr(dec, "ga_best", None),
            dl_payload_bits=tap("dl_payload_bits"), dl_mse=tap("dl_mse"),
            n_dropped=tap("n_dropped"), n_screened=tap("n_screened"),
            n_timeout_real=tap("n_timeout_real"), device=self.device)


# ------------------------------------------------------------------- build

def drop_and_calibrate(ch_params: ChannelParams, topology, seed: int, entropy, device,
                       sizes: np.ndarray, z: int, sysp: SystemParams, target_q: float):
    """The client drop and the eps1/eps2 calibration of :func:`build_sim`:
    ``(channel, host_channel, eps1, eps2)``. No topology, or a single-BS
    one, drops and probes through the numpy ``ChannelModel`` (seeded with
    ``seed``, the legacy path); a cell-free topology drops and probes
    through ``entropy``'s set-up draws and has no host channel."""
    if topology is None or topology.mode == "single_bs":
        host_channel = ChannelModel(ch_params, seed=seed)
        channel = SimChannel.from_host_model(host_channel, device)
        if topology is not None:
            channel = dataclasses.replace(channel, association=topology.association)
        probe_rates = host_channel.draw_rates()
    else:
        host_channel = None
        channel = SimChannel.from_topology(*entropy.drop_uniforms(ch_params.n_clients),
                                           ch_params, topology)
        probe_rates = draw_rates(*entropy.probe_normals(channel.shape), ch_params,
                                 channel.distances, channel.association)
        probe_rates = probe_rates.cpu().numpy().astype(np.float64)
    u = ch_params.n_clients
    probe = RoundContext(
        rates=probe_rates, d_sizes=np.asarray(sizes, np.float64),
        g_sq=np.full(u, 1.0), sigma_sq=np.full(u, 1.0), theta_max=np.full(u, 1.0), z=z,
    )
    eps1, eps2 = auto_epsilons(probe, sysp, target_q=target_q)
    return channel, host_channel, eps1, eps2


def build_sim(
    task: str = "tiny",
    *,
    scenario=None,
    n_clients: int = 64,
    n_channels: Optional[int] = None,
    mu: Optional[float] = None,
    beta: Optional[float] = None,
    v_weight: Optional[float] = None,
    alpha_dirichlet: Optional[float] = None,
    lr: float = 0.05,
    seed: int = 0,
    batch_size: int = 32,
    q_cap: int = 8,
    n_test: int = 1024,
    target_q: Optional[float] = None,
    policy_mode: Optional[str] = None,
    ga_config=None,
    hetero_weight: Optional[float] = None,
    name: Optional[str] = None,
    telemetry: Optional[MetricsConfig] = None,
    ledger: Optional[obs_ledger.Ledger] = None,
    downlink=None,
    faults: Optional[FaultSpec] = None,
    init_params: Optional[dict] = None,
    device=None,
    entropy: Any = None,
) -> FleetSim:
    """Mirror of ``repro.sim.engine.build_sim`` on ``device`` (``cuda``
    unless the caller passes another; raises without CUDA), every
    ``policy_mode`` (``greedy``/``qccf``, ``compiled-ga``/``qccf_ga``,
    ``host-ga``, ``no_quant``, ``channel_allocate``, ``principle``,
    ``same_size``).

    ``scenario`` is a :class:`repro_torch.sim.scenario.Scenario` or a preset
    name (sized by ``n_clients``/``n_channels``); explicit kwargs override
    its fields. ``scenario=None`` and single-BS topologies keep the numpy
    ``ChannelModel`` client drop and eps probe (``scenario="single_bs"``
    is ``scenario=None`` bit for bit); cell-free topologies drop and probe
    through the entropy source's set-up draws. ``downlink`` is a
    :class:`DownlinkConfig` or its mode (``"off"``, ``"quant"``,
    ``"delta"``); ``faults`` a :class:`FaultSpec` (default: the scenario's).

    ``telemetry`` (a :class:`~repro_torch.obs.MetricsConfig`) turns the
    per-round taps on, and ``ledger`` (a :class:`~repro_torch.obs.Ledger`)
    takes every run's header, rows and timing.

    ``init_params`` (a parameter tree of ``repro_torch.models.cnn``, e.g.
    from ``params_from_numpy`` of the JAX package's weights) replaces the
    port's own seeded init; ``entropy`` replaces the default
    :class:`~repro_torch.sim.entropy.DeviceEntropy`.
    """
    dev = resolve_device(device)
    n_channels = n_clients if n_channels is None else n_channels
    if isinstance(scenario, str):
        scenario = get_scenario(scenario, n_clients=n_clients, n_channels=n_channels)
    if scenario is not None:
        n_clients = scenario.channel.n_clients
        n_channels = scenario.channel.n_channels
        mu = scenario.data.mu if mu is None else mu
        beta = scenario.data.beta if beta is None else beta
        if alpha_dirichlet is None:
            alpha_dirichlet = scenario.data.alpha_dirichlet
        v_weight = scenario.lyapunov.v_weight if v_weight is None else v_weight
        target_q = scenario.lyapunov.target_q if target_q is None else target_q
        policy_mode = scenario.policy if policy_mode is None else policy_mode
        if hetero_weight is None:
            hetero_weight = scenario.lyapunov.hetero_weight
        if faults is None:
            faults = scenario.faults
    v_weight = 100.0 if v_weight is None else float(v_weight)
    alpha_dirichlet = 0.5 if alpha_dirichlet is None else float(alpha_dirichlet)
    target_q = 6.0 if target_q is None else float(target_q)
    hetero_weight = 0.0 if hetero_weight is None else float(hetero_weight)
    policy_mode = "greedy" if policy_mode is None else policy_mode
    if isinstance(downlink, str):
        downlink = DownlinkConfig(mode=downlink)
    entropy = DeviceEntropy(seed, dev) if entropy is None else entropy

    task_spec, cnn_cfg, sysp = TASKS[task]
    mu, beta = task_data_sizes(task, mu, beta)
    img_task = SyntheticImageTask(task_spec, seed=seed)
    sizes = gaussian_sizes(n_clients, mu, beta, seed=seed)
    datasets = make_federated_datasets(img_task, n_clients, sizes,
                                       alpha=alpha_dirichlet, seed=seed)
    fleet = build_fleet(datasets, dev)
    test = make_test_set(img_task, n=n_test, seed=seed + 999)
    test_x = torch.from_numpy(test["x"]).to(dev)
    test_y = torch.from_numpy(test["y"].astype(np.int64)).to(dev)

    if init_params is None:
        params = cnn.init_params(cnn_cfg, seed, device=dev)
    else:
        params = {k: {n: t.to(device=dev, dtype=torch.float32) for n, t in v.items()}
                  for k, v in init_params.items()}
    loss_fn = functools.partial(cnn.loss_fn, cnn_cfg)
    _flat0, meta = ops.flatten_pytree(params)

    def eval_fn(flat):
        return cnn.eval_metrics(cnn_cfg, ops.unflatten_pytree(flat, meta),
                                test_x, test_y)

    ch_params = (scenario.channel if scenario is not None
                 else ChannelParams(n_clients=n_clients, n_channels=n_channels))
    channel, host_channel, eps1, eps2 = drop_and_calibrate(
        ch_params, None if scenario is None else scenario.topology, seed, entropy, dev,
        sizes, int(_flat0.shape[0]), sysp, target_q)

    hetero = None
    if hetero_weight > 0.0:
        hetero = 1.0 + hetero_weight * hetero_kl(datasets, task_spec.n_classes)

    if name is None:
        name = f"sim_{scenario.name}_{policy_mode}" if scenario is not None else "sim_qccf"
    return FleetSim(
        fleet, params, loss_fn, eval_fn, channel, sysp,
        eps1=eps1, eps2=eps2, v_weight=v_weight, lr=lr,
        batch_size=batch_size, q_cap=q_cap, seed=seed,
        hetero=hetero, name=name, entropy=entropy,
        host_channel=host_channel, policy_mode=policy_mode, ga_config=ga_config,
        downlink=downlink, faults=faults, telemetry=telemetry, ledger=ledger,
    )
