"""The fleet simulator's round on the device (the port of ``repro.sim.engine``).

``build_sim`` mirrors the JAX package's setup for the legacy single-BS
path (same synthetic datasets, same client drop, same eps1/eps2
calibration for a given seed); ``FleetSim.run_compiled`` then runs the
rounds as an eager loop on the device. One round:

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
  aggregate  — fused dequantize + eq.-2 weighted sum through the CUDA
               ``aggregate`` kernel (``repro_torch.kernels``), one launch
  scatter    — masked EMA updates of the (U,) G²/σ²/θ estimators
  queues     — Lyapunov lambda1/lambda2 updates

``run_host_policy`` lets a host Policy (the numpy oracles of each mode,
``make_host_policy``) make the decisions while the slot work runs through
the same ``_exec_round`` as the compiled round. The round's random draws
come from an entropy source (``repro_torch.sim.entropy``), in one order
for both runs. The downlink, faults, telemetry, scenarios and segmented
runs of the JAX engine are not ported yet; asking for one raises
``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.controller import auto_epsilons
from repro_torch.core.genetic import GAConfig, RoundContext, SystemParams
from repro_torch.data.synthetic import (
    SyntheticImageTask, gaussian_sizes, hetero_kl, make_federated_datasets,
    make_test_set,
)
from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.fl import baselines as fl_baselines
from repro_torch.fl.experiment import TASKS, task_data_sizes
from repro_torch.fl.trainer import ExperimentResult, RoundRecord
from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quant as sq
from repro_torch.models import cnn
from repro_torch.sim import policy as fast_policy
from repro_torch.sim import search
from repro_torch.sim.channel import SimChannel
from repro_torch.sim.entropy import DeviceEntropy
from repro_torch.sim.fleet import (
    Fleet, build_fleet, ema_update, fleet_local_sgd, gather_active,
    scatter_slots,
)
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch.sim: {what} is not ported yet (ROADMAP.md Queue 1, {item})"
    )


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
    ) -> None:
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

    def unravel(self, flat: torch.Tensor) -> dict:
        return ops.unflatten_pytree(flat, self._meta)

    # ------------------------------------------------------------ round body

    def _aggregate(self, idx, signs, theta, w_slot, q_slot):
        """Masked eq.-2 aggregation over S wire planes -> (Zpad,) fp32,
        one launch of the fused dequantize + weighted-sum kernel."""
        s = idx.shape[0]
        out = sq.aggregate(
            idx.reshape(s, -1, LANES),
            signs.reshape(s, -1, LANES),
            theta,
            w_slot,
            torch.clamp(q_slot, min=1),
        )
        return out.reshape(-1)

    def _decide(self, rates, g_n, s_n, theta_max, lam1, lam2, ridx: int):
        """The round's decision in this sim's ``policy_mode``. The
        heterogeneity multiplier reaches greedy and the GA only; the
        baselines and SameSize are heterogeneity-blind."""
        sysp, z, mode = self.sysp, self.z, self.policy_mode
        d_sizes = self.fleet.n_samples.to(torch.float32)
        base = (rates, d_sizes, g_n, s_n, theta_max)
        if mode in ("compiled-ga", "same_size"):
            u, c = rates.shape
            draws = self.entropy.ga_draws(ridx, u, c, self.ga_config)
            if mode == "compiled-ga":
                return search.ga_decide(
                    draws, *base, lam1, lam2, sysp, z, self.v_weight,
                    cfg=self.ga_config, q_cap=self.q_cap, hetero=self._hetero)
            return search.baseline_same_size(
                draws, *base, lam1, lam2, sysp, z, self.v_weight,
                cfg=self.ga_config, q_cap=self.q_cap)
        if mode == "no_quant":
            return fast_policy.baseline_no_quant(*base, sysp, z, self.q_cap)
        if mode == "channel_allocate":
            return fast_policy.baseline_channel_allocate(*base, sysp, z, self.q_cap)
        if mode == "principle":
            return fast_policy.baseline_principle(ridx, *base, sysp, z, self.q_cap)
        if mode != "greedy":
            raise ValueError(f"{mode!r} decides on the host; use run() or run_host_policy")
        return fast_policy.decide(*base, lam2, sysp, z, self.v_weight,
                                  q_cap=self.q_cap, hetero=self._hetero)

    def _exec_round(self, flat, slots, q_slot, w_slot, ridx: int, with_eval: bool):
        """The slot work of one round for a decision already compacted to
        the slot axis: gather -> tau-step SGD -> eq.-4 quantize -> one
        ``aggregate`` launch -> eval. Shared by ``_round_body`` and
        ``run_host_policy``, so a host policy that makes the compiled
        round's decisions replays it exactly. Returns ``(new_flat, g_obs,
        s_obs, theta, acc, loss)``, the observations per slot."""
        x_s, y_s, n_s = gather_active(self.fleet, slots)
        batch_idx = self.entropy.batch_indices(ridx, n_s, self.sysp.tau, self.batch_size)
        stacked, g_obs, s_obs = fleet_local_sgd(
            self.loss_fn, self.sysp.tau, self.unravel(flat), x_s, y_s, batch_idx, self.lr,
        )
        s = slots.shape[0]
        flat_s = torch.cat([leaf.reshape(s, -1) for leaf in tree_util.leaves(stacked)],
                           dim=1)                          # (S, Z)
        u01 = self.entropy.uniforms(ridx, s, self._zpad)
        idx, signs, theta = _quantize_wire(u01, flat_s, q_slot, self.q_cap, self._zpad)
        agg = self._aggregate(idx, signs, theta, w_slot, q_slot)
        new_flat = torch.where(torch.sum(w_slot) > 0, agg[: self.z], flat)
        if with_eval:
            acc, loss = self.eval_fn(new_flat)
        else:
            acc = loss = torch.zeros((), dtype=torch.float32, device=self.device)
        return new_flat, g_obs, s_obs, theta, acc, loss

    def _round_body(self, carry, ridx: int, with_eval: bool):
        flat, g_sq, sigma_sq, theta_max, lam1, lam2 = carry
        rates = self.entropy.rates(ridx, self.channel)
        g_n = g_sq / torch.clamp(torch.mean(g_sq), min=1e-12)
        s_n = sigma_sq / torch.clamp(torch.mean(sigma_sq), min=1e-12)
        dec = self._decide(rates, g_n, s_n, theta_max, lam1, lam2, ridx)
        # ---- active-set compaction: everything below is on the S slots
        u = self.fleet.n_clients
        slots = dec.slots                                  # (S,) ids, -1 pad
        sm = slots >= 0
        cid = torch.clamp(slots, min=0)
        q_slot = dec.q[cid] * sm.to(dec.q.dtype)
        d_slot = self.fleet.n_samples.to(torch.float32)[cid] * sm.to(torch.float32)
        w_slot = d_slot / torch.clamp(torch.sum(d_slot), min=1e-12)   # eq. 2 weights
        new_flat, g_obs, s_obs, theta, acc, loss = self._exec_round(
            flat, slots, q_slot, w_slot, ridx, with_eval)

        g_sq = ema_update(g_sq, scatter_slots(slots, g_obs, u), dec.a)
        sigma_sq = ema_update(sigma_sq, scatter_slots(slots, s_obs, u), dec.a, floor=1e-8)
        theta_max = torch.where(dec.a > 0, scatter_slots(slots, theta, u), theta_max)
        lam1 = torch.clamp(lam1 + dec.data_term - self._eps[0], min=0.0)
        lam2 = torch.clamp(lam2 + dec.quant_term - self._eps[1], min=0.0)
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
        return (new_flat, g_sq, sigma_sq, theta_max, lam1, lam2), out

    # ---------------------------------------------------------------- runs

    def _init_carry(self):
        u = self.fleet.n_clients
        ones = torch.ones((u,), dtype=torch.float32, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return (self.flat0, ones, ones, ones, zero, zero)  # never updated in place

    def run_compiled(self, n_rounds: int, with_eval: bool = True,
                     segment: Optional[int] = None,
                     ckpt_dir: Optional[str] = None) -> SimResult:
        """Run ``n_rounds`` rounds as an eager loop on the device (the JAX
        engine's one-scan entry point, same name; every mode but
        ``host-ga``). ``final_flat`` holds the last model and
        ``run_seconds`` the wall time, results copied back."""
        if self.policy_mode == "host-ga":
            raise ValueError("host-ga decides on the host per round; use run() or "
                             "run_host_policy")
        if segment is not None or ckpt_dir is not None:
            raise _not_ported("run_compiled(segment=..., ckpt_dir=...)",
                              "item 5 (segmented runs and checkpoints)")
        t0 = time.perf_counter()
        carry = self._init_carry()
        outs = []
        with torch.no_grad():
            for n in range(n_rounds):
                carry, out = self._round_body(carry, n, with_eval)
                outs.append(out)
        o = {k: torch.stack([x[k] for x in outs]).cpu().numpy() for k in outs[0]}
        self.final_flat = carry[0]
        self.run_seconds = time.perf_counter() - t0
        f64 = np.float64
        return SimResult(
            name=self.name,
            energy=o["energy"].astype(f64), accuracy=o["accuracy"].astype(f64),
            loss=o["loss"].astype(f64), n_scheduled=o["n_scheduled"],
            q_levels=o["q_levels"], latency=o["latency"].astype(f64),
            payload_bits=o["payload_bits"].astype(f64),
            rates=o["rates"].astype(f64), lambda1=o["lambda1"].astype(f64),
            lambda2=o["lambda2"].astype(f64),
        )

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
        (``set_round_draws``), in the compiled round's order.

        Decisions above ``q_cap`` are clamped to it for execution and in the
        records: the index planes are sized for ``q_cap`` levels (build with
        ``q_cap=16`` for baselines that quantize up to 16 bits). The fault,
        downlink and telemetry branches of the JAX engine's replay are not
        ported: ``build_sim`` refuses those options (ROADMAP.md Queue 1,
        items 4, 3 and 7).
        """
        if channel not in ("sim", "host"):
            raise ValueError(f"channel must be sim or host, got {channel!r}")
        if channel == "host" and self.host_channel is None:
            raise ValueError('channel="host" needs the sim built with a host ChannelModel')
        u = self.fleet.n_clients
        c = self.channel.params.n_channels
        dev = self.device
        d_sizes = self.fleet.d_sizes.astype(np.float64)
        g_sq, sigma_sq, theta_max = np.ones(u), np.ones(u), np.ones(u)
        flat = self.flat0
        records: list[RoundRecord] = []
        cum = 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
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
                dec = policy.decide(ctx)
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
                flat, g_obs, s_obs, theta, acc, loss = self._exec_round(
                    flat, torch.as_tensor(slots, device=dev),
                    torch.as_tensor(q_slot.astype(np.int64), device=dev),
                    torch.as_tensor(w_slot, device=dev), n, with_eval)
                g_obs, s_obs, theta = (t.cpu().numpy() for t in (g_obs, s_obs, theta))
                sel = cids[mask]
                g_sq[sel] = 0.7 * g_sq[sel] + 0.3 * g_obs[mask]
                sigma_sq[sel] = 0.7 * sigma_sq[sel] + 0.3 * np.maximum(s_obs[mask], 1e-8)
                theta_max[sel] = theta[mask]
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
        self.final_flat = flat
        self.run_seconds = time.perf_counter() - t0
        return ExperimentResult(getattr(policy, "name", "host_policy"), records)


# ------------------------------------------------------------------- build

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
    telemetry=None,
    ledger=None,
    downlink=None,
    faults=None,
    init_params: Optional[dict] = None,
    device=None,
    entropy: Any = None,
) -> FleetSim:
    """Mirror of ``repro.sim.engine.build_sim`` for the legacy single-BS
    path (``scenario=None``), every ``policy_mode`` (``greedy``/``qccf``,
    ``compiled-ga``/``qccf_ga``, ``host-ga``, ``no_quant``,
    ``channel_allocate``, ``principle``, ``same_size``), on ``device``
    (``cuda`` unless the caller passes another; raises without CUDA).

    ``init_params`` (a parameter tree of ``repro_torch.models.cnn``, e.g.
    from ``params_from_numpy`` of the JAX package's weights) replaces the
    port's own seeded init; ``entropy`` replaces the default
    :class:`~repro_torch.sim.entropy.DeviceEntropy`.
    """
    dev = resolve_device(device)
    if scenario is not None:
        raise _not_ported("scenario presets", "item 2 (scenarios)")
    if downlink not in (None, "off"):
        raise _not_ported("the quantized downlink", "item 3 (DownlinkConfig)")
    if faults is not None:
        raise _not_ported("fault injection", "item 4 (FaultSpec and screen_slots)")
    if telemetry is not None or ledger is not None:
        raise _not_ported("telemetry and the ledger", "item 7 (obs)")
    n_channels = n_clients if n_channels is None else n_channels
    v_weight = 100.0 if v_weight is None else float(v_weight)
    alpha_dirichlet = 0.5 if alpha_dirichlet is None else float(alpha_dirichlet)
    target_q = 6.0 if target_q is None else float(target_q)
    hetero_weight = 0.0 if hetero_weight is None else float(hetero_weight)
    policy_mode = "greedy" if policy_mode is None else policy_mode

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

    host_channel = ChannelModel(
        ChannelParams(n_clients=n_clients, n_channels=n_channels), seed=seed)
    channel = SimChannel.from_host_model(host_channel, dev)
    probe_rates = host_channel.draw_rates()

    z = int(_flat0.shape[0])
    probe = RoundContext(
        rates=probe_rates, d_sizes=sizes.astype(np.float64),
        g_sq=np.full(n_clients, 1.0), sigma_sq=np.full(n_clients, 1.0),
        theta_max=np.full(n_clients, 1.0), z=z,
    )
    eps1, eps2 = auto_epsilons(probe, sysp, target_q=target_q)

    hetero = None
    if hetero_weight > 0.0:
        hetero = 1.0 + hetero_weight * hetero_kl(datasets, task_spec.n_classes)

    return FleetSim(
        fleet, params, loss_fn, eval_fn, channel, sysp,
        eps1=eps1, eps2=eps2, v_weight=v_weight, lr=lr,
        batch_size=batch_size, q_cap=q_cap, seed=seed,
        hetero=hetero,
        name="sim_qccf" if name is None else name, entropy=entropy,
        host_channel=host_channel, policy_mode=policy_mode, ga_config=ga_config,
    )
