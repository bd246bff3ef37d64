"""The fleet simulator's QCCF round on the device (the greedy path of
``repro.sim.engine``).

``build_sim`` mirrors the JAX package's setup for the legacy single-BS
path (same synthetic datasets, same client drop, same eps1/eps2
calibration for a given seed); ``FleetSim.run_compiled`` then runs the
rounds as an eager loop on the device. One round:

  decision   — greedy channels + vectorised KKT (``repro_torch.sim.policy``)
               on the round's (U, C) rates
  compaction — gather the S = min(U, C) scheduled clients onto the slot
               axis; everything below is O(S)
  local work — tau-step SGD of the S slots under one ``torch.func.vmap``
  wire       — eq.-4 stochastic quantization of the S slot vectors into
               Zpad-shaped u8/u16 index planes + u8 sign planes
  aggregate  — fused dequantize + eq.-2 weighted sum through the CUDA
               ``aggregate`` kernel (``repro_torch.kernels``), one launch
  scatter    — masked EMA updates of the (U,) G²/σ²/θ estimators
  queues     — Lyapunov lambda1/lambda2 updates

The round's random draws come from an entropy source
(``repro_torch.sim.entropy``). The other policies, the downlink, faults,
telemetry and segmented runs of the JAX engine are not ported yet; asking
for one raises ``NotImplementedError`` naming its ROADMAP.md item.
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
from repro_torch.core.genetic import RoundContext, SystemParams
from repro_torch.data.synthetic import (
    SyntheticImageTask, gaussian_sizes, hetero_kl, make_federated_datasets,
    make_test_set,
)
from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.fl.experiment import TASKS, task_data_sizes
from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quant as sq
from repro_torch.models import cnn
from repro_torch.sim import policy as fast_policy
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


GA_ITEM = "item 1 (compiled GA, baselines and host-policy replay)"


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
        u = fleet.n_clients
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

    def _round_body(self, carry, ridx: int, with_eval: bool):
        flat, g_sq, sigma_sq, theta_max, lam1, lam2 = carry
        sysp, z = self.sysp, self.z
        rates = self.entropy.rates(ridx, self.channel)
        g_n = g_sq / torch.clamp(torch.mean(g_sq), min=1e-12)
        s_n = sigma_sq / torch.clamp(torch.mean(sigma_sq), min=1e-12)
        d_sizes = self.fleet.n_samples.to(torch.float32)
        dec = fast_policy.decide(
            rates, d_sizes, g_n, s_n, theta_max, lam2, sysp, z,
            self.v_weight, q_cap=self.q_cap, hetero=self._hetero,
        )
        # ---- active-set compaction: everything below is on the S slots
        u = self.fleet.n_clients
        slots = dec.slots                                  # (S,) ids, -1 pad
        sm = slots >= 0
        cid = torch.clamp(slots, min=0)

        x_s, y_s, n_s = gather_active(self.fleet, slots)
        batch_idx = self.entropy.batch_indices(ridx, n_s, sysp.tau, self.batch_size)
        stacked, g_obs, s_obs = fleet_local_sgd(
            self.loss_fn, sysp.tau, self.unravel(flat), x_s, y_s, batch_idx, self.lr,
        )
        s = slots.shape[0]
        flat_s = torch.cat([leaf.reshape(s, -1) for leaf in tree_util.leaves(stacked)],
                           dim=1)                          # (S, Z)

        q_slot = dec.q[cid] * sm.to(dec.q.dtype)
        u01 = self.entropy.uniforms(ridx, s, self._zpad)
        idx, signs, theta = _quantize_wire(u01, flat_s, q_slot, self.q_cap, self._zpad)
        d_slot = d_sizes[cid] * sm.to(torch.float32)
        d_n = torch.sum(d_slot)
        w_slot = d_slot / torch.clamp(d_n, min=1e-12)      # eq. 2 weights
        agg = self._aggregate(idx, signs, theta, w_slot, q_slot)
        new_flat = torch.where(d_n > 0, agg[:z], flat)

        g_sq = ema_update(g_sq, scatter_slots(slots, g_obs, u), dec.a)
        sigma_sq = ema_update(sigma_sq, scatter_slots(slots, s_obs, u), dec.a, floor=1e-8)
        theta_max = torch.where(dec.a > 0, scatter_slots(slots, theta, u), theta_max)
        lam1 = torch.clamp(lam1 + dec.data_term - self._eps[0], min=0.0)
        lam2 = torch.clamp(lam2 + dec.quant_term - self._eps[1], min=0.0)

        if with_eval:
            acc, loss = self.eval_fn(new_flat)
        else:
            acc = loss = torch.zeros((), dtype=torch.float32, device=self.device)
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
        engine's one-scan entry point, same name). ``final_flat`` holds the
        last model and ``run_seconds`` the wall time, results copied back."""
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

    def run_host_policy(self, *args, **kwargs):
        raise _not_ported("run_host_policy", GA_ITEM)


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
    path (``scenario=None``) and the greedy QCCF policy, on ``device``
    (``cuda`` unless the caller passes another; raises without CUDA).

    ``init_params`` (a parameter tree of ``repro_torch.models.cnn``, e.g.
    from ``params_from_numpy`` of the JAX package's weights) replaces the
    port's own seeded init; ``entropy`` replaces the default
    :class:`~repro_torch.sim.entropy.DeviceEntropy`.
    """
    dev = resolve_device(device)
    if scenario is not None:
        raise _not_ported("scenario presets", "item 2 (scenarios)")
    if policy_mode not in (None, "greedy", "qccf"):
        raise _not_ported(f"policy_mode={policy_mode!r}", GA_ITEM)
    if ga_config is not None:
        raise _not_ported("ga_config", GA_ITEM)
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
    )
