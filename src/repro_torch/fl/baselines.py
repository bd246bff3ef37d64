"""Decision policies: QCCF (ours) + the paper's four baselines (Sec. VI);
the port of ``repro.fl.baselines`` (numpy only).

  (a) NoQuant          — upload fp32 models (q = 32), greedy channels
  (b) ChannelAllocate  — optimize channels, then the max q that fits T_max
  (c) Principle [24]   — DAdaQuant-style doubly adaptive schedule that
                         ignores wireless constraints: q rises with the
                         round index and scales with dataset size
  (d) SameSize [26]    — Lyapunov channel+quant optimization assuming all
                         clients have the mean dataset size

All baselines schedule every client that can get a channel (the paper's
baselines do not drop clients deliberately); clients that cannot meet
T_max at the chosen q simply time out (energy still spent), which is
exactly the "principle" pathology Fig. 3/4 exhibit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import bounds, kkt
from repro_torch.core.genetic import (
    Decision,
    GAConfig,
    RoundContext,
    SystemParams,
    evaluate_assignment,
    run_ga,
)
from repro_torch.core.lyapunov import LyapunovState
from repro_torch.core.controller import QCCFController
from repro_torch.fl.trainer import Policy


class QCCFPolicy(Policy):
    name = "qccf"

    def __init__(self, controller: QCCFController) -> None:
        self.controller = controller

    def decide(self, ctx: RoundContext) -> Decision:
        return self.controller.decide(ctx)

    def commit(self, dec: Decision) -> None:
        self.controller.commit(dec)


def _greedy_channels(rates: np.ndarray) -> np.ndarray:
    """Assign each channel to the best remaining client (max rate)."""
    u, c = rates.shape
    assign = np.full(c, -1, dtype=np.int64)
    taken: set[int] = set()
    order = sorted(
        ((rates[i, ch], i, ch) for i in range(u) for ch in range(c)), reverse=True
    )
    used_ch: set[int] = set()
    for rate, i, ch in order:
        if i in taken or ch in used_ch:
            continue
        assign[ch] = i
        taken.add(i)
        used_ch.add(ch)
        if len(taken) == u:
            break
    return assign


def _energies(
    ctx: RoundContext, sysp: SystemParams, assign: np.ndarray,
    q: np.ndarray, f: np.ndarray,
) -> Decision:
    """Account energy/latency for fixed (assign, q, f) (baseline bookkeeping)."""
    u = ctx.d_sizes.shape[0]
    a = np.zeros(u, dtype=np.int64)
    energy = np.zeros(u)
    lat = np.zeros(u)
    consts = sysp.bound_constants()
    for ch, cid in enumerate(assign):
        if cid < 0:
            continue
        a[cid] = 1
        v = float(ctx.rates[cid, ch])
        bits = ctx.z * float(q[cid]) + ctx.z + 32.0
        t_com = bits / v
        t_cmp = sysp.tau_e * sysp.gamma * float(ctx.d_sizes[cid]) / float(f[cid])
        energy[cid] = (
            sysp.tau_e * sysp.alpha * sysp.gamma * ctx.d_sizes[cid] * f[cid] ** 2
            + sysp.p_tx * t_com
        )
        lat[cid] = t_cmp + t_com
    d_n = float(np.sum(a * ctx.d_sizes))
    w_full = ctx.d_sizes / np.sum(ctx.d_sizes)
    w_round = a * ctx.d_sizes / d_n if d_n > 0 else np.zeros(u)
    dt = bounds.data_term(consts, a, w_full, w_round, ctx.g_sq, ctx.sigma_sq)
    qt = bounds.quant_term(consts, w_round, ctx.z, ctx.theta_max, np.maximum(q, 1))
    return Decision(
        assign=assign, a=a, q=q.astype(np.int64), f=f, energy=energy,
        latency=lat, j0=0.0, data_term=dt, quant_term=qt, feasible=True,
    )


class NoQuantPolicy(Policy):
    """Upload unquantized fp32 models (q = 32), latency-tight frequency."""

    name = "no_quant"

    def __init__(self, sysp: SystemParams) -> None:
        self.sysp = sysp

    def decide(self, ctx: RoundContext) -> Decision:
        assign = _greedy_channels(ctx.rates)
        u = ctx.d_sizes.shape[0]
        q = np.full(u, 32.0)
        f = np.full(u, self.sysp.f_max)  # fp32 payload: race the deadline
        return _energies(ctx, self.sysp, assign, q, f)


class ChannelAllocatePolicy(Policy):
    """Greedy channels, then the LARGEST q that still meets T_max at f_max
    (quantization adapted to the channel only — not to training progress
    or dataset size)."""

    name = "channel_allocate"

    def __init__(self, sysp: SystemParams, q_cap: int = 16) -> None:
        self.sysp = sysp
        self.q_cap = q_cap

    def decide(self, ctx: RoundContext) -> Decision:
        sp = self.sysp
        assign = _greedy_channels(ctx.rates)
        u = ctx.d_sizes.shape[0]
        q = np.ones(u)
        f = np.full(u, sp.f_max)
        for ch, cid in enumerate(assign):
            if cid < 0:
                continue
            v = float(ctx.rates[cid, ch])
            t_cmp = sp.tau_e * sp.gamma * float(ctx.d_sizes[cid]) / sp.f_max
            budget_bits = v * (sp.t_max - t_cmp)
            q_i = math.floor((budget_bits - ctx.z - 32.0) / ctx.z)
            q[cid] = min(max(q_i, 1), self.q_cap)
            # relax f down to the latency boundary at the chosen q
            env_bits = ctx.z * q[cid] + ctx.z + 32.0
            slack = sp.t_max - env_bits / v
            if slack > 0:
                f_req = sp.tau_e * sp.gamma * float(ctx.d_sizes[cid]) / slack
                f[cid] = min(max(f_req, sp.f_min), sp.f_max)
        return _energies(ctx, self.sysp, assign, q, f)


class PrinciplePolicy(Policy):
    """DAdaQuant-flavoured [24]: q doubles on a fixed round schedule and is
    scaled UP for larger datasets (their principle: more data -> lower
    quantization error budget), with no wireless awareness: f is pinned to
    f_max so big-data clients burn energy trying to make the deadline."""

    name = "principle_24"

    def __init__(self, sysp: SystemParams, q0: float = 2.0,
                 double_every: int = 30, q_cap: int = 16) -> None:
        self.sysp = sysp
        self.q0 = q0
        self.double_every = double_every
        self.q_cap = q_cap
        self.round = 0

    def decide(self, ctx: RoundContext) -> Decision:
        assign = _greedy_channels(ctx.rates)
        u = ctx.d_sizes.shape[0]
        base = self.q0 * 2.0 ** (self.round // self.double_every)
        size_scale = ctx.d_sizes / np.mean(ctx.d_sizes)
        q = np.minimum(np.maximum(np.round(base * size_scale), 1), self.q_cap)
        f = np.full(u, self.sysp.f_max)
        dec = _energies(ctx, self.sysp, assign, q, f)
        # clients that cannot meet the deadline drop out (model not received)
        dec.a = np.where(dec.latency > self.sysp.t_max, 0, dec.a)
        return dec

    def commit(self, dec: Decision) -> None:
        self.round += 1


class SameSizePolicy(Policy):
    """[26]-style Lyapunov optimization that assumes every client has the
    MEAN dataset size: runs the same GA+KKT machinery as QCCF but feeds it
    a context with D_i := mean(D). Computation latency/energy are then
    accounted with the TRUE sizes (the mismatch is the point)."""

    name = "same_size_26"

    def __init__(self, controller) -> None:
        # any controller with decide/commit/sysp works: the numpy GA
        # (QCCFController) or the host oracle of the compiled search on the
        # engine's draws (repro_torch.sim.search.HostGAPolicy)
        self.controller = controller

    def set_round_draws(self, draws) -> None:
        # forwarded so FleetSim.run_host_policy can drive a HostGAPolicy
        # controller on the engine's per-round GA draws
        if hasattr(self.controller, "set_round_draws"):
            self.controller.set_round_draws(draws)

    def decide(self, ctx: RoundContext) -> Decision:
        fake = dataclasses.replace(
            ctx, d_sizes=np.full_like(ctx.d_sizes, float(np.mean(ctx.d_sizes)))
        )
        dec = self.controller.decide(fake)
        # re-account energy/latency with the true sizes at the decided (q, f)
        sysp = self.controller.sysp
        dec2 = _energies(ctx, sysp, dec.assign, dec.q.astype(float), np.where(dec.f > 0, dec.f, sysp.f_min))
        # clients whose true latency busts the deadline accelerate to f_max;
        # if still infeasible they time out (dropped).
        for i in range(len(dec2.a)):
            if dec2.a[i] and dec2.latency[i] > sysp.t_max:
                f = np.array(dec2.f)
                f[i] = sysp.f_max
                dec2 = _energies(ctx, sysp, dec2.assign, dec2.q.astype(float), f)
        dec2.a = np.where(dec2.latency > sysp.t_max * (1 + 1e-9), 0, dec2.a)
        return dec2

    def commit(self, dec: Decision) -> None:
        self.controller.commit(dec)
