"""Genetic algorithm for the combinatorial subproblem P3.1 (Algorithm 1).

A chromosome encodes the OFDMA channel allocation: a length-C vector
``assign`` with ``assign[c] in {-1, 0..U-1}`` (-1 = channel unused).
Constraints C2/C3 mean each client holds at most one channel, so a valid
chromosome has no duplicated client id; participation is
``a_i = 1  iff  i in assign``.

Fitness (eq. 43):  J4(R) = (J0_max - J0(R))^iota  with J0 the inner
drift-plus-penalty objective evaluated at the closed-form (f*, q*) of
P3.2 — i.e. the GA's fitness calls the KKT solver per client.
Infeasible chromosomes (a scheduled client cannot meet the deadline at any
(f, q)) get fitness 0, as in the paper; an optional repair mode instead
drops the offending clients (beyond-paper, usually converges faster).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import bounds, kkt
from repro_torch.core.lyapunov import LyapunovState


# Fitness sentinel for infeasible chromosomes, shared with the compiled
# population search (repro.sim.search): paper fitness 0 == objective +inf.
J0_INFEASIBLE = float("inf")


@dataclasses.dataclass(frozen=True)
class GAConfig:
    generations: int = 30       # s_max
    population: int = 32        # N_pop
    p_crossover: float = 0.8    # p^c
    p_mutation: float = 0.08    # p^m
    iota: float = 1.0           # fitness dispersion exponent
    elitism: int = 2            # carried-over best chromosomes
    tournament: int = 2         # tournament size (compiled search selection)
    repair_infeasible: bool = False  # beyond-paper: drop clients vs fitness=0


@dataclasses.dataclass(frozen=True)
class RoundContext:
    """Observable state the controller sees at the start of a round."""

    rates: np.ndarray        # (U, C) uplink rate of client i on channel c [bit/s]
    d_sizes: np.ndarray      # (U,) dataset sizes D_i
    g_sq: np.ndarray         # (U,) gradient-bound estimates G_i^2
    sigma_sq: np.ndarray     # (U,) minibatch variance estimates sigma_i^2
    theta_max: np.ndarray    # (U,) per-client model ranges
    z: int                   # model dimension


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Table-I style wireless/compute constants."""

    p_tx: float = 0.2
    alpha: float = 1e-26
    gamma: float = 1000.0
    tau: int = 6
    tau_e: int = 2
    t_max: float = 0.02
    f_min: float = 2e8
    f_max: float = 1e9
    lipschitz: float = 1.0
    eta: float = 0.05

    def bound_constants(self) -> bounds.BoundConstants:
        return bounds.BoundConstants(eta=self.eta, tau=self.tau, lipschitz=self.lipschitz)


@dataclasses.dataclass
class Decision:
    """Output of the controller for one communication round."""

    assign: np.ndarray                 # (C,) channel -> client (-1 unused)
    a: np.ndarray                      # (U,) participation
    q: np.ndarray                      # (U,) integer quantization levels (0 if out)
    f: np.ndarray                      # (U,) CPU frequencies (0 if out)
    energy: np.ndarray                 # (U,) per-client energy
    latency: np.ndarray                # (U,) per-client latency
    j0: float                          # drift-plus-penalty objective
    data_term: float                   # C6 per-round contribution
    quant_term: float                  # C7 per-round contribution
    feasible: bool

    @property
    def total_energy(self) -> float:
        return float(np.sum(self.energy))


def _participation(assign: np.ndarray, n_clients: int) -> np.ndarray:
    a = np.zeros(n_clients, dtype=np.int64)
    for cid in assign:
        if cid >= 0:
            a[cid] = 1
    return a


def evaluate_assignment(
    assign: np.ndarray,
    ctx: RoundContext,
    sysp: SystemParams,
    lyap: LyapunovState,
    v_weight: float,
    q_prev: Optional[np.ndarray] = None,
    repair: bool = False,
) -> Decision:
    """Inner objective J0 for one chromosome: per-client KKT + bound terms."""
    u = ctx.d_sizes.shape[0]
    assign = assign.copy()
    consts = sysp.bound_constants()
    w_full = ctx.d_sizes / np.sum(ctx.d_sizes)

    while True:
        a = _participation(assign, u)
        d_n = float(np.sum(a * ctx.d_sizes))
        if d_n <= 0:
            # Nobody participates: pure scheduling penalty, no energy.
            w_round = np.zeros(u)
            dt = bounds.data_term(consts, a, w_full, w_round, ctx.g_sq, ctx.sigma_sq)
            return Decision(
                assign=assign, a=a, q=np.zeros(u, np.int64), f=np.zeros(u),
                energy=np.zeros(u), latency=np.zeros(u),
                j0=lyap.drift_plus_penalty(dt, 0.0, 0.0),
                data_term=dt, quant_term=0.0, feasible=True,
            )
        w_round = a * ctx.d_sizes / d_n
        q = np.zeros(u, dtype=np.int64)
        f = np.zeros(u)
        energy = np.zeros(u)
        lat = np.zeros(u)
        dropped: list[int] = []
        for c, cid in enumerate(assign):
            if cid < 0:
                continue
            env = kkt.ClientEnv(
                v=float(ctx.rates[cid, c]), w=float(w_round[cid]),
                d_size=float(ctx.d_sizes[cid]), z=ctx.z,
                theta_max=float(ctx.theta_max[cid]),
                lambda2=lyap.lambda2, eps2=lyap.eps2_for_kkt, v_weight=v_weight,
                p=sysp.p_tx, alpha=sysp.alpha, gamma=sysp.gamma,
                tau_e=sysp.tau_e, t_max=sysp.t_max,
                f_min=sysp.f_min, f_max=sysp.f_max, lipschitz=sysp.lipschitz,
            )
            prev = float(q_prev[cid]) if q_prev is not None else None
            dec = kkt.solve_client(env, q_prev=prev)
            if dec is None:
                dropped.append(c)
                continue
            q[cid], f[cid] = dec.q, dec.f
            energy[cid] = dec.energy
            lat[cid] = dec.latency
        if dropped and repair:
            for c in dropped:
                assign[c] = -1
            continue  # re-evaluate with the infeasible clients removed
        feasible = not dropped
        dt = bounds.data_term(consts, a, w_full, w_round, ctx.g_sq, ctx.sigma_sq)
        qt = bounds.quant_term(consts, w_round, ctx.z, ctx.theta_max, np.maximum(q, 1))
        e_total = float(np.sum(energy))
        return Decision(
            assign=assign, a=a, q=q, f=f, energy=energy, latency=lat,
            j0=lyap.drift_plus_penalty(dt, qt, e_total),
            data_term=dt, quant_term=qt, feasible=feasible,
        )


def _random_chromosome(rng: np.random.Generator, n_clients: int, n_channels: int) -> np.ndarray:
    """Random injective channel->client assignment (some channels may idle)."""
    assign = np.full(n_channels, -1, dtype=np.int64)
    k = rng.integers(1, min(n_clients, n_channels) + 1)
    clients = rng.permutation(n_clients)[:k]
    chans = rng.permutation(n_channels)[:k]
    assign[chans] = clients
    return assign


def _repair_duplicates(rng: np.random.Generator, assign: np.ndarray) -> np.ndarray:
    """Keep one channel per duplicated client (random keeper), free the rest."""
    out = assign.copy()
    seen: dict[int, list[int]] = {}
    for c, cid in enumerate(out):
        if cid >= 0:
            seen.setdefault(int(cid), []).append(c)
    for cid, chans in seen.items():
        if len(chans) > 1:
            keep = chans[rng.integers(len(chans))]
            for c in chans:
                if c != keep:
                    out[c] = -1
    return out


def _crossover(rng: np.random.Generator, p1: np.ndarray, p2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Single-point crossover + duplicate repair."""
    c = p1.shape[0]
    if c < 2:
        return p1.copy(), p2.copy()
    pt = int(rng.integers(1, c))
    c1 = np.concatenate([p1[:pt], p2[pt:]])
    c2 = np.concatenate([p2[:pt], p1[pt:]])
    return _repair_duplicates(rng, c1), _repair_duplicates(rng, c2)


def _mutate(rng: np.random.Generator, assign: np.ndarray, n_clients: int, p_m: float) -> np.ndarray:
    out = assign.copy()
    for c in range(out.shape[0]):
        if rng.random() < p_m:
            out[c] = rng.integers(-1, n_clients)
    return _repair_duplicates(rng, out)


def run_ga(
    ctx: RoundContext,
    sysp: SystemParams,
    lyap: LyapunovState,
    v_weight: float,
    cfg: GAConfig = GAConfig(),
    q_prev: Optional[np.ndarray] = None,
    seed: int = 0,
    seed_chromosomes: Optional[list[np.ndarray]] = None,
) -> Decision:
    """Algorithm 1: evolve channel allocations, return the best decision."""
    rng = np.random.default_rng(seed)
    u = ctx.d_sizes.shape[0]
    c = ctx.rates.shape[1]
    pop = [_random_chromosome(rng, u, c) for _ in range(cfg.population)]
    if seed_chromosomes:
        pop[: len(seed_chromosomes)] = [s.copy() for s in seed_chromosomes]

    def eval_all(chroms: list[np.ndarray]) -> list[Decision]:
        return [
            evaluate_assignment(
                ch, ctx, sysp, lyap, v_weight, q_prev, repair=cfg.repair_infeasible
            )
            for ch in chroms
        ]

    best: Optional[Decision] = None
    for _gen in range(cfg.generations):
        decs = eval_all(pop)
        j0s = np.array([d.j0 if d.feasible else J0_INFEASIBLE for d in decs])
        finite = np.isfinite(j0s)
        if finite.any():
            j0_max = float(np.max(j0s[finite]))
            fit = np.where(finite, np.maximum(j0_max - j0s, 0.0) ** cfg.iota, 0.0)
        else:
            fit = np.ones(len(pop))
        for d in decs:
            if d.feasible and (best is None or d.j0 < best.j0):
                best = d
        # Selection: fitness-proportional with elitism.
        order = np.argsort(j0s)
        elites = [pop[i].copy() for i in order[: cfg.elitism]]
        probs = fit + 1e-12
        probs = probs / probs.sum()
        children: list[np.ndarray] = list(elites)
        while len(children) < cfg.population:
            i, j = rng.choice(len(pop), size=2, p=probs)
            if rng.random() < cfg.p_crossover:
                ch1, ch2 = _crossover(rng, pop[i], pop[j])
            else:
                ch1, ch2 = pop[i].copy(), pop[j].copy()
            children.append(_mutate(rng, ch1, u, cfg.p_mutation))
            if len(children) < cfg.population:
                children.append(_mutate(rng, ch2, u, cfg.p_mutation))
        pop = children

    if best is None:
        # Every chromosome infeasible in every generation: schedule nobody.
        best = evaluate_assignment(
            np.full(c, -1, dtype=np.int64), ctx, sysp, lyap, v_weight, q_prev
        )
    return best
