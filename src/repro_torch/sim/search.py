"""Population search over channel assignments on the device (Algorithm 1;
the port of ``repro.sim.search``).

A genetic algorithm over OFDMA channel assignments whose fitness is the
closed-form KKT solve (eq. 41/42) on every chromosome: population init from
random valid assignments, tournament selection by objective, one-point
crossover and mutation as masked ``where``s, duplicate repair by the
stable-argsort first-occurrence keeper. Every operator works on the whole
(P, C) population at once and the fitness is one batched
``policy.finish_decision`` over the (P, U) axis, so a generation is a fixed
stream of asynchronous launches with no host round trip.

The randomness comes in as one round's :class:`~repro_torch.sim.entropy.GADraws`
(torch cannot replay threefry). The JAX package draws the same record from
``fold_in(round_key, GA_KEY_TAG)`` (tag 11 in ``repro.sim.search``):

    k                 -> k_init, k_evolve = split(k)
    init chromosome i -> ki = split(k_init, P)[i]; kk, ku, kc = split(ki, 3)
                         n_sched[i] = randint(kk, (), 1, min(U, C) + 1)
                         perm_u[i] = permutation(ku, U); perm_c[i] = permutation(kc, C)
    generation g      -> kg = split(k_evolve, G)[g]
                         k_sel, k_cx, k_pt, k_mm, k_mv = split(kg, 5)
                         cand[g]    = randint(k_sel, (NP, 2, T), 0, P)
                         u_cx[g]    = uniform(k_cx, (NP,))
                         pt[g]      = randint(k_pt, (NP,), 1, C)
                         u_mut[g]   = uniform(k_mm, (P - E, C))
                         mut_val[g] = randint(k_mv, (P - E, C), -1, U)

``run_ga_host`` is the numpy oracle: the same operators on the same draws,
fitness through the scalar ``repro_torch.core.kkt`` (``policy.finish_host``).
On shared draws both searches visit the same populations, so the winning
assignment matches (a comparison can only part on a near-exact J0 tie
between distinct chromosomes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.genetic import Decision, GAConfig, J0_INFEASIBLE, SystemParams
from repro_torch.obs.profile import scope as _profile_scope
from repro_torch.sim import policy as fast_policy
from repro_torch.sim.entropy import GADraws, ga_shapes


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor as ``jnp.median`` takes it: the mean of the
    two middle values of an even count, ``(lo + hi) * 0.5`` in the input's
    dtype (``torch.median`` returns the lower one), on the device."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


# ----------------------------------------------------------------- operators

def repair_duplicates(assign: torch.Tensor) -> torch.Tensor:
    """C2/C3 repair over the last axis: each client keeps its LOWEST-index
    channel. A stable argsort groups equal client ids in ascending channel
    order and the first row of each group wins (torch's default sort is
    not stable, JAX's is)."""
    order = torch.argsort(assign, dim=-1, stable=True)
    sorted_vals = torch.take_along_dim(assign, order, dim=-1)
    first = torch.ones_like(sorted_vals, dtype=torch.bool)
    first[..., 1:] = sorted_vals[..., 1:] != sorted_vals[..., :-1]
    keep = torch.zeros_like(first).scatter(-1, order, first & (sorted_vals >= 0))
    return torch.where(keep, assign, torch.full_like(assign, -1))


def repair_duplicates_host(assign: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`repair_duplicates` for one chromosome."""
    assign = np.asarray(assign)
    c = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sorted_vals = assign[order]
    first = np.concatenate([[True], sorted_vals[1:] != sorted_vals[:-1]])
    keep = np.zeros(c, bool)
    keep[order] = first & (sorted_vals >= 0)
    return np.where(keep, assign, -1).astype(assign.dtype)


def random_assignment(n_sched: torch.Tensor, perm_u: torch.Tensor,
                      perm_c: torch.Tensor) -> torch.Tensor:
    """(P,) counts + (P, U), (P, C) permutations -> (P, C) random injective
    channel->client maps scheduling n_sched[i] clients (the port of
    ``core.genetic._random_chromosome`` on the draws)."""
    p, u = perm_u.shape
    c = perm_c.shape[1]
    m = min(u, c)
    ranks = torch.arange(m, device=perm_u.device)
    vals = torch.where(ranks < n_sched[:, None], perm_u[:, :m],
                       torch.full_like(perm_u[:, :m], -1))
    out = torch.full((p, c), -1, dtype=perm_u.dtype, device=perm_u.device)
    return out.scatter(1, perm_c[:, :m], vals)


def random_assignment_host(n_sched: int, perm_u: np.ndarray, perm_c: np.ndarray,
                           n_channels: int) -> np.ndarray:
    """Numpy mirror of one row of :func:`random_assignment`."""
    assign = np.full(n_channels, -1, dtype=np.int64)
    assign[perm_c[:n_sched]] = perm_u[:n_sched]
    return assign


def next_generation(pop: torch.Tensor, j0: torch.Tensor, draws: GADraws, g: int,
                    cfg: GAConfig) -> torch.Tensor:
    """Generation ``g``'s evolution step on the (P, C) population: elitism +
    tournament + crossover + mutation, each child repaired."""
    p, c = pop.shape
    n_child = p - cfg.elitism
    n_pairs = (n_child + 1) // 2
    cand = draws.cand[g]                                          # (NP, 2, T)
    win = torch.argmin(j0[cand], dim=-1)                          # ties -> first
    parent_idx = torch.take_along_dim(cand, win[..., None], dim=-1)[..., 0]
    p1, p2 = pop[parent_idx[:, 0]], pop[parent_idx[:, 1]]

    do_cx = (draws.u_cx[g] < cfg.p_crossover)[:, None]
    cut = torch.arange(c, device=pop.device)[None, :] < draws.pt[g][:, None]
    c1 = torch.where(do_cx, repair_duplicates(torch.where(cut, p1, p2)), p1)
    c2 = torch.where(do_cx, repair_duplicates(torch.where(cut, p2, p1)), p2)
    children = torch.stack([c1, c2], dim=1).reshape(2 * n_pairs, c)[:n_child]

    mut_mask = draws.u_mut[g] < cfg.p_mutation
    children = repair_duplicates(torch.where(mut_mask, draws.mut_val[g], children))

    elites = pop[torch.argsort(j0, stable=True)[: cfg.elitism]]
    return torch.cat([elites, children], dim=0)


# ------------------------------------------------------------------- fitness

def evaluate_population(
    pop: torch.Tensor,       # (P, C)
    rates: torch.Tensor,     # (U, C)
    d_sizes: torch.Tensor,
    g_sq: torch.Tensor,
    sigma_sq: torch.Tensor,
    theta_max: torch.Tensor,
    lam1: torch.Tensor,      # scalar lambda1 queue
    lam2: torch.Tensor,      # scalar lambda2 queue
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int,
    repair_infeasible: bool,
    hetero=None,
    dl_term=None,
) -> torch.Tensor:
    """(P,) drift-plus-penalty objective J0 per chromosome (eq. 26, sound
    form): lam1 * data_term + lam2 * quant_term + V * energy, through one
    batched ``policy.finish_decision`` over the population axis. With
    ``repair_infeasible`` False, chromosomes whose scheduled set needed the
    feasibility drop get ``J0_INFEASIBLE`` (the paper's fitness-0 rule).
    ``dl_term`` (the downlink's previous-round error term) shifts every
    chromosome's quant term alike, so selection is unchanged, but the
    winner carries it into the lambda2 queue."""
    with _profile_scope("evaluate_population"):
        v_assigned, a0 = fast_policy.participation_from_assign(pop, rates)
        fd = fast_policy.finish_decision(
            pop, v_assigned, a0, d_sizes, g_sq, sigma_sq, theta_max, lam2,
            sysp, z, v_weight, q_cap=q_cap, hetero=hetero, dl_term=dl_term,
        )
        j0 = lam1 * fd.data_term + lam2 * fd.quant_term + v_weight * torch.sum(fd.energy, dim=-1)
        if not repair_infeasible:
            dropped = torch.any(a0 & (fd.a == 0), dim=-1)
            j0 = torch.where(dropped, torch.full_like(j0, J0_INFEASIBLE), j0)
        return j0


def _check_draws(draws: GADraws, n_clients: int, n_channels: int, cfg: GAConfig) -> None:
    for name, shape in ga_shapes(n_clients, n_channels, cfg).items():
        got = tuple(getattr(draws, name).shape)
        if got != shape:
            raise ValueError(f"GA draws: {name} has shape {got}, want {shape} for {cfg}")


# ------------------------------------------------------------------ the GA

def ga_decide(
    draws: GADraws,
    rates: torch.Tensor,     # (U, C)
    d_sizes: torch.Tensor,
    g_sq: torch.Tensor,
    sigma_sq: torch.Tensor,
    theta_max: torch.Tensor,
    lam1: torch.Tensor,
    lam2: torch.Tensor,
    sysp: SystemParams,
    z: int,
    v_weight: float,
    cfg: GAConfig = GAConfig(),
    q_cap: int = 8,
    hetero=None,
    dl_term=None,
    with_stats: bool = False,
) -> fast_policy.FastDecision:
    """Algorithm 1 on the device: GA over assignments + KKT fitness.

    Returns the :class:`policy.FastDecision` of the best chromosome found
    over ``cfg.generations`` x ``cfg.population`` evaluations (the last
    generation's children are produced but not evaluated, as in the JAX
    package). If no chromosome was ever feasible the empty assignment is
    returned (schedule nobody). The best-so-far bookkeeping stays on the
    device (``index_select`` of the argmin, ``where`` on the comparison):
    no ``.item()``, no tensor in a Python condition, no ``nonzero``.

    ``with_stats=True`` (the telemetry gate, see ``repro_torch.obs``) also
    returns ``{"ga_best", "ga_median"}``, 0-d device tensors: the running
    best J0 after the last evaluated generation and that generation's median
    population J0 (:func:`median`), the taps behind
    ``RoundMetrics.ga_best``/``ga_median``. The default False runs no
    extra operation.
    """
    u, c = rates.shape
    assert c >= 2, "population search needs at least two channels"
    _check_draws(draws, u, c, cfg)
    pop = random_assignment(draws.n_sched, draws.perm_u, draws.perm_c)
    best_assign = torch.full((c,), -1, dtype=pop.dtype, device=pop.device)
    best_j0 = torch.full((), J0_INFEASIBLE, dtype=torch.float32, device=pop.device)
    j0 = None
    for g in range(cfg.generations):
        j0 = evaluate_population(
            pop, rates, d_sizes, g_sq, sigma_sq, theta_max, lam1, lam2,
            sysp, z, v_weight, q_cap, cfg.repair_infeasible, hetero=hetero,
            dl_term=dl_term,
        )
        i_star = torch.argmin(j0).reshape(1)                      # ties -> first
        j_star = j0.index_select(0, i_star)[0]
        better = j_star < best_j0
        best_assign = torch.where(better, pop.index_select(0, i_star)[0], best_assign)
        best_j0 = torch.where(better, j_star, best_j0)
        pop = next_generation(pop, j0, draws, g, cfg)

    # re-evaluate the winner to materialize its full record; an
    # all-infeasible search leaves best_assign empty == schedule nobody
    v_assigned, a0 = fast_policy.participation_from_assign(best_assign, rates)
    fd = fast_policy.finish_decision(
        best_assign, v_assigned, a0, d_sizes, g_sq, sigma_sq, theta_max,
        lam2, sysp, z, v_weight, q_cap=q_cap, hetero=hetero, dl_term=dl_term,
    )
    if with_stats:
        nan = torch.full((), float("nan"), dtype=torch.float32, device=pop.device)
        return fd, {"ga_best": best_j0 if j0 is not None else nan,
                    "ga_median": median(j0) if j0 is not None else nan}
    return fd


# ------------------------------------------------------------ SameSize [26]

def baseline_same_size(
    draws: GADraws,
    rates: torch.Tensor,     # (U, C)
    d_sizes: torch.Tensor,
    g_sq: torch.Tensor,
    sigma_sq: torch.Tensor,
    theta_max: torch.Tensor,
    lam1: torch.Tensor,
    lam2: torch.Tensor,
    sysp: SystemParams,
    z: int,
    v_weight: float,
    cfg: GAConfig = GAConfig(),
    q_cap: int = 8,
    with_stats: bool = False,
) -> fast_policy.FastDecision:
    """``fl.baselines.SameSizePolicy`` on the device: the GA+KKT search
    pretending every client holds the MEAN dataset size, then energy and
    latency re-accounted with the true sizes. Deadline-missers escalate to
    f_max; clients still late then time out. Heterogeneity-blind.
    ``with_stats`` also returns the search's taps, as :func:`ga_decide`."""
    # a tensor of its own, not a stride-0 view: the KKT kernel reads
    # contiguous inputs
    fake_d = torch.mean(d_sizes).expand_as(d_sizes).contiguous()
    fd = ga_decide(draws, rates, fake_d, g_sq, sigma_sq, theta_max, lam1, lam2,
                   sysp, z, v_weight, cfg=cfg, q_cap=q_cap, with_stats=with_stats)
    if with_stats:
        fd, ga_stats = fd
    q_raw = fd.q.to(torch.float32)
    f0 = torch.where(fd.f > 0, fd.f, torch.full_like(fd.f, sysp.f_min))
    first = fast_policy.account_baseline(
        fd.assign, rates, d_sizes, g_sq, sigma_sq, theta_max, q_raw, f0,
        sysp, z, q_cap,
    )
    # the host escalation loop raises one f at a time, but each client's
    # latency depends only on its own f, so one vectorised pass is exact
    f2 = torch.where(first.latency > sysp.t_max, torch.full_like(f0, sysp.f_max), f0)
    final = fast_policy.account_baseline(
        fd.assign, rates, d_sizes, g_sq, sigma_sq, theta_max, q_raw, f2,
        sysp, z, q_cap, drop_late=True, late_tol=1.0 + 1e-9,
    )
    return (final, ga_stats) if with_stats else final


# ------------------------------------------------------------- host oracle

def _j0_host(fd: fast_policy.FastDecision, lam1: float, lam2: float,
             v_weight: float) -> float:
    return (lam1 * float(fd.data_term) + lam2 * float(fd.quant_term)
            + v_weight * float(np.sum(fd.energy)))


def run_ga_host(
    draws: GADraws,
    rates: np.ndarray,       # (U, C)
    d_sizes: np.ndarray,
    g_sq: np.ndarray,
    sigma_sq: np.ndarray,
    theta_max: np.ndarray,
    lam1: float,
    lam2: float,
    sysp: SystemParams,
    z: int,
    v_weight: float,
    cfg: GAConfig = GAConfig(),
    q_cap: int = 8,
    hetero: Optional[np.ndarray] = None,
    dl_term: Optional[float] = None,
) -> fast_policy.FastDecision:
    """Numpy oracle of :func:`ga_decide` on the same draws: selection,
    crossover, mutation and repair as plain numpy, one chromosome at a
    time; fitness through ``policy.finish_host`` (scalar f64 KKT)."""
    u, c = rates.shape
    assert c >= 2, "population search needs at least two channels"
    _check_draws(draws, u, c, cfg)
    dr = {k: v.cpu().numpy() for k, v in vars(draws).items()}
    pop = [random_assignment_host(int(dr["n_sched"][i]), dr["perm_u"][i],
                                  dr["perm_c"][i], c)
           for i in range(cfg.population)]
    n_child = cfg.population - cfg.elitism
    n_pairs = (n_child + 1) // 2

    def eval_one(assign: np.ndarray) -> tuple[fast_policy.FastDecision, float]:
        fd = fast_policy.finish_host(
            assign, rates, d_sizes, g_sq, sigma_sq, theta_max, lam2, sysp,
            z, v_weight, q_cap=q_cap, hetero=hetero, dl_term=dl_term,
        )
        j0 = _j0_host(fd, lam1, lam2, v_weight)
        if not cfg.repair_infeasible:
            a0 = np.isin(np.arange(u), assign[assign >= 0])
            if np.any(a0 & (fd.a == 0)):
                j0 = J0_INFEASIBLE
        return fd, j0

    best_assign = np.full(c, -1, dtype=np.int64)
    best_j0 = J0_INFEASIBLE
    for g in range(cfg.generations):
        j0 = np.empty(len(pop))
        for i, ch in enumerate(pop):
            _fd, j0[i] = eval_one(ch)
        i_star = int(np.argmin(j0))                              # ties -> first
        if j0[i_star] < best_j0:
            best_assign, best_j0 = pop[i_star].copy(), float(j0[i_star])

        cand = dr["cand"][g]
        do_cx = dr["u_cx"][g] < cfg.p_crossover
        pt = dr["pt"][g]
        mut_mask = dr["u_mut"][g] < cfg.p_mutation
        mut_val = dr["mut_val"][g]
        children: list[np.ndarray] = []
        for pair in range(n_pairs):
            wins = np.argmin(j0[cand[pair]], axis=-1)            # (2,)
            p1 = pop[int(cand[pair, 0, wins[0]])]
            p2 = pop[int(cand[pair, 1, wins[1]])]
            if do_cx[pair]:
                cut = np.arange(c) < pt[pair]
                c1 = repair_duplicates_host(np.where(cut, p1, p2))
                c2 = repair_duplicates_host(np.where(cut, p2, p1))
            else:
                c1, c2 = p1.copy(), p2.copy()
            children.extend([c1, c2])
        children = [
            repair_duplicates_host(np.where(mut_mask[i], mut_val[i], ch))
            for i, ch in enumerate(children[:n_child])
        ]
        elites = [pop[i].copy() for i in np.argsort(j0, kind="stable")[: cfg.elitism]]
        pop = elites + children

    fd, _ = eval_one(best_assign)
    return fd


# -------------------------------------------------- host Policy adapter

class HostGAPolicy:
    """:func:`run_ga_host` as a Policy on the engine's draws: the host GA
    controller that ``FleetSim.run_host_policy`` replays against the
    ``compiled-ga`` run. The engine hands it each round's draws through
    :meth:`set_round_draws` (the same record ``ga_decide`` consumes);
    driving it outside the engine requires setting them every round."""

    name = "host_ga"

    def __init__(self, sysp: SystemParams, eps1: float, eps2: float,
                 v_weight: float, cfg: GAConfig = GAConfig(),
                 q_cap: int = 8, hetero: Optional[np.ndarray] = None) -> None:
        self.sysp = sysp
        self.eps1, self.eps2 = float(eps1), float(eps2)
        self.v_weight = float(v_weight)
        self.cfg = cfg
        self.q_cap = int(q_cap)
        self.hetero = None if hetero is None else np.asarray(hetero, np.float64)
        self.lambda1 = 0.0
        self.lambda2 = 0.0
        self._draws: Optional[GADraws] = None
        self.dl_term: Optional[float] = None

    def set_round_draws(self, draws: GADraws) -> None:
        self._draws = draws

    def set_downlink_term(self, dl_term) -> None:
        """Engine hook: last round's realized downlink bound term (see
        ``policy.HostFastPolicy.set_downlink_term``)."""
        self.dl_term = dl_term

    def decide(self, ctx) -> Decision:
        assert self._draws is not None, "set_round_draws before decide"
        draws, self._draws = self._draws, None
        fd = run_ga_host(
            draws, np.asarray(ctx.rates), np.asarray(ctx.d_sizes),
            np.asarray(ctx.g_sq), np.asarray(ctx.sigma_sq),
            np.asarray(ctx.theta_max), self.lambda1, self.lambda2,
            self.sysp, ctx.z, self.v_weight, cfg=self.cfg, q_cap=self.q_cap,
            hetero=self.hetero, dl_term=self.dl_term,
        )
        dec = Decision(
            assign=fd.assign, a=fd.a, q=fd.q, f=fd.f, energy=fd.energy,
            latency=fd.latency,
            j0=_j0_host(fd, self.lambda1, self.lambda2, self.v_weight),
            data_term=float(fd.data_term), quant_term=float(fd.quant_term),
            feasible=True,
        )
        # telemetry taps for run_host_policy's rows: the scalar solver's
        # clipped q_hat, and the search's best J0 (the host loop keeps no
        # per-generation population median)
        dec.q_cont = fd.q_cont
        dec.ga_best = dec.j0
        return dec

    def commit(self, dec) -> None:
        self.lambda1 = max(self.lambda1 + dec.data_term - self.eps1, 0.0)
        self.lambda2 = max(self.lambda2 + dec.quant_term - self.eps2, 0.0)
