"""Device decisions of the fleet round (the port of ``repro.sim.policy``).

The greedy path:

  1. greedy channel assignment: iterated global argmax over the (U, C)
     rate matrix, masking the chosen row and column each step;
  2. infeasibility drop: clients that cannot meet T_max even at q = 1 are
     unscheduled;
  3. the 5-case KKT walk of ``repro_torch.core.kkt.solve_continuous``,
     vectorised over U in fp32 (Case 2 by the closed-form depressed cubic,
     Case 5 by 80 bisection halvings, a 512-point grid fallback), then
     Theorem-3 integerization clamped to ``q_cap``.

Steps 2-3 (``finish_decision``) take any assignment, or a (P, C)
population of them along a leading axis: the GA's fitness
(``repro_torch.sim.search``) evaluates a whole population in one pass.
``realized_terms`` recomputes the bound terms at the participation a round
with fault injection realized (its queue feedback). The paper's
closed-form baselines (``baseline_no_quant``, ``baseline_channel_allocate``,
``baseline_principle``, accounted by ``account_baseline``) follow. Every expression keeps the JAX module's
operation order, so the same fp32 rates give the same schedule and levels.
The numpy oracles: ``greedy_assign_host``, ``compact_slots_host``,
``finish_host``, ``decide_host`` and the ``HostFastPolicy`` Policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import bounds, kkt
from repro_torch.core.genetic import Decision, SystemParams
from repro_torch.kernels.stochastic_quant import levels_of
from repro_torch.obs.profile import scope as _profile_scope

LN2 = math.log(2.0)
RANGE_BITS = 32.0


# ------------------------------------------------------------- assignment

def greedy_assign(rates: torch.Tensor) -> torch.Tensor:
    """(U, C) rates -> (C,) channel->client ids (-1 = unused), on the
    device with no host round trip. One profiler range over all C steps."""
    u, c = rates.shape
    dev = rates.device
    with _profile_scope("greedy_assign"):
        assign = torch.full((c,), -1, dtype=torch.int64, device=dev)
        row_free = torch.ones((u,), dtype=torch.bool, device=dev)
        col_free = torch.ones((c,), dtype=torch.bool, device=dev)
        neg_inf = torch.tensor(-math.inf, dtype=rates.dtype, device=dev)
        for _ in range(min(u, c)):
            masked = torch.where(row_free[:, None] & col_free[None, :], rates, neg_inf)
            flat = torch.argmax(masked).reshape(1)   # first maximum, row-major
            i, ch = flat // c, flat % c
            assign.index_copy_(0, ch, i)
            row_free.index_fill_(0, i, False)
            col_free.index_fill_(0, ch, False)
        return assign


def greedy_assign_host(rates: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`greedy_assign` (identical tie-breaking)."""
    rates = np.asarray(rates)
    u, c = rates.shape
    assign = np.full(c, -1, dtype=np.int64)
    row_free = np.ones(u, bool)
    col_free = np.ones(c, bool)
    for _ in range(min(u, c)):
        masked = np.where(row_free[:, None] & col_free[None, :], rates, -np.inf)
        i, ch = divmod(int(masked.argmax()), c)
        assign[ch] = i
        row_free[i] = False
        col_free[ch] = False
    return assign


# ------------------------------------------------------- vectorized KKT

@dataclasses.dataclass
class FastDecision:
    """Tensors-only decision record."""

    assign: Any        # (C,) channel -> client
    slots: Any         # (S,) scheduled-slot client ids, -1 padded; S = min(U, C)
    a: Any             # (U,) participation {0,1}
    q: Any             # (U,) integer levels (0 if out)
    f: Any             # (U,) CPU frequency (0 if out)
    v_assigned: Any    # (U,) assigned uplink rate (0 if out)
    energy: Any        # (U,)
    latency: Any       # (U,)
    data_term: Any     # scalar
    quant_term: Any    # scalar
    payload_bits: Any  # scalar
    q_cont: Any        # (U,) continuous clipped q_hat before integerization


def compact_slots(assign: torch.Tensor, n_clients: int) -> torch.Tensor:
    """(..., C) kept assignment -> fixed-width (..., S) scheduled-slot
    client ids: assigned channels first in ascending channel order (a
    stable sort of the emptiness mask), then -1 padding."""
    s = min(n_clients, int(assign.shape[-1]))
    order = torch.argsort((assign < 0).to(torch.int32), dim=-1, stable=True)
    return torch.take_along_dim(assign, order[..., :s], dim=-1)


def compact_slots_host(assign: np.ndarray, n_clients: int) -> np.ndarray:
    """Numpy mirror of :func:`compact_slots` (same slot order)."""
    assign = np.asarray(assign)
    s = min(n_clients, assign.shape[0])
    order = np.argsort(assign < 0, kind="stable")
    return assign[order[:s]].astype(np.int64)


def _s_of_q(v, d, q, sysp: SystemParams, z: int):
    """Latency-tight frequency S(q), inf when the deadline is unmeetable."""
    slack = v * sysp.t_max - (z * q + z + RANGE_BITS)
    f_req = v * sysp.tau_e * sysp.gamma * d / torch.clamp(slack, min=1e-30)
    return torch.where(slack > 0, torch.clamp(f_req, min=sysp.f_min),
                       torch.full_like(f_req, math.inf))


def _latency(v, d, f, q, sysp: SystemParams, z: int):
    return sysp.tau_e * sysp.gamma * d / f + (z * q + z + RANGE_BITS) / v


def _j3(v, w, d, theta, lam, q, f, sysp: SystemParams, z: int, v_weight: float):
    levels = torch.pow(2.0, q) - 1.0
    quant = lam * w * z * sysp.lipschitz * theta**2 / (8.0 * levels**2)
    cmp_e = v_weight * sysp.tau_e * sysp.alpha * sysp.gamma * d * f**2
    com_e = sysp.p_tx * v_weight * z * q / v
    return quant + cmp_e + com_e


def _g_of_q(q, lam, w, theta, sysp: SystemParams):
    """G(q) = 2^q ln2 lam w L theta^2 / (4 (2^q - 1)^3), 0 past q = 60
    (fp32 overflow guard, as in the JAX module)."""
    y = torch.pow(2.0, torch.clamp(q, max=60.0))
    g = y * LN2 * lam * w * sysp.lipschitz * theta**2 / (
        4.0 * torch.clamp(y - 1.0, min=1e-30) ** 3
    )
    return torch.where(q > 60.0, torch.zeros_like(g), g)


def _cbrt(x):
    """Real cube root; torch has no cbrt and ``x ** (1/3)`` is NaN for x < 0."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _case2_cubic(a4):
    """Largest positive real root of y^3 - A4 y - A4 = 0, both branches
    (Cardano where the discriminant is nonnegative, else trigonometric)."""
    a4 = torch.clamp(a4, min=1e-30)
    disc = a4**2 / 4.0 - a4**3 / 27.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    y_card = _cbrt(a4 / 2.0 + sq) + _cbrt(a4 / 2.0 - sq)
    arg = torch.clamp(1.5 * torch.sqrt(3.0 / a4), -1.0, 1.0)
    y_trig = 2.0 * torch.sqrt(a4 / 3.0) * torch.cos(torch.arccos(arg) / 3.0)
    return torch.where(disc >= 0.0, y_card, y_trig)


def solve_kkt(
    v: torch.Tensor,       # (U,) assigned uplink rate
    w: torch.Tensor,       # (U,) round weights a_i D_i / D^n
    d: torch.Tensor,       # (U,) dataset sizes
    theta: torch.Tensor,   # (U,) theta_max
    lam: torch.Tensor,     # scalar (lambda2 - eps2_for_kkt)
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int = 8,
    grid_n: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised eq. 41/42: returns (q int, f, feasible, q_cont) per
    client, walking the host solver's cases in its priority order (1, 2, 4,
    3, 5, grid fallback). Elementwise, so ``v``, ``w``, ``d`` and ``theta``
    may carry a leading population axis, (P, U)."""
    p, V = sysp.p_tx, v_weight
    L = sysp.lipschitz
    v_safe = torch.clamp(v, min=1e-6)

    qmax = (v_safe * sysp.t_max
            - sysp.tau_e * sysp.gamma * d * v_safe / sysp.f_max
            - z - RANGE_BITS) / z
    feasible = qmax >= 1.0

    # Case 1: C8' tight (q = 1).
    pre1 = p * V - 0.5 * v_safe * w * L * lam * theta**2 * LN2 >= 0.0
    f1 = _s_of_q(v_safe, d, 1.0, sysp, z)
    ok1 = pre1 & (f1 <= sysp.f_max)

    # Case 2: latency loose, f = f_min, q from the depressed cubic.
    a4 = v_safe * w * L * lam * theta**2 * LN2 / (4.0 * p * V)
    q2 = torch.log2(1.0 + _case2_cubic(a4))
    ok2 = (a4 > 0.0) & (q2 > 1.0) & (
        _latency(v_safe, d, sysp.f_min, q2, sysp, z) < sysp.t_max
    )

    # Cases 4/3: latency tight, f pinned at a bound (host checks 4 first).
    def pinned(f_pin):
        slack = v_safe * sysp.t_max - v_safe * sysp.tau_e * sysp.gamma * d / f_pin
        q_pin = (slack - z - RANGE_BITS) / z
        kappa1 = v_safe * _g_of_q(q_pin, lam, w, theta, sysp) - p * V
        return q_pin, kappa1

    q4, kap4 = pinned(sysp.f_min)
    ok4 = (q4 > 1.0) & (kap4 >= 0.0) & (kap4 <= 2.0 * V * sysp.alpha * sysp.f_min**3)
    q3, kap3 = pinned(sysp.f_max)
    ok3 = (q3 > 1.0) & (kap3 >= 0.0) & (kap3 >= 2.0 * V * sysp.alpha * sysp.f_max**3)

    # Case 5: interior — bisection on h(q) over (1, qmax), 80 halvings.
    def h_of(q):
        den = torch.clamp(v_safe * sysp.t_max - (z * q + z + RANGE_BITS), min=1e-30)
        f = v_safe * sysp.tau_e * sysp.gamma * d / den
        return (v_safe * _g_of_q(q, lam, w, theta, sysp) / V
                - p - 2.0 * sysp.alpha * f**3)

    lo = torch.full_like(v_safe, 1.0 + 1e-9)
    hi0 = qmax - 1e-9
    bracket = (lam > 0.0) & (qmax > 1.0) & (hi0 > lo) \
        & (h_of(lo) >= 0.0) & (h_of(hi0) <= 0.0)
    hi = torch.maximum(hi0, lo)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        up = h_of(mid) > 0.0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    q5 = 0.5 * (lo + hi)
    f5 = _s_of_q(v_safe, d, q5, sysp, z)
    ok5 = bracket & (q5 > 1.0) & (sysp.f_min < f5) & (f5 < sysp.f_max)

    # Fallback: dense grid over feasible q. The points are iota * (1/(n-1))
    # in fp32, which is what jnp.linspace computes; torch.linspace differs
    # in the last ulp of some points, enough to move a grid argmin.
    span = torch.clamp(qmax, min=1.0) - 1.0
    unit = torch.arange(grid_n, dtype=torch.float32, device=v.device) * (1.0 / (grid_n - 1))
    qs = 1.0 + span[..., None] * unit                                     # (..., U, G)
    fs = _s_of_q(v_safe[..., None], d[..., None], qs, sysp, z)
    js = torch.where(
        fs <= sysp.f_max,
        _j3(v_safe[..., None], w[..., None], d[..., None], theta[..., None],
            lam, qs, fs, sysp, z, v_weight),
        torch.full_like(fs, math.inf),
    )
    q0 = torch.take_along_dim(qs, torch.argmin(js, dim=-1)[..., None], dim=-1)[..., 0]

    # Priority select (host order: 1, 2, 4, 3, 5, fallback).
    q_hat = q0
    q_hat = torch.where(ok5, q5, q_hat)
    q_hat = torch.where(ok3, q3, q_hat)
    q_hat = torch.where(ok4, q4, q_hat)
    q_hat = torch.where(ok2, q2, q_hat)
    q_hat = torch.where(ok1, torch.ones_like(q_hat), q_hat)

    # Theorem 3 integerization, clamped to the wire format's q_cap.
    q_hat = torch.clamp(q_hat, 1.0, float(q_cap))
    q_lo = torch.clamp(torch.floor(q_hat), min=1.0)
    q_hi = torch.clamp(torch.ceil(q_hat), min=1.0)

    def j_of(qq):
        f = _s_of_q(v_safe, d, qq, sysp, z)
        # fp32 tolerance: q at the exact qmax boundary gives f == f_max up
        # to rounding (the f64 host solver accepts it); clamp back into C5.
        ok = (f <= sysp.f_max * (1.0 + 1e-5))
        f = torch.clamp(f, max=sysp.f_max)
        lat = _latency(v_safe, d, f, qq, sysp, z)
        ok = ok & (lat <= sysp.t_max * (1.0 + 1e-5))
        j = _j3(v_safe, w, d, theta, lam, qq, f, sysp, z, v_weight)
        return torch.where(ok, j, torch.full_like(j, math.inf)), f

    j_lo, f_lo = j_of(q_lo)
    j_hi, f_hi = j_of(q_hi)
    take_hi = j_hi < j_lo  # ties keep floor, as the host's sorted scan does
    q_int = torch.where(take_hi, q_hi, q_lo)
    f_int = torch.where(take_hi, f_hi, f_lo)
    feasible = feasible & torch.isfinite(torch.where(take_hi, j_hi, j_lo))
    return q_int.to(torch.int64), f_int, feasible, q_hat


# --------------------------------------------------------- bound terms

def data_term(consts, a, w_full, w_round, g_sq, sigma_sq, hetero=None):
    """Eq. 20; ``hetero`` scales only the scheduling-exclusion component."""
    g_sched = g_sq if hetero is None else g_sq * hetero
    sched = 4.0 * consts.tau * torch.sum((1.0 - a * w_full) * g_sched, dim=-1)
    drift = (consts.a1 * torch.sum(w_round * g_sq, dim=-1)
             + consts.a2 * torch.sum(w_round * sigma_sq, dim=-1))
    return sched + drift


def quant_term(consts, w_round, z, theta_max, q):
    """Eq. 21 at integer levels ``q``."""
    levels = torch.clamp(levels_of(q), min=1e-12)
    per_client = z * theta_max**2 / (4.0 * levels**2)
    return consts.lipschitz / 2.0 * torch.sum(w_round * per_client, dim=-1)


def realized_terms(a_real, d_sizes, g_sq, sigma_sq, theta_max, q, sysp: SystemParams,
                   z: int, hetero=None, dl_term=None):
    """Eq. 20/21 at the *realized* (post-screen) participation ``a_real``:
    the queue feedback of a round with fault injection. A scheduled client
    that failed re-enters the scheduling-exclusion sum and leaves the round
    weights, like an unscheduled one; with nothing failed this gives
    ``finish_decision``'s terms (same ops, same order)."""
    af = a_real.to(torch.float32)
    d_n = torch.sum(af * d_sizes)
    w_round = torch.where(a_real > 0, af * d_sizes / torch.clamp(d_n, min=1e-12),
                          torch.zeros_like(d_sizes))
    w_full = d_sizes / torch.sum(d_sizes)
    consts = sysp.bound_constants()
    dt = data_term(consts, af, w_full, w_round, g_sq, sigma_sq, hetero)
    qt = quant_term(consts, w_round, z, theta_max, torch.clamp(q, min=1))
    if dl_term is not None:
        qt = qt + dl_term
    return dt, qt


# --------------------------------------------------------------- decide

def participation_from_assign(assign: torch.Tensor, rates: torch.Tensor):
    """(..., C) chromosomes -> ((..., U) assigned rate, (..., U) bool
    participation); a leading axis evaluates a population at once."""
    u = rates.shape[0]
    ids = torch.arange(u, device=rates.device)
    row = assign[..., None, :]                                   # (..., 1, C)
    onehot = (row == ids[:, None]) & (row >= 0)                  # (..., U, C)
    v_assigned = torch.sum(torch.where(onehot, rates, torch.zeros_like(rates)), dim=-1)
    return v_assigned, onehot.any(dim=-1)


def finish_decision(
    assign: torch.Tensor,      # (C,) channel -> client (-1 unused)
    v_assigned: torch.Tensor,  # (U,) assigned uplink rate
    a0: torch.Tensor,          # (U,) bool pre-drop participation
    d_sizes: torch.Tensor,     # (U,)
    g_sq: torch.Tensor,        # (U,) normalized G^2 estimates
    sigma_sq: torch.Tensor,    # (U,)
    theta_max: torch.Tensor,   # (U,)
    lam2: torch.Tensor,        # scalar lambda2 queue
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int = 8,
    hetero=None,
    dl_term=None,              # scalar: last round's realized downlink bound term
) -> FastDecision:
    """Infeasibility drop + vectorised KKT + bound terms for an assignment,
    or for a population of them along a leading axis of ``assign``,
    ``v_assigned`` and ``a0`` (the GA's batched fitness). ``dl_term`` (the
    quantized downlink's previous-round error term, ``None`` with the
    downlink off) is added to the quant term, so the lambda2 queue sees
    the server->client error; it is the same for every assignment. The
    terms before and after the KKT run in ``decision_terms`` profiler
    ranges, the KKT in its own ``kkt_solve`` range."""
    u = d_sizes.shape[0]
    with _profile_scope("decision_terms"):
        qmax = (v_assigned * sysp.t_max
                - sysp.tau_e * sysp.gamma * d_sizes * v_assigned / sysp.f_max
                - z - RANGE_BITS) / z
        a = a0 & (qmax >= 1.0)
        af = a.to(torch.float32)

        zero = torch.zeros_like(d_sizes)
        d_n = torch.sum(af * d_sizes, dim=-1)
        w_round = torch.where(a, af * d_sizes / torch.clamp(d_n, min=1e-12)[..., None], zero)
        w_full = d_sizes / torch.sum(d_sizes)

    with _profile_scope("kkt_solve"):
        q_int, f_int, feas, q_hat = solve_kkt(
            v_assigned, w_round, d_sizes, theta_max, lam2, sysp, z, v_weight,
            q_cap=q_cap,
        )
    with _profile_scope("decision_terms"):
        a = a & feas
        af = a.to(torch.float32)
        q = torch.where(a, q_int, torch.zeros_like(q_int))
        f = torch.where(a, f_int, zero)

        t_com = (z * q.to(torch.float32) + z + RANGE_BITS) / torch.clamp(v_assigned, min=1e-6)
        t_cmp = sysp.tau_e * sysp.gamma * d_sizes / torch.clamp(f, min=1.0)
        energy = torch.where(
            a,
            sysp.tau_e * sysp.alpha * sysp.gamma * d_sizes * f**2 + sysp.p_tx * t_com,
            zero,
        )
        latency = torch.where(a, t_cmp + t_com, zero)

        consts = sysp.bound_constants()
        dt = data_term(consts, af, w_full, w_round, g_sq, sigma_sq, hetero)
        qt = quant_term(consts, w_round, z, theta_max, torch.clamp(q, min=1))
        if dl_term is not None:
            qt = qt + dl_term
        payload = torch.sum(torch.where(a, z * q.to(torch.float32) + z + RANGE_BITS, zero),
                            dim=-1)
        # drop the channels of clients that failed the feasibility gate
        kept = (assign >= 0) & torch.gather(a, -1, torch.clamp(assign, 0, u - 1))
        assign_kept = torch.where(kept, assign, torch.full_like(assign, -1))
        return FastDecision(
            assign=assign_kept, slots=compact_slots(assign_kept, u),
            a=a.to(torch.int64), q=q, f=f,
            v_assigned=torch.where(a, v_assigned, zero), energy=energy,
            latency=latency, data_term=dt, quant_term=qt, payload_bits=payload,
            q_cont=q_hat,
        )


def decide(
    rates: torch.Tensor,       # (U, C)
    d_sizes: torch.Tensor,     # (U,)
    g_sq: torch.Tensor,        # (U,) normalized G^2 estimates
    sigma_sq: torch.Tensor,    # (U,)
    theta_max: torch.Tensor,   # (U,)
    lam2: torch.Tensor,        # scalar lambda2 queue
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int = 8,
    hetero=None,
    dl_term=None,
) -> FastDecision:
    """One decision round: greedy channels, then :func:`finish_decision`."""
    assign = greedy_assign(rates)
    with _profile_scope("decision_terms"):
        v_assigned, a0 = participation_from_assign(assign, rates)
    return finish_decision(
        assign, v_assigned, a0, d_sizes, g_sq, sigma_sq, theta_max, lam2,
        sysp, z, v_weight, q_cap=q_cap, hetero=hetero, dl_term=dl_term,
    )


# ------------------------------------------------------------ host oracles

def finish_host(
    assign: np.ndarray,
    rates: np.ndarray,
    d_sizes: np.ndarray,
    g_sq: np.ndarray,
    sigma_sq: np.ndarray,
    theta_max: np.ndarray,
    lam2: float,
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int = 8,
    hetero: np.ndarray | None = None,
    dl_term: float | None = None,
) -> FastDecision:
    """Numpy mirror of :func:`finish_decision` for ANY assignment: the
    per-client solve goes through the scalar ``repro_torch.core.kkt``.
    Shared by :func:`decide_host` and the host GA oracle
    (``repro_torch.sim.search.run_ga_host``)."""
    u = rates.shape[0]
    v_assigned = np.zeros(u)
    for ch, cid in enumerate(assign):
        if cid >= 0:
            v_assigned[cid] += rates[cid, ch]
    a = v_assigned > 0

    def env_for(i, w):
        return kkt.ClientEnv(
            v=float(v_assigned[i]), w=float(w), d_size=float(d_sizes[i]),
            z=z, theta_max=float(theta_max[i]), lambda2=float(lam2), eps2=0.0,
            v_weight=v_weight, p=sysp.p_tx, alpha=sysp.alpha, gamma=sysp.gamma,
            tau_e=sysp.tau_e, t_max=sysp.t_max, f_min=sysp.f_min,
            f_max=sysp.f_max, lipschitz=sysp.lipschitz,
        )

    for i in range(u):
        if a[i] and kkt.q_max_feasible(env_for(i, 0.0)) < 1.0:
            a[i] = False
    d_n = float(np.sum(a * d_sizes))
    w_round = np.where(a, a * d_sizes / max(d_n, 1e-12), 0.0)
    w_full = d_sizes / np.sum(d_sizes)

    q = np.zeros(u, np.int64)
    f = np.zeros(u)
    energy = np.zeros(u)
    latency = np.zeros(u)
    q_cont = np.zeros(u)
    for i in range(u):
        if not a[i]:
            continue
        env = env_for(i, w_round[i])
        q_hat, _f_hat, case = kkt.solve_continuous(env)
        assert case != -1, "feasibility pre-filtered above"
        q_cont[i] = float(np.clip(q_hat, 1.0, q_cap))
        dec = kkt.integerize(env, q_cont[i])
        assert dec is not None
        q[i], f[i] = dec.q, dec.f
        energy[i] = dec.energy
        latency[i] = dec.latency

    consts = sysp.bound_constants()
    af = a.astype(np.float64)
    dt = bounds.data_term(consts, af, w_full, w_round, g_sq, sigma_sq, hetero)
    qt = bounds.quant_term(consts, w_round, z, theta_max, np.maximum(q, 1))
    if dl_term is not None:
        qt = qt + float(dl_term)
    payload = float(np.sum(np.where(a, z * q + z + RANGE_BITS, 0.0)))
    assign_kept = np.where((assign >= 0) & a[np.clip(assign, 0, u - 1)], assign, -1)
    return FastDecision(
        assign=assign_kept, slots=compact_slots_host(assign_kept, u),
        a=a.astype(np.int64), q=q, f=f,
        v_assigned=np.where(a, v_assigned, 0.0), energy=energy,
        latency=latency, data_term=dt, quant_term=qt, payload_bits=payload,
        q_cont=q_cont,
    )


def decide_host(
    rates: np.ndarray,
    d_sizes: np.ndarray,
    g_sq: np.ndarray,
    sigma_sq: np.ndarray,
    theta_max: np.ndarray,
    lam2: float,
    sysp: SystemParams,
    z: int,
    v_weight: float,
    q_cap: int = 8,
    hetero: np.ndarray | None = None,
    dl_term: float | None = None,
) -> FastDecision:
    """Numpy oracle for :func:`decide`: greedy assignment + scalar KKT."""
    return finish_host(
        greedy_assign_host(rates), rates, d_sizes, g_sq, sigma_sq, theta_max,
        lam2, sysp, z, v_weight, q_cap=q_cap, hetero=hetero, dl_term=dl_term,
    )


class HostFastPolicy:
    """The greedy path as a host-side Policy: greedy channels + scalar
    ``core.kkt`` per client + sound-form Lyapunov queues, the numpy oracle
    that ``FleetSim.run_host_policy`` replays against the greedy
    ``run_compiled``."""

    name = "greedy_kkt"

    def __init__(self, sysp: SystemParams, eps1: float, eps2: float,
                 v_weight: float, q_cap: int = 8, hetero=None) -> None:
        self.sysp = sysp
        self.eps1, self.eps2 = float(eps1), float(eps2)
        self.v_weight = float(v_weight)
        self.q_cap = int(q_cap)
        self.hetero = None if hetero is None else np.asarray(hetero, np.float64)
        self.lambda1 = 0.0
        self.lambda2 = 0.0
        self.dl_term = None

    def set_downlink_term(self, dl_term) -> None:
        """Engine hook (``run_host_policy``): last round's realized downlink
        bound term, added to this round's quant term as the compiled round
        does."""
        self.dl_term = dl_term

    def decide(self, ctx) -> Decision:
        fd = decide_host(
            ctx.rates, ctx.d_sizes, ctx.g_sq, ctx.sigma_sq, ctx.theta_max,
            self.lambda2, self.sysp, ctx.z, self.v_weight, q_cap=self.q_cap,
            hetero=self.hetero, dl_term=self.dl_term,
        )
        dec = Decision(
            assign=fd.assign, a=fd.a, q=fd.q, f=fd.f, energy=fd.energy,
            latency=fd.latency, j0=0.0, data_term=float(fd.data_term),
            quant_term=float(fd.quant_term), feasible=True,
        )
        # the scalar solver's clipped q_hat rides along (Decision is a plain
        # dataclass), as in the JAX package
        dec.q_cont = fd.q_cont
        return dec

    def commit(self, dec) -> None:
        self.lambda1 = max(self.lambda1 + dec.data_term - self.eps1, 0.0)
        self.lambda2 = max(self.lambda2 + dec.quant_term - self.eps2, 0.0)


# ---------------------------------------------------- the paper's baselines
#
# The Sec.-VI baselines (repro_torch.fl.baselines) as device decision
# functions. Accounting mirrors ``fl.baselines._energies`` and the wire
# clamp of ``FleetSim.run_host_policy``:
#
#   * energy, latency and the bound terms are computed at the policy's RAW
#     q (e.g. q = 32 for NoQuant) on the pre-timeout participation: clients
#     that time out still burn their energy;
#   * the ``q`` field, the slots and the payload are clamped into the wire
#     format (``q_cap``), as run_host_policy executes and records;
#   * the baselines are heterogeneity-blind, like their host counterparts.
#
# ``same_size`` needs the GA and so lives in ``repro_torch.sim.search``.

def account_baseline(
    assign: torch.Tensor,     # (C,) channel -> client (-1 unused)
    rates: torch.Tensor,      # (U, C)
    d_sizes: torch.Tensor,
    g_sq: torch.Tensor,
    sigma_sq: torch.Tensor,
    theta_max: torch.Tensor,
    q_raw: torch.Tensor,      # (U,) the policy's levels, float, unclamped
    f: torch.Tensor,          # (U,) chosen CPU frequency
    sysp: SystemParams,
    z: int,
    q_cap: int,
    drop_late: bool = False,
    late_tol: float = 1.0,    # drop when latency > t_max * late_tol
) -> FastDecision:
    """Mirror of ``fl.baselines._energies`` (plus the latency-timeout drop
    of PrinciplePolicy/SameSizePolicy) as a FastDecision the round can
    execute."""
    u = d_sizes.shape[0]
    v_assigned, a0 = participation_from_assign(assign, rates)
    af0 = a0.to(torch.float32)
    v_safe = torch.clamp(v_assigned, min=1e-6)
    zero = torch.zeros_like(d_sizes)

    bits = z * q_raw + z + RANGE_BITS
    t_com = bits / v_safe
    t_cmp = sysp.tau_e * sysp.gamma * d_sizes / torch.clamp(f, min=1.0)
    energy = torch.where(
        a0,
        sysp.tau_e * sysp.alpha * sysp.gamma * d_sizes * f**2 + sysp.p_tx * t_com,
        zero,
    )
    latency = torch.where(a0, t_cmp + t_com, zero)

    d_n = torch.sum(af0 * d_sizes)
    w_round = torch.where(a0, af0 * d_sizes / torch.clamp(d_n, min=1e-12), zero)
    w_full = d_sizes / torch.sum(d_sizes)
    consts = sysp.bound_constants()
    dt = data_term(consts, af0, w_full, w_round, g_sq, sigma_sq)
    qt = quant_term(consts, w_round, z, theta_max, torch.clamp(q_raw, min=1.0))

    # PrinciplePolicy semantics: clients past the deadline drop out of the
    # aggregation AFTER the terms above were accounted: their energy stays
    # spent and their latency stays on the record.
    a = a0 & ~(latency > sysp.t_max * late_tol) if drop_late else a0

    # wire clamp, as run_host_policy applies to host decisions
    ai = a.to(torch.int64)
    q_wire = torch.clamp(q_raw.to(torch.int64), 1, q_cap) * ai
    payload = torch.sum(torch.where(
        a, z * torch.clamp(q_wire, min=1).to(torch.float32) + z + RANGE_BITS, zero))
    kept = (assign >= 0) & a[torch.clamp(assign, 0, u - 1)]
    assign_kept = torch.where(kept, assign, torch.full_like(assign, -1))
    # run_host_policy records latency 0 when nothing was scheduled at all
    latency = torch.where(torch.any(a), latency, zero)
    return FastDecision(
        assign=assign_kept, slots=compact_slots(assign_kept, u),
        a=ai, q=q_wire, f=torch.where(a0, f, zero),
        v_assigned=torch.where(a0, v_assigned, zero), energy=energy,
        latency=latency, data_term=dt, quant_term=qt, payload_bits=payload,
        q_cont=q_raw,
    )


def baseline_no_quant(rates, d_sizes, g_sq, sigma_sq, theta_max,
                      sysp: SystemParams, z: int, q_cap: int) -> FastDecision:
    """``fl.baselines.NoQuantPolicy``: fp32 uploads (q = 32), f = f_max to
    race the deadline."""
    assign = greedy_assign(rates)
    q = torch.full_like(d_sizes, 32.0)
    f = torch.full_like(d_sizes, sysp.f_max)
    return account_baseline(assign, rates, d_sizes, g_sq, sigma_sq, theta_max,
                            q, f, sysp, z, q_cap)


def baseline_channel_allocate(rates, d_sizes, g_sq, sigma_sq, theta_max,
                              sysp: SystemParams, z: int, q_cap: int,
                              q_policy_cap: int = 16) -> FastDecision:
    """``fl.baselines.ChannelAllocatePolicy``: greedy channels, the largest
    q that fits T_max at f_max, then f relaxed to the latency boundary:
    channel-adaptive, training-oblivious."""
    sp = sysp
    assign = greedy_assign(rates)
    v_assigned, a0 = participation_from_assign(assign, rates)
    v_safe = torch.clamp(v_assigned, min=1e-6)
    t_cmp = sp.tau_e * sp.gamma * d_sizes / sp.f_max
    budget_bits = v_safe * (sp.t_max - t_cmp)
    q_i = torch.floor((budget_bits - z - RANGE_BITS) / z)
    q = torch.where(a0, torch.clamp(q_i, 1.0, float(q_policy_cap)), torch.ones_like(q_i))
    env_bits = z * q + z + RANGE_BITS
    slack = sp.t_max - env_bits / v_safe
    f_req = sp.tau_e * sp.gamma * d_sizes / torch.clamp(slack, min=1e-30)
    f = torch.where(a0 & (slack > 0), torch.clamp(f_req, sp.f_min, sp.f_max),
                    torch.full_like(f_req, sp.f_max))
    return account_baseline(assign, rates, d_sizes, g_sq, sigma_sq, theta_max,
                            q, f, sysp, z, q_cap)


def baseline_principle(round_idx: int, rates, d_sizes, g_sq, sigma_sq, theta_max,
                       sysp: SystemParams, z: int, q_cap: int, q0: float = 2.0,
                       double_every: int = 30, q_policy_cap: int = 16) -> FastDecision:
    """``fl.baselines.PrinciplePolicy`` (DAdaQuant-flavoured [24]): q
    doubles on a fixed round schedule and scales with dataset size, no
    wireless awareness: f pinned at f_max, deadline-missers time out.
    ``round_idx`` is the run's round (the host policy's counter)."""
    assign = greedy_assign(rates)
    base = q0 * 2.0 ** (int(round_idx) // double_every)
    size_scale = d_sizes / torch.mean(d_sizes)
    q = torch.clamp(torch.round(base * size_scale), 1.0, float(q_policy_cap))
    f = torch.full_like(d_sizes, sysp.f_max)
    return account_baseline(assign, rates, d_sizes, g_sq, sigma_sq, theta_max,
                            q, f, sysp, z, q_cap, drop_late=True)
