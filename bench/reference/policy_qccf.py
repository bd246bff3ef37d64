"""The QCCF decision of one round (the paper's Sec. V with greedy channels),
in float64 numpy.

1. Channels: repeated global argmax of the (U, C) rate matrix, each pick
   taking its client's row and its channel's column out.
2. A scheduled client that cannot upload at q = 1 within T_max even at
   f_max is dropped.
3. Per client, the integer level q in 1..q_cap and the CPU frequency f
   that minimise the drift-plus-penalty term of eq. 41,
       J(q, f) = lam2 w Z L theta^2 / (8 (2^q - 1)^2)
                 + V tau_e alpha gamma D f^2 + p V Z q / v,
   with f at its least value that meets T_max, max(f_min, f_req(q)), and
   f_req(q) <= f_max (within 1e-5, where f is clamped to f_max): every
   level is tried, so no case analysis is needed.
4. The bound terms of eq. 20 and 21 that feed the Lyapunov queues.

Judging another run (``follow``): where that run's pick and this one's are
equal to ``RATE_TIE`` (a channel) or ``J_TIE`` (a level), relative, the
other run's pick is taken, so a tie broken the other way by rounding does
not fork the two trajectories; the count of picks taken so is returned.
"""
from __future__ import annotations

import numpy as np

RANGE_BITS = 32.0
RATE_TIE = 1e-5     # fp32 rates carry ~1e-7 relative error
J_TIE = 1e-4        # J moves with theta^2 and lambda2, each ~1e-6 apart
FEAS_TOL = 1e-5     # the system's fp32 slack on f <= f_max and T <= T_max


def bound_constants(sysp: dict) -> tuple[float, float]:
    eta, tau, lip = sysp["eta"], sysp["tau"], sysp["lipschitz"]
    e2l2 = eta**2 * lip**2
    a1 = 2.0 * e2l2 * (2 * tau**3 - 3 * tau**2 + tau) / (3.0 - 6.0 * e2l2 * tau**2)
    a2 = eta * lip * tau + e2l2 * (tau**2 - tau) / (1.0 - 2.0 * e2l2 * tau**2)
    return a1, a2


def budgets(sysp: dict, d: np.ndarray, z: int, target_q: float) -> tuple[float, float]:
    """eps1, eps2: the bound terms of scheduling everyone at q = target_q
    with unit G^2, sigma^2 and theta."""
    a1, a2 = bound_constants(sysp)
    w = d / d.sum()
    eps1 = 4.0 * sysp["tau"] * np.sum(1.0 - w) + a1 + a2
    eps2 = sysp["lipschitz"] / 2.0 * np.sum(w * z / (4.0 * (2.0**target_q - 1.0) ** 2))
    return float(eps1), float(eps2)


def _greedy(rates: np.ndarray, v_follow) -> tuple[np.ndarray, int]:
    u, c = rates.shape
    masked = rates.copy()
    assign = np.full(c, -1, np.int64)
    pairs = []                       # the followed run's (rate, client, channel)
    if v_follow is not None:
        for i in np.flatnonzero(v_follow > 0):
            ch = int(np.argmin(np.abs(rates[i] - v_follow[i])))
            pairs.append((rates[i, ch], int(i), ch))
        pairs.sort(reverse=True)
    ties = 0
    for _ in range(min(u, c)):
        i, ch = divmod(int(np.argmax(masked)), c)
        best = masked[i, ch]
        if not np.isfinite(best):
            break
        while pairs and not np.isfinite(masked[pairs[0][1], pairs[0][2]]):
            pairs.pop(0)
        if pairs and (pairs[0][1], pairs[0][2]) != (i, ch) and pairs[0][0] >= best * (1 - RATE_TIE):
            _, i, ch = pairs.pop(0)
            ties += 1
        assign[ch] = i
        masked[i, :] = -np.inf
        masked[:, ch] = -np.inf
    return assign, ties


def decide(rates, d, g_n, s_n, theta, lam2, sysp, z, v_weight, q_cap, follow=None):
    """One round's decision. ``follow`` = (q, v) of the judged run's round
    or None. Returns a dict of (U,) arrays a, q, f, v, energy and the
    scalars data_term, quant_term, plus ``slots`` (client ids in channel
    order) and ``ties``."""
    u, _ = rates.shape
    assign, ties = _greedy(rates, None if follow is None else follow[1])
    v = np.zeros(u)
    for ch, i in enumerate(assign):
        if i >= 0:
            v[i] = rates[i, ch]
    t_cmp_max = sysp["tau_e"] * sysp["gamma"] * d / sysp["f_max"]
    with np.errstate(divide="ignore", invalid="ignore"):
        qmax = (v * sysp["t_max"] - t_cmp_max * v - z - RANGE_BITS) / z
    a = (v > 0) & (qmax >= 1.0)
    w = np.where(a, d, 0.0) / max(np.sum(np.where(a, d, 0.0)), 1e-12)

    qs = np.arange(1, q_cap + 1, dtype=np.float64)[None, :]          # (1, Q)
    vv, dd = np.maximum(v, 1e-6)[:, None], d[:, None]
    bits = z * qs + z + RANGE_BITS
    slack = vv * sysp["t_max"] - bits
    with np.errstate(divide="ignore", invalid="ignore"):
        f_req = np.where(slack > 0, vv * sysp["tau_e"] * sysp["gamma"] * dd / slack, np.inf)
    f = np.minimum(np.maximum(f_req, sysp["f_min"]), sysp["f_max"])
    lat = sysp["tau_e"] * sysp["gamma"] * dd / f + bits / vv
    ok = (f_req <= sysp["f_max"] * (1 + FEAS_TOL)) & (lat <= sysp["t_max"] * (1 + FEAS_TOL))
    levels = 2.0**qs - 1.0
    j = (lam2 * w[:, None] * z * sysp["lipschitz"] * theta[:, None] ** 2 / (8.0 * levels**2)
         + v_weight * sysp["tau_e"] * sysp["alpha"] * sysp["gamma"] * dd * f**2
         + sysp["p_tx"] * v_weight * z * qs / vv)
    j = np.where(ok, j, np.inf)
    k = np.argmin(j, axis=1)                       # the first minimum: ties keep the lower q
    rows = np.arange(u)
    if follow is not None:
        kf = np.clip(follow[0].astype(np.int64) - 1, 0, q_cap - 1)
        take = (a & (follow[0] > 0) & (kf != k)
                & (j[rows, kf] <= j[rows, k] + J_TIE * np.abs(j[rows, k])))
        ties += int(np.sum(take))
        k = np.where(take, kf, k)
    a = a & np.isfinite(j[rows, k])
    q = np.where(a, k + 1, 0)
    f_out = np.where(a, f[rows, k], 0.0)
    t_com = np.where(a, (z * q + z + RANGE_BITS) / np.maximum(v, 1e-6), 0.0)
    energy = np.where(a, sysp["tau_e"] * sysp["alpha"] * sysp["gamma"] * d * f_out**2
                      + sysp["p_tx"] * t_com, 0.0)

    af = a.astype(np.float64)
    w = af * d / max(np.sum(af * d), 1e-12)
    w_full = d / np.sum(d)
    a1, a2 = bound_constants(sysp)
    data_term = (4.0 * sysp["tau"] * np.sum((1.0 - af * w_full) * g_n)
                 + a1 * np.sum(w * g_n) + a2 * np.sum(w * s_n))
    quant_term = sysp["lipschitz"] / 2.0 * np.sum(
        w * z * theta**2 / (4.0 * (2.0 ** np.maximum(q, 1) - 1.0) ** 2))
    slots = np.array([i for i in assign if i >= 0 and a[i]], np.int64)
    return dict(a=a, q=q, f=f_out, v=np.where(a, v, 0.0), energy=energy,
                data_term=float(data_term), quant_term=float(quant_term),
                slots=slots, ties=ties)
