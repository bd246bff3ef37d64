"""Closed-form per-client solver for the continuous subproblem P3.2''.

Paper Sec. V-C. For a participating client with an assigned channel
(uplink rate v), the inner problem over (f, q) is

  min J3(f, q) = (lambda2 - eps2) * w * Z * L * theta_max^2 / (8 (2^q - 1)^2)
               + V * tau_e * alpha * gamma * D * f^2
               + p * V * Z * q / v
  s.t.  C4': tau_e * gamma * D / f + (Z q + Z + 32) / v <= T_max
        C5 :  f_min <= f <= f_max
        C8':  q >= 1

J3 is convex (separable, both second partials positive when
lambda2 > eps2). KKT conditions split into 5 complete, mutually exclusive
cases (eq. 34-40); the united solution is eq. 41, integerized by Theorem 3
(eq. 42): q* in {floor(q_hat), ceil(q_hat)} with f* = S(q*) the latency-
tight frequency, picking the smaller J3.

Stationarity identities used below (first principles, matching the paper):
  d J3 / d f = 2 V tau_e alpha gamma D f          (>0: smaller f is better,
                                                   bounded by latency -> Lemma 3)
  d J3 / d q = p V Z / v - Z * G(q)
      where G(q) = 2^q ln2 (lambda2-eps2) w L theta_max^2 / (4 (2^q-1)^3).
Case 2 stationarity  p V / v = G(q)  reduces with y = 2^q - 1 to the
depressed cubic  y^3 - A4 y - A4 = 0,
  A4 = v w L (lambda2 - eps2) theta_max^2 ln2 / (4 p V).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

LN2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class ClientEnv:
    """Everything the per-client solver needs for one round."""

    v: float           # uplink rate [bit/s] on the assigned channel(s)
    w: float           # aggregation weight w_i^n = D_i / D^n
    d_size: float      # dataset size D_i [samples]
    z: int             # model dimension Z
    theta_max: float   # |theta|_inf of the client's local model
    lambda2: float     # quantization-error queue
    eps2: float        # C7 budget
    v_weight: float    # Lyapunov penalty V
    p: float           # uplink transmit power [W]
    alpha: float       # CPU energy coefficient
    gamma: float       # cycles per sample
    tau_e: int         # local epochs
    t_max: float       # per-round latency budget [s]
    f_min: float
    f_max: float
    lipschitz: float   # L

    @property
    def lam(self) -> float:
        return self.lambda2 - self.eps2


@dataclasses.dataclass(frozen=True)
class ClientDecision:
    q: int              # integer quantization level (>= 1)
    f: float            # CPU frequency in [f_min, f_max]
    q_cont: float       # the continuous optimum q_hat (pre-Theorem-3)
    case: int           # which KKT case fired (1..5), 0 = fallback scan
    j3: float           # objective value at (q, f)
    e_cmp: float        # computation energy (eq. 17)
    e_com: float        # communication energy (eq. 15)
    t_cmp: float        # computation latency (eq. 16)
    t_com: float        # uplink latency (eq. 14)
    feasible: bool

    @property
    def energy(self) -> float:
        return self.e_cmp + self.e_com

    @property
    def latency(self) -> float:
        return self.t_cmp + self.t_com


def _payload_bits(env: ClientEnv, q: float) -> float:
    return env.z * q + env.z + 32.0


def latency(env: ClientEnv, f: float, q: float) -> float:
    return env.tau_e * env.gamma * env.d_size / f + _payload_bits(env, q) / env.v


def j3(env: ClientEnv, f: float, q: float) -> float:
    levels = 2.0**q - 1.0
    quant = env.lam * env.w * env.z * env.lipschitz * env.theta_max**2 / (8.0 * levels**2)
    cmp_e = env.v_weight * env.tau_e * env.alpha * env.gamma * env.d_size * f**2
    com_e = env.p * env.v_weight * env.z * q / env.v
    return quant + cmp_e + com_e


def optimal_frequency(env: ClientEnv, q: float) -> float:
    """S(q): lowest feasible frequency for a given q (latency-tight or f_min).

    J3 strictly increases in f, so the optimum sits at the latency boundary
    (Lemma 3 / Case 1 logic), clipped into C5.
    """
    slack = env.v * env.t_max - _payload_bits(env, q)
    if slack <= 0:
        return math.inf  # no frequency can meet the deadline at this q
    f_req = env.v * env.tau_e * env.gamma * env.d_size / slack
    return max(env.f_min, f_req)


def q_max_feasible(env: ClientEnv) -> float:
    """Largest (continuous) q such that some f in C5 meets the deadline."""
    slack = env.v * env.t_max - env.tau_e * env.gamma * env.d_size * env.v / env.f_max
    return (slack - env.z - 32.0) / env.z


def _g(env: ClientEnv, q: float) -> float:
    """G(q) = 2^q ln2 lam w L theta_max^2 / (4 (2^q-1)^3).

    G ~ 2^{-2q} for large q, so short-circuit to 0 well before ``2.0**q``
    overflows Python floats (small-Z models with fast channels reach
    q_pin in the hundreds in Cases 3/4).
    """
    if q > 128.0:
        return 0.0
    y = 2.0**q
    return y * LN2 * env.lam * env.w * env.lipschitz * env.theta_max**2 / (
        4.0 * (y - 1.0) ** 3
    )


def _solve_case2_cubic(env: ClientEnv) -> Optional[float]:
    """Solve y^3 - A4 y - A4 = 0 for the positive real root, q = log2(1+y).

    The paper writes the Cardano radical form (valid for A4 <= 27/4); we use
    numpy's companion-matrix root finder which covers the casus irreducibilis
    (A4 > 27/4, three real roots) as well — same root, no branch gymnastics.
    """
    a4 = env.v * env.w * env.lipschitz * env.lam * env.theta_max**2 * LN2 / (
        4.0 * env.p * env.v_weight
    )
    if a4 <= 0:
        return None
    roots = np.roots([1.0, 0.0, -a4, -a4])
    real = [float(r.real) for r in roots if abs(r.imag) < 1e-9 * max(1.0, abs(r))]
    pos = [r for r in real if r > 0]
    if not pos:
        return None
    return math.log2(1.0 + max(pos))


def cardano_case2(env: ClientEnv) -> Optional[float]:
    """The paper's literal Cardano expression (Case 2). Only valid when the
    discriminant term 1/4 - A4/27 is nonnegative; used in tests to check
    agreement with the robust root finder."""
    a4 = env.v * env.w * env.lipschitz * env.lam * env.theta_max**2 * LN2 / (
        4.0 * env.p * env.v_weight
    )
    if a4 <= 0:
        return None
    disc = 0.25 - a4 / 27.0
    if disc < 0:
        return None
    s = math.sqrt(disc)
    cbrt = lambda x: math.copysign(abs(x) ** (1.0 / 3.0), x)
    y = cbrt(a4) * (cbrt(0.5 + s) + cbrt(0.5 - s))
    return math.log2(1.0 + y)


def solve_continuous(env: ClientEnv) -> tuple[float, float, int]:
    """Return (q_hat, f_hat, case) for P3.2'' by walking the 5 KKT cases.

    Falls back to a fine grid scan (case 0) if no case's prerequisites hold
    (can happen at the feasibility boundary with float round-off).
    """
    qmax = q_max_feasible(env)
    if qmax < 1.0:
        return math.nan, math.nan, -1  # infeasible even at q=1

    # --- Case 1: C8' tight (q = 1). Pre1 (eq. 34):
    #     pV - v w L lam theta_max^2 ln2 / 2 >= 0
    #     (i.e. dJ3/dq >= 0 at q=1 including the boundary multiplier).
    pre1 = (
        env.p * env.v_weight
        - 0.5 * env.v * env.w * env.lipschitz * env.lam * env.theta_max**2 * LN2
        >= 0.0
    )
    if pre1:
        f1 = optimal_frequency(env, 1.0)
        if f1 <= env.f_max:
            return 1.0, f1, 1

    # --- Case 2: latency loose, f = f_min (Lemma 3), q from the cubic.
    q2 = _solve_case2_cubic(env)
    if q2 is not None and q2 > 1.0:
        lat = latency(env, env.f_min, q2)
        if lat < env.t_max and env.f_min <= env.f_max:
            return q2, env.f_min, 2

    # --- Cases 3/4: latency tight, f pinned at a bound.
    for case, f_pin in ((4, env.f_min), (3, env.f_max)):
        slack = env.v * env.t_max - env.v * env.tau_e * env.gamma * env.d_size / f_pin
        q_pin = (slack - env.z - 32.0) / env.z
        if q_pin <= 1.0:
            continue
        kappa1 = env.v * _g(env, q_pin) - env.p * env.v_weight
        if kappa1 < 0:
            continue
        if case == 3 and kappa1 >= 2.0 * env.v_weight * env.alpha * env.f_max**3:
            return q_pin, f_pin, 3
        if case == 4 and kappa1 <= 2.0 * env.v_weight * env.alpha * env.f_min**3:
            return q_pin, f_pin, 4

    # --- Case 5: interior. Latency tight, f = f(q) interior, q solves
    #     p + 2 alpha f(q)^3 = v G(q) / V        (eq. 38)
    q5 = _solve_case5(env, qmax)
    if q5 is not None:
        f5 = optimal_frequency(env, q5)
        if env.f_min < f5 < env.f_max and q5 > 1.0:
            return q5, f5, 5

    # --- Fallback: dense scan over feasible q (never the hot path).
    qs = np.linspace(1.0, max(qmax, 1.0), 512)
    best_q, best_f, best_j = 1.0, optimal_frequency(env, 1.0), math.inf
    for q in qs:
        f = optimal_frequency(env, float(q))
        if f > env.f_max:
            continue
        val = j3(env, f, float(q))
        if val < best_j:
            best_q, best_f, best_j = float(q), f, val
    return best_q, best_f, 0


def _solve_case5(env: ClientEnv, qmax: float) -> Optional[float]:
    """Bisection on h(q) = v G(q)/V - p - 2 alpha f(q)^3 over (1, qmax).

    h is strictly decreasing in q (G decreases, f(q) increases), so a sign
    change brackets the unique root.
    """
    if env.lam <= 0 or qmax <= 1.0:
        return None

    def h(q: float) -> float:
        f = env.v * env.tau_e * env.gamma * env.d_size / (
            env.v * env.t_max - _payload_bits(env, q)
        )
        return env.v * _g(env, q) / env.v_weight - env.p - 2.0 * env.alpha * f**3

    lo, hi = 1.0 + 1e-9, qmax - 1e-9
    if hi <= lo:
        return None
    if h(lo) < 0 or h(hi) > 0:
        return None
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if h(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def taylor_case5(env: ClientEnv, q_prev: float) -> float:
    """The paper's approximate Case-5 update (eq. 39): one first-order
    Taylor step of eq. 38 around the client's previous level q_prev.
    Kept as the paper-faithful variant; :func:`_solve_case5` is exact.
    """
    qp = max(q_prev, 1.0 + 1e-6)
    y = 2.0**qp
    coeff = env.v * env.w * env.lipschitz * env.lam * env.theta_max**2 * LN2 / (
        4.0 * env.v_weight
    )
    f_den = env.v * env.t_max - env.z * qp - env.z - 32.0
    if f_den <= 0:
        return qp
    f_prev = env.v * env.tau_e * env.gamma * env.d_size / f_den
    num = coeff * y / (y - 1.0) ** 3 - 2.0 * env.alpha * f_prev**3 - env.p
    den = (
        coeff * (2.0 * y**2 + 1.0) * y / (y - 1.0) ** 4 * LN2
        + 6.0 * env.alpha * env.z * (env.v * env.tau_e * env.gamma * env.d_size) ** 3 / f_den**4
    )
    if den <= 0:
        return qp
    return qp + num / den


def integerize(env: ClientEnv, q_hat: float) -> Optional[ClientDecision]:
    """Theorem 3 (eq. 42): compare floor/ceil of q_hat with f = S(q)."""
    if math.isnan(q_hat):
        return None
    candidates = sorted({max(1, math.floor(q_hat)), max(1, math.ceil(q_hat))})
    best: Optional[ClientDecision] = None
    for q in candidates:
        f = optimal_frequency(env, float(q))
        if not (f <= env.f_max) or math.isinf(f):
            continue
        lat_cmp = env.tau_e * env.gamma * env.d_size / f
        lat_com = _payload_bits(env, q) / env.v
        if lat_cmp + lat_com > env.t_max * (1 + 1e-9):
            continue
        dec = ClientDecision(
            q=q,
            f=f,
            q_cont=q_hat,
            case=0,
            j3=j3(env, f, q),
            e_cmp=env.tau_e * env.alpha * env.gamma * env.d_size * f**2,
            e_com=env.p * lat_com,
            t_cmp=lat_cmp,
            t_com=lat_com,
            feasible=True,
        )
        if best is None or dec.j3 < best.j3:
            best = dec
    return best


def solve_client(env: ClientEnv, q_prev: Optional[float] = None,
                 paper_taylor: bool = False) -> Optional[ClientDecision]:
    """Full per-client pipeline: continuous KKT solve -> Theorem-3 rounding.

    ``paper_taylor``: use the paper's eq. 39 Taylor step for Case 5 instead
    of exact bisection (needs ``q_prev``).
    Returns None when the client cannot meet the deadline at any (f, q).
    """
    q_hat, _f_hat, case = solve_continuous(env)
    if case == -1:
        return None
    if case == 5 and paper_taylor and q_prev is not None:
        q_hat = taylor_case5(env, q_prev)
    dec = integerize(env, q_hat)
    if dec is None:
        return None
    return dataclasses.replace(dec, case=case)
