"""Inputs of the decision's KKT solve (``repro_torch.kernels.kkt``) for the
CPU tests of its wrapper and the card tests of its kernel. Numpy draws
from a seed; no JAX, so the card's tests can import it.

The system is the benchmark cell's (``bench/configs/femnist_cnn.json``):
``SystemParams()``'s Table-I values, the FEMNIST CNN's Z, V = 100, q_cap 8.
"""
import math

import numpy as np
import torch

from repro_torch.core.genetic import SystemParams

SYSP = SystemParams()
Z = 246590
V_WEIGHT = 100.0
Q_CAP = 8
# A4 above which Case 2's cubic takes its trigonometric branch (the
# discriminant A4^2/4 - A4^3/27 turns negative)
A4_TRIG = 27.0 / 4.0


def log_uniform(rng, lo, hi, shape):
    return np.exp(rng.uniform(math.log(lo), math.log(hi), shape))


def pool(n: int, seed: int, unassigned: float = 0.1):
    """(v, w, d, theta) of ``n`` clients spread log-uniformly wide enough
    that every KKT case, both branches of Case 2's cubic, the grid over a
    feasible span and infeasible clients all occur at lam from 1e-3 to
    1e4; a share ``unassigned`` has no channel (v = w = 0), as most of a
    fleet has in a round."""
    rng = np.random.default_rng(seed)
    v = log_uniform(rng, 2e7, 1e9, n)
    w = log_uniform(rng, 1e-4, 0.5, n)
    d = rng.uniform(50.0, 3000.0, n)
    theta = log_uniform(rng, 1e-3, 5.0, n)
    off = rng.uniform(size=n) < unassigned
    v[off], w[off] = 0.0, 0.0
    return v, w, d, theta


def fleet(u: int, c: int, seed: int):
    """(v, w, d, theta) of a round of the cell: ``u`` clients, ``c`` of
    them on a channel at a 10-MHz rate, the round weights D_i / D^n over
    those, dataset sizes ~ N(1200, 150) floored at 50."""
    rng = np.random.default_rng(seed)
    d = np.maximum(rng.normal(1200.0, 150.0, u), 50.0)
    theta = log_uniform(rng, 0.01, 1.0, u)
    v = np.zeros(u)
    w = np.zeros(u)
    on = rng.choice(u, size=c, replace=False)
    v[on] = log_uniform(rng, 3e7, 3e8, c)
    w[on] = d[on] / d[on].sum()
    return v, w, d, theta


def population(p: int, u: int, c: int, seed: int):
    """A GA population's inputs: v and w (p, u), one fleet's d and theta
    (u,) beside them, as ``search.evaluate_population`` passes them."""
    rounds = [fleet(u, c, seed * 1000 + i) for i in range(p)]
    _, _, d, theta = fleet(u, c, seed)
    return (np.stack([r[0] for r in rounds]), np.stack([r[1] for r in rounds]), d, theta)


def a4_of(v, w, theta, lam):
    """Case 2's A4 in float64 (which branch of the cubic a client takes,
    up to rounding at the boundary)."""
    return (np.maximum(v, 1e-6) * w * SYSP.lipschitz * lam * theta**2 * math.log(2.0)
            / (4.0 * SYSP.p_tx * V_WEIGHT))


def qmax_of(v, d):
    """The largest feasible level in float64 (a grid's span is qmax - 1)."""
    v = np.maximum(v, 1e-6)
    return (v * SYSP.t_max - SYSP.tau_e * SYSP.gamma * d * v / SYSP.f_max - Z - 32.0) / Z


def tensors(arrays, device):
    return [torch.tensor(np.asarray(a, np.float32), device=device) for a in arrays]


def lam_tensor(lam: float, device):
    return torch.tensor(lam, dtype=torch.float32, device=device)
