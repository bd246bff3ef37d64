"""The decision's vectorised KKT solve (eq. 41/42) as one CUDA kernel.

``solve_kkt_plain`` is the torch walk of ``repro_torch.core.kkt``'s five
cases over every client at once (the port of ``repro.sim.policy.solve_kkt``,
which XLA fuses and no Pallas kernel replaces). Run op by op on the card it
is some 3,450 tiny elementwise launches a call: 80 bisection halvings of ~35
ops each, a (U, 512) grid, the case selects. ``csrc/qccf_kkt.cu``
(``qccf_kkt_kernel``) does the same walk with one thread per client element,
every intermediate in registers, in one launch.

The kernel repeats the plain version's fp32 operations in its order, as
torch's CUDA kernels round them: one rounding per op, a tensor divided by
a Python float multiplies by the fp32 reciprocal, ``x**2`` is ``x*x``,
``x**3`` is ``x*x*x``. Chains of ``SystemParams`` floats that Python folds
in double before torch sees them are folded here the same way
(:func:`kernel_constants`) and passed as fp32. The kernel also writes which
case each client took (:data:`CASES`), which the plain version computes
from its masks.

``solve_kkt`` runs the plain version for tensors on the CPU and the kernel
for tensors on the card, with no fallback between the two; ``launches``
counts kernel launches only. No backward: under grad it raises on every
device (``build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.quantization import RANGE_BITS
from repro_torch.kernels import build

if TYPE_CHECKING:
    from repro_torch.core.genetic import SystemParams

LN2 = math.log(2.0)
# case code per client: the KKT case whose q_hat was taken (the host
# solver's priority order 1, 2, 4, 3, 5), GRID for the dense-grid fallback
CASES = {1: "q = 1", 2: "cubic", 3: "f = f_max", 4: "f = f_min", 5: "bisection", 6: "grid"}
GRID = 6
# what a caller that needs gradients uses instead: nothing differentiates
# through the integer levels
KKT_GRAD_ROUTE = "solve_kkt_plain (the decision takes no gradient)"

# kernel launches since the last reset_launches(); the CPU path never counts
launches = {"kkt": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ------------------------------------------------------------ plain twin

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


def solve_kkt_plain(
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised eq. 41/42: returns (q int, f, feasible, q_cont, case int8)
    per client, walking the host solver's cases in its priority order (1,
    2, 4, 3, 5, grid fallback). Elementwise, so ``v``, ``w``, ``d`` and
    ``theta`` may carry a leading population axis, (P, U)."""
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
    case = torch.full(q_hat.shape, GRID, dtype=torch.int8, device=q_hat.device)
    for code, ok in ((5, ok5), (3, ok3), (4, ok4), (2, ok2), (1, ok1)):
        case = torch.where(ok, torch.full_like(case, code), case)

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
    return q_int.to(torch.int64), f_int, feasible, q_hat, case


# ---------------------------------------------------------------- kernel

# kernel_constants' values, in the order of csrc/qccf_kkt.cu's KktConsts
CONSTANTS = (
    "t_max", "tau_e", "gamma", "tau_gamma", "rcp_f_max", "z", "rcp_z", "p_v",
    "lipschitz", "ln2", "bits_q1", "f_min", "f_max", "rcp_4p_v", "rcp_f_min",
    "kappa4_max", "kappa3_min", "rcp_v", "p", "two_alpha", "lo", "eps9",
    "grid_step", "cmp_k", "com_k", "q_cap", "f_max_tol", "t_max_tol", "v_min",
)


def _f32(x) -> np.float32:
    return np.float32(x)


def _rcp(x) -> np.float32:
    """What torch's CUDA ``tensor / python_float`` multiplies by: the fp32
    reciprocal of the fp32 divisor."""
    return np.float32(1.0) / np.float32(x)


@functools.lru_cache(maxsize=64)
def kernel_constants(sysp: SystemParams, z: int, v_weight: float, q_cap: int,
                     grid_n: int) -> np.ndarray:
    """The fp32 scalars the kernel reads, each as the plain version hands
    it to torch: Python folds a chain of floats in double, torch rounds the
    result to fp32 once (and takes a divisor's fp32 reciprocal). Each
    expression is written as :func:`solve_kkt_plain` writes it."""
    p, V, L = sysp.p_tx, v_weight, sysp.lipschitz
    vals = {
        "t_max": _f32(sysp.t_max), "tau_e": _f32(sysp.tau_e), "gamma": _f32(sysp.gamma),
        "tau_gamma": _f32(sysp.tau_e * sysp.gamma), "rcp_f_max": _rcp(sysp.f_max),
        "z": _f32(z), "rcp_z": _rcp(z), "p_v": _f32(p * V), "lipschitz": _f32(L),
        "ln2": _f32(LN2), "bits_q1": _f32(z * 1.0 + z + RANGE_BITS),
        "f_min": _f32(sysp.f_min), "f_max": _f32(sysp.f_max),
        "rcp_4p_v": _rcp(4.0 * p * V), "rcp_f_min": _rcp(sysp.f_min),
        "kappa4_max": _f32(2.0 * V * sysp.alpha * sysp.f_min**3),
        "kappa3_min": _f32(2.0 * V * sysp.alpha * sysp.f_max**3),
        "rcp_v": _rcp(V), "p": _f32(p), "two_alpha": _f32(2.0 * sysp.alpha),
        "lo": _f32(1.0 + 1e-9), "eps9": _f32(1e-9),
        "grid_step": _f32(1.0 / (grid_n - 1)),
        "cmp_k": _f32(v_weight * sysp.tau_e * sysp.alpha * sysp.gamma),
        "com_k": _f32(sysp.p_tx * v_weight * z), "q_cap": _f32(float(q_cap)),
        "f_max_tol": _f32(sysp.f_max * (1.0 + 1e-5)),
        "t_max_tol": _f32(sysp.t_max * (1.0 + 1e-5)), "v_min": _f32(1e-6),
    }
    out = np.array([vals[name] for name in CONSTANTS], dtype=np.float32)
    out.setflags(write=False)
    return out


def _check_inputs(v, w, d, theta, lam) -> torch.Size:
    """The clients' shape, after the checks the kernel needs: fp32,
    contiguous, ``lam`` one element, and each of ``v``, ``w``, ``d``,
    ``theta`` either of the whole shape or of its trailing dims (a (U,)
    vector beside a (P, U) population)."""
    named = {"v": v, "w": w, "d": d, "theta": theta, "lam": lam}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"solve_kkt: {name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"solve_kkt: {name} must be contiguous")
    shape = max((v.shape, w.shape, d.shape, theta.shape), key=len)
    if lam.numel() != 1 or lam.dim() > len(shape):
        raise ValueError(f"solve_kkt: lam must be one element, got shape {tuple(lam.shape)}")
    for name in ("v", "w", "d", "theta"):
        got = named[name].shape
        if got != shape[len(shape) - len(got):]:
            raise ValueError(
                f"solve_kkt: {name} has shape {tuple(got)}; each client input must have "
                f"the clients' shape {tuple(shape)} or its trailing dims")
    return shape


def solve_kkt(
    v: torch.Tensor, w: torch.Tensor, d: torch.Tensor, theta: torch.Tensor,
    lam: torch.Tensor, sysp: SystemParams, z: int, v_weight: float,
    q_cap: int = 8, grid_n: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`solve_kkt_plain`'s function: (q int64, f fp32, feasible bool,
    q_cont fp32, case int8) per client. ``v``, ``w``, ``d``, ``theta`` fp32
    and contiguous, each of the clients' shape or its trailing dims;
    ``lam`` one fp32 element, read on the device (no host sync). On the
    card, one launch of ``qccf_kkt_kernel``."""
    build.refuse_grad("solve_kkt", KKT_GRAD_ROUTE, v, w, d, theta, lam)
    shape = _check_inputs(v, w, d, theta, lam)
    if grid_n < 2:
        raise ValueError(f"solve_kkt: grid_n must be at least 2, got {grid_n}")
    if not build.route("solve_kkt", v, w, d, theta, lam):
        return solve_kkt_plain(v, w, d, theta, lam, sysp, z, v_weight, q_cap, grid_n)
    dev = v.device
    q = torch.empty(shape, dtype=torch.int64, device=dev)
    f = torch.empty(shape, dtype=torch.float32, device=dev)
    feasible = torch.empty(shape, dtype=torch.bool, device=dev)
    q_hat = torch.empty(shape, dtype=torch.float32, device=dev)
    case = torch.empty(shape, dtype=torch.int8, device=dev)
    n = q.numel()
    if n:
        consts = kernel_constants(sysp, int(z), float(v_weight), int(q_cap), int(grid_n))
        lib = build.library("qccf_kkt")
        # no range of its own: the caller's (``kkt_solve``) is the
        # innermost, so the launch lies in its span on the device's timeline
        err = lib.qccf_kkt(
            v.data_ptr(), w.data_ptr(), d.data_ptr(), theta.data_ptr(), lam.data_ptr(),
            n, v.numel(), w.numel(), d.numel(), theta.numel(),
            consts.ctypes.data_as(ctypes.c_void_p), consts.size, int(grid_n),
            q.data_ptr(), f.data_ptr(), feasible.data_ptr(), q_hat.data_ptr(),
            case.data_ptr(), dev.index or 0, build.stream(dev),
        )
        build.check("qccf_kkt", "solve_kkt", err)
        launches["kkt"] += 1
    return q, f, feasible, q_hat, case
