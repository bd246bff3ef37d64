"""Table-I parameter presets for the two paper tasks."""
from __future__ import annotations

from repro_torch.core.genetic import SystemParams

# Paper Table I. lipschitz/eta are the bound hyper-parameters (Sec. III);
# the paper does not publish L, we use an estimate that satisfies the
# Theorem-1/2 premises (eta*L < 1, 2 eta^2 tau^2 L^2 < 1) at tau = 6.
FEMNIST_SYSTEM = SystemParams(
    p_tx=0.2,
    alpha=1e-26,
    gamma=1000.0,
    tau=6,
    tau_e=2,
    t_max=0.02,
    f_min=2e8,
    f_max=1e9,
    lipschitz=1.0,
    eta=0.05,
)

CIFAR10_SYSTEM = SystemParams(
    p_tx=0.2,
    alpha=1e-26,
    gamma=2000.0,
    tau=6,
    tau_e=2,
    t_max=0.05,
    f_min=2e8,
    f_max=1e9,
    lipschitz=1.0,
    eta=0.05,
)
