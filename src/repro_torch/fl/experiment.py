"""Task table of the FL experiments (the part of ``repro.fl.experiment``
that the fleet simulator uses; ``build_experiment``/``FLExperiment`` are
not ported yet, see ROADMAP.md)."""
from __future__ import annotations

from typing import Optional

from repro_torch.data.synthetic import CIFAR10_PROXY, FEMNIST_PROXY, TINY_TASK
from repro_torch.models import cnn
from repro_torch.wireless.system import CIFAR10_SYSTEM, FEMNIST_SYSTEM

TASKS = {
    "femnist": (FEMNIST_PROXY, cnn.FEMNIST_CNN, FEMNIST_SYSTEM),
    "cifar10": (CIFAR10_PROXY, cnn.CIFAR10_CNN, CIFAR10_SYSTEM),
    "tiny": (TINY_TASK, cnn.TINY_CNN, FEMNIST_SYSTEM),
}


def task_data_sizes(task: str, mu: Optional[float] = None,
                    beta: Optional[float] = None) -> tuple[float, float]:
    """Resolve the D_i ~ N(mu, beta) spec for a task. ``None`` means the
    paper's Sec.-VI defaults; the tiny task clamps both down so its 16x16
    proxy stays a sub-second fixture."""
    mu = 1200.0 if mu is None else mu
    beta = 150.0 if beta is None else beta
    if task == "tiny":
        mu, beta = min(mu, 200.0), min(beta, 40.0)
    return mu, beta
