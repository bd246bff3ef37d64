"""Experiment assembly: a full FL setup for a task + policy name (the port
of ``repro.fl.experiment``). This is what the examples call:

    res = run_policy("qccf", task="femnist", beta=150, n_rounds=100)

``TASKS`` and ``task_data_sizes`` are shared with the fleet simulator
(``repro_torch.sim.build_sim``).
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import quantization
from repro_torch.core.controller import QCCFController, auto_epsilons
from repro_torch.core.genetic import GAConfig, RoundContext
from repro_torch.data.synthetic import (
    CIFAR10_PROXY,
    FEMNIST_PROXY,
    TINY_TASK,
    SyntheticImageTask,
    gaussian_sizes,
    make_federated_datasets,
    make_test_set,
)
from repro_torch.device import resolve_device
from repro_torch.fl import baselines
from repro_torch.fl.client import FLClient
from repro_torch.fl.trainer import ExperimentResult, FLExperiment, Policy
from repro_torch.models import cnn
from repro_torch.wireless.channel import ChannelModel, ChannelParams
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


def build_experiment(
    policy_name: str,
    task: str = "tiny",
    *,
    n_clients: int = 10,
    n_channels: int = 10,
    mu: float = 1200.0,
    beta: float = 150.0,
    v_weight: float = 100.0,
    alpha_dirichlet: float = 0.5,
    lr: float = 0.05,
    seed: int = 0,
    ga: Optional[GAConfig] = None,
    init_params: Optional[dict] = None,
    device=None,
    entropy: Any = None,
) -> FLExperiment:
    """Mirror of ``repro.fl.experiment.build_experiment`` on ``device``
    (``cuda`` unless the caller passes another; raises without CUDA).

    The numpy draws come in the JAX package's order (the datasets, the
    test set, the channel's drop, the eps probe's rates), so the clients,
    the channel and the budgets equal its own. ``init_params`` (e.g.
    ``cnn.params_from_numpy`` of the JAX package's weights) replaces the
    port's own seeded init; ``entropy`` replaces the default
    :class:`~repro_torch.fl.trainer.UploadEntropy`.
    """
    dev = resolve_device(device)
    task_spec, cnn_cfg, sysp = TASKS[task]
    mu, beta = task_data_sizes(task, mu, beta)
    img_task = SyntheticImageTask(task_spec, seed=seed)
    sizes = gaussian_sizes(n_clients, mu, beta, seed=seed)
    datasets = make_federated_datasets(img_task, n_clients, sizes,
                                       alpha=alpha_dirichlet, seed=seed)
    test = make_test_set(img_task, n=1024, seed=seed + 999)
    test_x = torch.from_numpy(test["x"]).to(dev)
    test_y = torch.from_numpy(test["y"].astype(np.int64)).to(dev)

    loss_fn = functools.partial(cnn.loss_fn, cnn_cfg)
    params = (cnn.init_params(cnn_cfg, seed, device=dev) if init_params is None
              else init_params)
    clients = [
        FLClient(i, datasets[i], loss_fn, batch_size=32, seed=seed, device=dev)
        for i in range(n_clients)
    ]

    def eval_fn(p):
        acc, loss = cnn.eval_metrics(cnn_cfg, p, test_x, test_y)
        return float(acc), float(loss)

    channel = ChannelModel(
        ChannelParams(n_clients=n_clients, n_channels=n_channels), seed=seed
    )
    z = quantization.pytree_size(params)
    ga = ga or GAConfig(generations=12, population=20)

    # budgets from a nominal schedule (see controller.auto_epsilons); the
    # probe's draw advances the channel's generator before round 0
    probe = RoundContext(
        rates=channel.draw_rates(), d_sizes=sizes.astype(np.float64),
        g_sq=np.full(n_clients, 1.0), sigma_sq=np.full(n_clients, 1.0),
        theta_max=np.full(n_clients, 1.0), z=z,
    )
    eps1, eps2 = auto_epsilons(probe, sysp, target_q=6.0)

    def make_controller():
        return QCCFController(
            n_clients, sysp, v_weight=v_weight, eps1=eps1, eps2=eps2,
            ga=ga, seed=seed,
        )

    policy: Policy
    if policy_name == "qccf":
        policy = baselines.QCCFPolicy(make_controller())
    elif policy_name == "no_quant":
        policy = baselines.NoQuantPolicy(sysp)
    elif policy_name == "channel_allocate":
        policy = baselines.ChannelAllocatePolicy(sysp)
    elif policy_name == "principle_24":
        policy = baselines.PrinciplePolicy(sysp)
    elif policy_name == "same_size_26":
        policy = baselines.SameSizePolicy(make_controller())
    else:
        raise ValueError(policy_name)

    return FLExperiment(
        clients, params, eval_fn, channel, sysp, policy, lr=lr, seed=seed,
        device=dev, entropy=entropy,
    )


def run_policy(policy_name: str, n_rounds: int = 50, **kw) -> ExperimentResult:
    exp = build_experiment(policy_name, **kw)
    return exp.run(n_rounds, eval_every=max(n_rounds // 25, 1))
