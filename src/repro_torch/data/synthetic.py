"""Synthetic learnable datasets (offline stand-ins for FEMNIST / CIFAR-10).

Class-conditional Gaussian images: class c has a fixed random template
mu_c; a sample is mu_c + noise. A CNN separates them readily, so the FL
dynamics (convergence speed, effect of quantization error and scheduling)
are exercised end-to-end. Sizes/shapes match the real datasets
(28x28x1/62-class for the FEMNIST proxy; 32x32x3/10-class for CIFAR).

See DESIGN.md §6: the paper's claims are validated as *relative*
statements on these proxies.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    hw: int
    ch: int
    n_classes: int
    template_scale: float = 1.0
    noise_scale: float = 0.8


FEMNIST_PROXY = TaskSpec("femnist_proxy", 28, 1, 62)
CIFAR10_PROXY = TaskSpec("cifar10_proxy", 32, 3, 10)
TINY_TASK = TaskSpec("tiny_task", 16, 1, 10)


class SyntheticImageTask:
    def __init__(self, spec: TaskSpec, seed: int = 0) -> None:
        self.spec = spec
        rng = np.random.default_rng(seed)
        self.templates = (
            spec.template_scale
            * rng.standard_normal((spec.n_classes, spec.hw, spec.hw, spec.ch))
        ).astype(np.float32)
        self._rng = rng

    def sample(self, n: int, class_probs: np.ndarray | None = None,
               rng: np.random.Generator | None = None) -> dict:
        rng = rng or self._rng
        s = self.spec
        y = rng.choice(s.n_classes, size=n, p=class_probs)
        x = self.templates[y] + s.noise_scale * rng.standard_normal(
            (n, s.hw, s.hw, s.ch)
        ).astype(np.float32)
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def dirichlet_class_probs(
    n_clients: int, n_classes: int, alpha: float, seed: int = 0
) -> np.ndarray:
    """Non-IID label skew: one Dirichlet(alpha) class distribution per client."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(n_classes, alpha), size=n_clients)


def gaussian_sizes(
    n_clients: int, mu: float, beta: float, seed: int = 0, floor: int = 50
) -> np.ndarray:
    """Paper Sec. VI: D_i ~ N(mu, beta) (beta is the std deviation)."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.normal(mu, beta, n_clients), floor).astype(np.int64)


def make_federated_datasets(
    task: SyntheticImageTask, n_clients: int, sizes: np.ndarray,
    alpha: float = 0.5, seed: int = 0,
) -> list[dict]:
    """One fixed local dataset per client (drawn once, reused all rounds)."""
    probs = dirichlet_class_probs(n_clients, task.spec.n_classes, alpha, seed)
    out = []
    for i in range(n_clients):
        rng = np.random.default_rng(seed * 1000 + i)
        out.append(task.sample(int(sizes[i]), probs[i], rng))
    return out


def label_histograms(datasets: list[dict], n_classes: int) -> np.ndarray:
    """(U, K) realized label distribution per client (normalized counts).

    Computed from the labels actually drawn, not the Dirichlet parameters:
    the scheduler should react to the data clients hold, and at small D_i
    the realized skew deviates substantially from the sampling probs.
    """
    hist = np.zeros((len(datasets), n_classes))
    for i, d in enumerate(datasets):
        hist[i] = np.bincount(np.asarray(d["y"]), minlength=n_classes)
    return hist / np.maximum(hist.sum(axis=1, keepdims=True), 1.0)


def hetero_kl(datasets: list[dict], n_classes: int) -> np.ndarray:
    """(U,) KL(client label histogram || global histogram) — the
    heterogeneity score the scenario's ``hetero_weight`` scales into the
    scheduling term (2308.03521-style non-IID-aware scheduling). 0 for a
    client whose labels mirror the global mix; grows with label skew."""
    p = label_histograms(datasets, n_classes)               # (U, K)
    sizes = np.array([len(d["y"]) for d in datasets], np.float64)
    g = (p * sizes[:, None]).sum(axis=0)
    g = g / g.sum()                                          # (K,) global mix
    ratio = np.where(p > 0, p / np.maximum(g, 1e-12), 1.0)
    return np.sum(np.where(p > 0, p * np.log(ratio), 0.0), axis=1)


def minibatches(data: dict, batch_size: int, rng: np.random.Generator):
    """Infinite shuffled minibatch iterator over a local dataset."""
    n = data["x"].shape[0]
    while True:
        idx = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            sel = idx[lo : lo + batch_size]
            yield {"x": data["x"][sel], "y": data["y"][sel]}


def make_test_set(task: SyntheticImageTask, n: int = 2000, seed: int = 999) -> dict:
    rng = np.random.default_rng(seed)
    return task.sample(n, rng=rng)
