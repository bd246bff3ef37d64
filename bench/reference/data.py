"""The fleet's data, worked out again from the seed: client sizes, label
skew, each client's images, the test set and the client drop.

A frozen copy of the arithmetic of the paper's Sec.-VI set-up as the
system states it: D_i ~ N(mu, beta) floored at ``floor``; Dirichlet(alpha)
class probabilities per client; class-conditional Gaussian images (a
fixed template per class plus ``noise_scale`` noise) at the dataset's
shape; one numpy generator per client seeded ``seed * 1000 + i``; the
test set from ``seed + 999``; clients dropped uniformly in a disc of
``radius_m``, snapped out to ``near_field_m``. ``seed`` is the
configuration's data seed. Clients are made on
demand (a round's reference needs only its scheduled clients).
"""
from __future__ import annotations

import concurrent.futures

import numpy as np


class FleetData:
    def __init__(self, cfg: dict) -> None:
        data, model = cfg["data"], cfg["model"]
        self.seed = int(data["seed"])
        self.shape = (model["in_hw"], model["in_hw"], model["in_ch"])
        self.n_classes = model["n_classes"]
        self.noise = data["noise_scale"]
        u = cfg["n_clients"]
        rng = np.random.default_rng(self.seed)
        self.templates = (data["template_scale"] * rng.standard_normal(
            (self.n_classes,) + self.shape)).astype(np.float32)
        self.sizes = np.maximum(np.random.default_rng(self.seed).normal(
            data["mu"], data["beta"], u), data["floor"]).astype(np.int64)
        self.probs = np.random.default_rng(self.seed).dirichlet(
            np.full(self.n_classes, data["alpha_dirichlet"]), size=u)
        ch = cfg["channel"]
        r = ch["radius_m"] * np.sqrt(np.random.default_rng(self.seed).uniform(size=u))
        self.distances = np.maximum(r, ch["near_field_m"])
        self._clients: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _sample(self, rng, n: int, probs) -> tuple[np.ndarray, np.ndarray]:
        y = rng.choice(self.n_classes, size=n, p=probs)
        x = self.templates[y] + self.noise * rng.standard_normal(
            (n,) + self.shape).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)

    def _make(self, i: int):
        rng = np.random.default_rng(self.seed * 1000 + i)
        return self._sample(rng, int(self.sizes[i]), self.probs[i])

    def clients(self, ids) -> list[tuple[np.ndarray, np.ndarray]]:
        """(x, y) of each client in ``ids``, made once each, in threads."""
        todo = sorted({int(i) for i in ids} - set(self._clients))
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            for i, xy in zip(todo, pool.map(self._make, todo)):
                self._clients[i] = xy
        return [self._clients[int(i)] for i in ids]

    def test_set(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        return self._sample(np.random.default_rng(self.seed + 999), n, None)
