"""Per-round random draws of the fleet round, behind one seam.

torch cannot replay ``jax.random``, so the engine never draws on its own:
each round asks an entropy source for

  * the (U, C) channel rates, from two (A, U, C) Rician normal draws;
  * the (S, tau, B) minibatch indices of the scheduled slots, each row in
    ``[0, n_s)`` for its slot's dataset size;
  * the (S, Zpad) uniforms of the eq.-4 stochastic rounding.

:class:`DeviceEntropy` is the default: one ``torch.Generator`` on the
device seeded with ``seed + 1`` (the JAX engine's round keys split from
``PRNGKey(seed + 1)``). A parity test passes an object with the same three
methods that returns the JAX package's own draws for round ``ridx``.
"""
from __future__ import annotations

import torch

from repro_torch.sim import channel as sim_channel


class DeviceEntropy:
    """Draws every round's randomness on ``device`` from one generator."""

    def __init__(self, seed: int, device) -> None:
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed) + 1)
        self.device = torch.device(device)

    def rates(self, ridx: int, channel: sim_channel.SimChannel) -> torch.Tensor:
        nx = torch.randn(channel.shape, generator=self.generator, device=self.device)
        ny = torch.randn(channel.shape, generator=self.generator, device=self.device)
        return sim_channel.draw_rates(nx, ny, channel.params, channel.distances,
                                      channel.association)

    def batch_indices(self, ridx: int, n_s: torch.Tensor, tau: int,
                      batch_size: int) -> torch.Tensor:
        u = torch.rand((n_s.shape[0], tau, batch_size), generator=self.generator,
                       device=self.device)
        hi = n_s[:, None, None]
        return torch.minimum((u * hi.to(torch.float32)).to(torch.int64), hi - 1)

    def uniforms(self, ridx: int, s: int, zpad: int) -> torch.Tensor:
        return torch.rand((s, zpad), generator=self.generator, device=self.device)
