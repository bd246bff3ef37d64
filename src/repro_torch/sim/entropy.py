"""Per-round random draws of the fleet round, behind one seam.

torch cannot replay ``jax.random``, so the engine never draws on its own:
each round asks an entropy source for

  * the (U, C) channel rates, from two (A, U, C) Rician normal draws;
  * the GA's draws (:class:`GADraws`), in the rounds of the GA modes
    (``compiled-ga``, ``same_size``) only;
  * the (S, tau, B) minibatch indices of the scheduled slots, each row in
    ``[0, n_s)`` for its slot's dataset size;
  * the (S, Zpad) uniforms of the eq.-4 stochastic rounding;
  * the fault draws (:class:`FaultDraws`), with fault injection on only;
  * the (Z,) uniforms of the quantized downlink, with the downlink on only.

in that order, in ``run_compiled`` and ``run_host_policy`` alike: with one
sequential generator another order would hand the two runs other numbers.
A run with faults and downlink off draws exactly what it drew before they
existed.

Set-up draws come from a second generator, before any round: a cell-free
scenario's client drop (:meth:`DeviceEntropy.drop_uniforms`) and its eps
probe's Rician normals (:meth:`DeviceEntropy.probe_normals`).

:class:`DeviceEntropy` is the default: one ``torch.Generator`` on the
device seeded with ``seed + 1`` for the rounds (the JAX engine's round keys
split from ``PRNGKey(seed + 1)``) and one seeded with ``seed`` for the
set-up draws (JAX folds those off ``PRNGKey(seed)``). A parity test passes
an object with the same methods that returns the JAX package's own draws
for round ``ridx``. The round generator's state is what a segment
checkpoint saves (:meth:`DeviceEntropy.get_state`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sim import channel as sim_channel


@dataclasses.dataclass
class GADraws:
    """One round's draws of the compiled GA (``repro_torch.sim.search``),
    with P = population, G = generations, E = elitism, T = tournament,
    NP = ceil((P - E) / 2). The uniforms are handed over, not the
    booleans: the GA compares them with ``p_crossover``/``p_mutation``."""

    n_sched: torch.Tensor   # (P,) int64 in [1, min(U, C)]
    perm_u: torch.Tensor    # (P, U) one permutation of the clients per row
    perm_c: torch.Tensor    # (P, C) one permutation of the channels per row
    cand: torch.Tensor      # (G, NP, 2, T) tournament candidates in [0, P)
    u_cx: torch.Tensor      # (G, NP) fp32 crossover uniforms
    pt: torch.Tensor        # (G, NP) crossover points in [1, C)
    u_mut: torch.Tensor     # (G, P - E, C) fp32 mutation uniforms
    mut_val: torch.Tensor   # (G, P - E, C) mutation values in [-1, U)

    def to(self, device) -> "GADraws":
        return GADraws(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})


@dataclasses.dataclass
class FaultDraws:
    """One round's fault draws (``repro_torch.sim.scenario.FaultSpec``),
    U clients, S slots, Zpad wire coordinates."""

    outage: torch.Tensor    # (U,) fp32 uniforms of the outage process
    fade: torch.Tensor      # (U,) fp32 uniforms of the deep fades
    burst: torch.Tensor     # (S,) fp32 uniforms of the NaN/Inf bursts
    hit: torch.Tensor       # (S,) fp32 uniforms: is the slot's wire corrupted
    site: torch.Tensor      # (S, Zpad) fp32 uniforms: which entries flip
    bits: torch.Tensor      # (S, Zpad) int32 in [0, 256): the XOR bytes

    def to(self, device) -> "FaultDraws":
        return FaultDraws(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def ga_shapes(n_clients: int, n_channels: int, cfg) -> dict:
    """Field -> shape of one round's :class:`GADraws` under ``cfg``."""
    p, g, e = cfg.population, cfg.generations, cfg.elitism
    n_pairs = (p - e + 1) // 2
    return {
        "n_sched": (p,), "perm_u": (p, n_clients), "perm_c": (p, n_channels),
        "cand": (g, n_pairs, 2, cfg.tournament), "u_cx": (g, n_pairs),
        "pt": (g, n_pairs), "u_mut": (g, p - e, n_channels),
        "mut_val": (g, p - e, n_channels),
    }


class DeviceEntropy:
    """Draws every round's randomness on ``device`` from one generator."""

    def __init__(self, seed: int, device) -> None:
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed) + 1)
        self.setup_generator = torch.Generator(device=device)
        self.setup_generator.manual_seed(int(seed))
        self.device = torch.device(device)

    # ---------------------------------------------------------- set-up

    def drop_uniforms(self, n_clients: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(U,) radius and (U,) angle uniforms of a cell-free client drop."""
        gen, dev = self.setup_generator, self.device
        return (torch.rand((n_clients,), generator=gen, device=dev),
                torch.rand((n_clients,), generator=gen, device=dev))

    def probe_normals(self, shape) -> tuple[torch.Tensor, torch.Tensor]:
        """Two (A, U, C) Rician normal draws of the eps probe's rates."""
        gen, dev = self.setup_generator, self.device
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    # ---------------------------------------------------------- rounds

    def rates(self, ridx: int, channel: sim_channel.SimChannel) -> torch.Tensor:
        nx = torch.randn(channel.shape, generator=self.generator, device=self.device)
        ny = torch.randn(channel.shape, generator=self.generator, device=self.device)
        return sim_channel.draw_rates(nx, ny, channel.params, channel.distances,
                                      channel.association)

    def ga_draws(self, ridx: int, n_clients: int, n_channels: int, cfg) -> GADraws:
        gen, dev = self.generator, self.device
        shp = ga_shapes(n_clients, n_channels, cfg)

        def randint(lo, hi, name):
            return torch.randint(lo, hi, shp[name], generator=gen, device=dev)

        def uniform(name):
            return torch.rand(shp[name], generator=gen, device=dev)

        m = min(n_clients, n_channels)
        return GADraws(
            n_sched=randint(1, m + 1, "n_sched"),
            perm_u=torch.argsort(uniform("perm_u"), dim=1),
            perm_c=torch.argsort(uniform("perm_c"), dim=1),
            cand=randint(0, cfg.population, "cand"),
            u_cx=uniform("u_cx"),
            pt=randint(1, n_channels, "pt"),
            u_mut=uniform("u_mut"),
            mut_val=randint(-1, n_clients, "mut_val"),
        )

    def batch_indices(self, ridx: int, n_s: torch.Tensor, tau: int,
                      batch_size: int) -> torch.Tensor:
        u = torch.rand((n_s.shape[0], tau, batch_size), generator=self.generator,
                       device=self.device)
        hi = n_s[:, None, None]
        return torch.minimum((u * hi.to(torch.float32)).to(torch.int64), hi - 1)

    def uniforms(self, ridx: int, s: int, zpad: int) -> torch.Tensor:
        return torch.rand((s, zpad), generator=self.generator, device=self.device)

    def fault_draws(self, ridx: int, n_clients: int, s: int, zpad: int) -> FaultDraws:
        gen, dev = self.generator, self.device

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        return FaultDraws(
            outage=uniform(n_clients), fade=uniform(n_clients), burst=uniform(s),
            hit=uniform(s), site=uniform(s, zpad),
            bits=torch.randint(0, 256, (s, zpad), generator=gen, device=dev,
                               dtype=torch.int32),
        )

    def downlink_uniforms(self, ridx: int, z: int) -> torch.Tensor:
        return torch.rand((z,), generator=self.generator, device=self.device)

    # ------------------------------------------------------ checkpoints

    def get_state(self) -> dict:
        """The round generator's state (a uint8 CPU tensor), the only one
        that advances during rounds."""
        return {"round": self.generator.get_state()}

    def set_state(self, state: dict) -> None:
        self.generator.set_state(torch.as_tensor(state["round"], dtype=torch.uint8).cpu())
