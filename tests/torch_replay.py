"""The JAX package's random draws as tensors for the port's entropy seam
(shared by the ``tests/test_torch_sim_*.py`` parity suites; not a test
module itself).

``ReplayEntropy`` hands ``repro_torch.sim.engine`` the JAX engine's draws
for round ``ridx``: the round key ``split(PRNGKey(seed + 1), N)[ridx]``
split into channel / batch / quantizer keys, the GA's record from
``fold_in(round_key, GA_KEY_TAG)`` (``jax_ga_draws``), the fault draws from
``fault_keys(round_key)`` (``jax_fault_draws``) and the downlink's uniforms
from ``fold_in(round_key, DOWNLINK_KEY_TAG)``; and the set-up draws of a
cell-free scenario from ``fold_in(PRNGKey(seed), DROP_KEY_TAG)`` (the drop)
and ``fold_in(PRNGKey(seed), PROBE_KEY_TAG)`` (the eps probe's normals).

``UploadReplay`` hands ``repro_torch.fl.FLExperiment`` the uniforms of the
JAX object runtime's upload key chain (``jax_upload_uniforms``).
``jax_fl_round_uniforms`` and ``jax_fl_downlink_uniforms`` give
``repro_torch.launch.steps.make_fl_round`` the uniforms JAX's
``make_fl_round`` draws from its round key.

``one_torch_thread`` is a module fixture the suites import: their torch work
is tiny ops, and under pytest-xdist each worker's idle OpenMP threads spin
against the other workers' (the new sim suites ran ~4x slower in wall time
with the default thread count).

``spawn_gloo`` runs a function on n CPU ranks of a ``gloo`` process group
(``torch.multiprocessing.spawn``, rendezvous through a file): the
distribution suites' multi-rank cases.
"""
import os
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.sim import channel as jch
from repro.sim import engine as jeng
from repro.sim import search as jsearch
from repro_torch.sim.entropy import FaultDraws, GADraws


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the importing test module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_indices(key, n_s, tau, batch_size):
    """``sim.fleet.fleet_local_sgd``'s per-slot draws: split(key, S)[s]."""
    keys = jax.random.split(key, len(n_s))
    return np.stack([np.asarray(jax.random.randint(keys[s], (tau, batch_size), 0, int(n)))
                     for s, n in enumerate(n_s)]).astype(np.int64)


def jax_ga_draws(key, n_clients, n_channels, cfg) -> GADraws:
    """The draws ``repro.sim.search.ga_decide`` makes from ``key`` (its
    docstring's key contract), as one :class:`GADraws` of CPU tensors."""
    p, e, t = cfg.population, cfg.elitism, cfg.tournament
    n_pairs = (p - e + 1) // 2
    m = min(n_clients, n_channels)
    k_init, k_evolve = jax.random.split(key)

    def init(ki):
        kk, ku, kc = jax.random.split(ki, 3)
        return (jax.random.randint(kk, (), 1, m + 1),
                jax.random.permutation(ku, n_clients),
                jax.random.permutation(kc, n_channels))

    def gen(kg):
        k_sel, k_cx, k_pt, k_mm, k_mv = jax.random.split(kg, 5)
        return (jax.random.randint(k_sel, (n_pairs, 2, t), 0, p),
                jax.random.uniform(k_cx, (n_pairs,)),
                jax.random.randint(k_pt, (n_pairs,), 1, n_channels),
                jax.random.uniform(k_mm, (p - e, n_channels)),
                jax.random.randint(k_mv, (p - e, n_channels), -1, n_clients))

    n_sched, perm_u, perm_c = jax.vmap(init)(jax.random.split(k_init, p))
    cand, u_cx, pt, u_mut, mut_val = jax.vmap(gen)(
        jax.random.split(k_evolve, cfg.generations))

    def t64(x):
        return torch.from_numpy(np.array(x, np.int64))

    def t32(x):
        return torch.from_numpy(np.array(x, np.float32))

    return GADraws(n_sched=t64(n_sched), perm_u=t64(perm_u), perm_c=t64(perm_c),
                   cand=t64(cand), u_cx=t32(u_cx), pt=t64(pt), u_mut=t32(u_mut),
                   mut_val=t64(mut_val))


def _t(x):
    return torch.tensor(np.asarray(x))


def jax_fault_draws(round_key, n_clients, s, zpad) -> FaultDraws:
    """The draws ``repro.sim.engine``'s fault helpers make from
    ``fault_keys(round_key)``: outage, fade, burst, corrupt (hit, site,
    bytes)."""
    k_out, k_fade, k_corr, k_burst = jeng.fault_keys(round_key)
    k_hit, k_site, k_bits = jax.random.split(k_corr, 3)
    return FaultDraws(
        outage=_t(jax.random.uniform(k_out, (n_clients,))),
        fade=_t(jax.random.uniform(k_fade, (n_clients,))),
        burst=_t(jax.random.uniform(k_burst, (s,))),
        hit=_t(jax.random.uniform(k_hit, (s,))),
        site=_t(jax.random.uniform(k_site, (s, zpad))),
        bits=_t(jax.random.randint(k_bits, (s, zpad), 0, 256, jnp.int32)),
    )


class ReplayEntropy:
    """The JAX engine's per-round draws (``_scan_xs`` round keys), handed
    to the port as tensors through the entropy seam."""

    def __init__(self, jsim, n_rounds):
        self.jsim = jsim
        self.keys = jax.random.split(jax.random.PRNGKey(jsim.seed + 1), n_rounds)

    def _split(self, ridx):
        return jax.random.split(self.keys[ridx], 3)

    def rates(self, ridx, channel):
        k_ch = self._split(ridx)[0]
        r = jch.draw_rates(k_ch, self.jsim.channel.params, self.jsim._dyn["distances"],
                           self.jsim.channel.association)
        return torch.tensor(np.asarray(r))

    def ga_draws(self, ridx, n_clients, n_channels, cfg):
        key = jax.random.fold_in(self.keys[ridx], jsearch.GA_KEY_TAG)
        return jax_ga_draws(key, n_clients, n_channels, cfg)

    def batch_indices(self, ridx, n_s, tau, batch_size):
        return torch.tensor(batch_indices(self._split(ridx)[1], n_s.tolist(), tau,
                                          batch_size))

    def uniforms(self, ridx, s, zpad):
        return torch.tensor(np.asarray(
            jax.random.uniform(self._split(ridx)[2], (s, zpad), jnp.float32)))

    def fault_draws(self, ridx, n_clients, s, zpad):
        return jax_fault_draws(self.keys[ridx], n_clients, s, zpad)

    def downlink_uniforms(self, ridx, z):
        key = jax.random.fold_in(self.keys[ridx], jeng.DOWNLINK_KEY_TAG)
        return _t(jax.random.uniform(key, (z,), jnp.float32))

    def drop_uniforms(self, n_clients):
        key = jax.random.fold_in(jax.random.PRNGKey(self.jsim.seed), jeng.DROP_KEY_TAG)
        k_r, k_phi = jax.random.split(key)
        return (_t(jax.random.uniform(k_r, (n_clients,))),
                _t(jax.random.uniform(k_phi, (n_clients,))))

    def probe_normals(self, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(self.jsim.seed), jeng.PROBE_KEY_TAG)
        kx, ky = jax.random.split(key)
        return _t(jax.random.normal(kx, shape)), _t(jax.random.normal(ky, shape))


class SequentialReplay(ReplayEntropy):
    """The JAX engine's draws handed out as a sequential generator hands
    out its own: each round takes the next round key, whatever round index
    it is asked for, and ``get_state``/``set_state`` carry the position, as
    ``DeviceEntropy``'s generator state does. A run that does not start
    from the sim's initial state draws another run's keys."""

    def __init__(self, jsim, n_rounds):
        super().__init__(jsim, n_rounds)
        self.cursor = 0
        self._round = 0

    def rates(self, ridx, channel):
        # the first draw of every round: it takes the next key
        self._round, self.cursor = self.cursor, self.cursor + 1
        return super().rates(self._round, channel)

    def ga_draws(self, ridx, n_clients, n_channels, cfg):
        return super().ga_draws(self._round, n_clients, n_channels, cfg)

    def batch_indices(self, ridx, n_s, tau, batch_size):
        return super().batch_indices(self._round, n_s, tau, batch_size)

    def uniforms(self, ridx, s, zpad):
        return super().uniforms(self._round, s, zpad)

    def fault_draws(self, ridx, n_clients, s, zpad):
        return super().fault_draws(self._round, n_clients, s, zpad)

    def downlink_uniforms(self, ridx, z):
        return super().downlink_uniforms(self._round, z)

    def get_state(self) -> dict:
        return {"round": np.array([self.cursor], np.int64)}

    def set_state(self, state: dict) -> None:
        self.cursor = int(np.asarray(state["round"]).reshape(-1)[0])


def jax_upload_uniforms(key, shapes):
    """The uniforms ``repro.core.quantization.quantize_pytree(key, ...)``
    draws for leaves of ``shapes`` (in leaf order): one key per leaf from
    ``split(key, len(shapes))``."""
    keys = jax.random.split(key, len(shapes))
    return [_t(jax.random.uniform(k, tuple(s), jnp.float32)) for k, s in zip(keys, shapes)]


class UploadReplay:
    """The JAX ``FLExperiment``'s upload entropy: ``PRNGKey(seed)`` split
    once per scheduled client, in the order the clients upload."""

    def __init__(self, seed, device="cpu"):
        self.key = jax.random.PRNGKey(seed)
        self.device = device

    def upload_uniforms(self, shapes):
        self.key, sub = jax.random.split(self.key)
        return [u.to(self.device) for u in jax_upload_uniforms(sub, shapes)]


def jax_fl_round_uniforms(key, shapes, n_clients):
    """The uplink uniforms ``repro.launch.steps.make_fl_round``'s round
    draws from ``key``: ``split(key, K)[k]`` per client, split once per
    leaf (the packed wire's per-leaf keys and ``quantize_pytree``'s are the
    same), a uniform of each leaf's unstacked shape. [client][leaf]."""
    return [jax_upload_uniforms(k, shapes) for k in jax.random.split(key, n_clients)]


def jax_fl_downlink_uniforms(key, shapes, tag=13):
    """The round's downlink uniforms: ``fold_in(key, DOWNLINK_KEY_TAG)``
    split once per leaf, drawn at the unstacked shape with the
    partitionable threefry the round scopes them in."""
    keys = jax.random.split(jax.random.fold_in(key, tag), len(shapes))
    with jax.threefry_partitionable(True):
        return [_t(jax.random.uniform(k, tuple(s), jnp.float32)) for k, s in zip(keys, shapes)]


def _gloo_rank(rank, world, init_file, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, world: int, tmp_dir, *args, join: bool = True):
    """``fn(rank, world, *args)`` on ``world`` spawned processes joined in
    a gloo group (one torch thread each); ``fn`` must be a module-level
    function. Raises if any rank fails. ``join=False`` returns the running
    processes' context instead (``join_all`` waits for it)."""
    init_file = os.path.join(str(tmp_dir), f"gloo_{uuid.uuid4().hex}")
    return mp.spawn(_gloo_rank, args=(world, init_file, fn, args), nprocs=world, join=join)


def join_all(*contexts) -> None:
    """Wait for every context ``spawn_gloo(..., join=False)`` returned;
    raises if a rank failed."""
    for ctx in contexts:
        while not ctx.join():
            pass


def assert_adam_step_close(got, want, clipped, lr, *, grad_rel=1e-4, step_rel=1e-5,
                           eps=1e-8, share=0.99):
    """One adamw step's parameters ``got`` against ``want`` (lists of
    arrays, leaf order), each reached from the same state by gradients that
    agree to ``grad_rel`` of each leaf's largest magnitude (``clipped``:
    ``want``'s clipped gradients). Adam's first update is -lr f(g) - lr wd
    p, f(g) = g / (|g| + eps): where |g| is within a few eps of zero, f
    turns last-digit gradient differences into updates up to 2 lr apart.
    So each coordinate is held to ``step_rel`` of the leaf's largest
    magnitude plus lr min(2, delta eps / (max(|g| - delta, 0) + eps)^2),
    delta = grad_rel x the leaf's largest |g|; at least ``share`` of the
    coordinates must be within ``step_rel`` alone."""
    within, total = 0, 0
    for g, w, c in zip(got, want, clipped):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        c = np.abs(np.asarray(c, np.float64))
        delta = grad_rel * c.max()
        err = np.abs(g - w)
        plain = step_rel * np.abs(w).max()
        allowed = plain + lr * np.minimum(2.0, delta * eps / (np.maximum(c - delta, 0) + eps) ** 2)
        assert (err <= allowed).all(), float((err - allowed).max())
        within += int((err <= plain).sum())
        total += err.size
    assert within >= share * total, within / total
