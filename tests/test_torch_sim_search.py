"""The port's population search (``repro_torch.sim.search``) against
``repro.sim.search`` on the same draws: the JAX key schedule's draws
(``torch_replay.jax_ga_draws``) feed the port's operators, its compiled GA
and its numpy oracle.

Tolerances: the operators are integer maps, equal. ``evaluate_population``'s
J0 within rtol 1e-6 (fp32 on both sides; the transcendental functions differ
in the last bits between XLA and torch). The GA's winning assignment,
participation and q are equal; energy within rtol 1e-5 against the JAX
compiled GA and 1e-4 against the f64 host oracle (as in
``tests/test_sim_search.py``); the port's numpy oracle equals the JAX
package's (the same f64 code on the same draws).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genetic import GAConfig as JGAConfig
from repro.core.genetic import SystemParams as JSystemParams
from repro.sim import search as jsearch
from repro.wireless.channel import ChannelModel, ChannelParams
from repro_torch.core.genetic import GAConfig, SystemParams
from repro_torch.sim import search as tsearch
from repro_torch.sim.entropy import DeviceEntropy
from torch_replay import jax_ga_draws, one_torch_thread  # noqa: F401 (autouse fixture)

JSYSP, TSYSP = JSystemParams(), SystemParams()


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _context(u, c, seed, kill=None):
    rng = np.random.default_rng(seed)
    rates = ChannelModel(ChannelParams(n_clients=u, n_channels=c), seed=seed).draw_rates()
    if kill is not None:
        rates[kill, :] = 1e6  # ~1 Mbit/s: cannot carry Z bits in T_max
    d = np.maximum(rng.normal(1200, 300, u), 50)
    g = rng.uniform(0.5, 2.0, u); g /= g.mean()
    s = rng.uniform(0.5, 2.0, u); s /= s.mean()
    th = rng.uniform(0.2, 1.5, u)
    return rates, d, g, s, th


def _cfgs(**kw):
    return JGAConfig(**kw), GAConfig(**kw)


# ------------------------------------------------------------- operators

@pytest.mark.parametrize("seed,u,c", [(0, 6, 6), (1, 12, 4), (2, 3, 9), (3, 10, 10)])
def test_repair_duplicates_matches(seed, u, c):
    raw = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (16, c), -1, u))
    want = np.asarray(jax.vmap(jsearch.repair_duplicates)(jnp.asarray(raw, jnp.int32)))
    got = tsearch.repair_duplicates(torch.from_numpy(raw.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    for row, w in zip(raw.astype(np.int64), want):
        np.testing.assert_array_equal(tsearch.repair_duplicates_host(row), w)
        np.testing.assert_array_equal(tsearch.repair_duplicates(torch.from_numpy(row)).numpy(), w)


@pytest.mark.parametrize("u,c,seed", [(8, 8, 0), (5, 9, 1), (12, 4, 2)])
def test_random_assignment_matches(u, c, seed):
    _jcfg, cfg = _cfgs(population=10, generations=2)
    key = jax.random.PRNGKey(seed)
    draws = jax_ga_draws(key, u, c, cfg)
    got = tsearch.random_assignment(draws.n_sched, draws.perm_u, draws.perm_c).numpy()
    k_init, _ = jax.random.split(key)
    for i, ki in enumerate(jax.random.split(k_init, cfg.population)):
        want = np.asarray(jsearch.random_assignment(ki, u, c))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(jsearch.random_assignment_host(ki, u, c), want)
        np.testing.assert_array_equal(
            tsearch.random_assignment_host(int(draws.n_sched[i]), draws.perm_u[i].numpy(),
                                           draws.perm_c[i].numpy(), c), want)


@pytest.mark.parametrize("u,c,seed,pm", [(8, 8, 0, 0.08), (6, 9, 1, 0.3), (10, 5, 2, 0.5)])
def test_next_generation_matches(u, c, seed, pm):
    jcfg, cfg = _cfgs(population=10, generations=3, elitism=2, p_mutation=pm)
    key = jax.random.PRNGKey(seed)
    draws = jax_ga_draws(key, u, c, cfg)
    k_init, k_evolve = jax.random.split(key)
    pop = jax.vmap(lambda k: jsearch.random_assignment(k, u, c))(
        jax.random.split(k_init, cfg.population))
    # j0 with ties (duplicated values) to exercise argmin/argsort order
    j0 = np.round(np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + 7), (10,))), 1)
    j0[3] = np.inf
    tpop = torch.from_numpy(np.asarray(pop).astype(np.int64))
    for g, kg in enumerate(jax.random.split(k_evolve, cfg.generations)):
        want = np.asarray(jsearch.next_generation(kg, pop, jnp.asarray(j0, jnp.float32),
                                                  jcfg, u))
        got = tsearch.next_generation(tpop, _f32(j0), draws, g, cfg).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("z,seed,lam1,lam2,repair,kill", [
    (5122, 1, 5.0, 20.0, False, None),
    (246590, 7, 30.0, 150.0, True, None),
    (246590, 4, 10.0, 60.0, False, 5),
    (576778, 5, 1.0, 120.0, True, None),
])
def test_evaluate_population_matches(z, seed, lam1, lam2, repair, kill):
    u = c = 8
    rates, d, g, s, th = _context(u, c, seed, kill=kill)
    _jcfg, cfg = _cfgs(population=16, generations=1)
    draws = jax_ga_draws(jax.random.PRNGKey(seed), u, c, cfg)
    pop = tsearch.random_assignment(draws.n_sched, draws.perm_u, draws.perm_c)
    hetero = 1.0 + np.random.default_rng(seed).uniform(0, 1, u)
    want = np.asarray(jax.jit(functools.partial(
        jsearch.evaluate_population, sysp=JSYSP, z=z, v_weight=100.0, q_cap=8,
        repair_infeasible=repair))(
        jnp.asarray(pop.numpy(), jnp.int32),
        *[jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)],
        lam1=jnp.float32(lam1), lam2=jnp.float32(lam2),
        hetero=jnp.asarray(hetero, jnp.float32)))
    got = tsearch.evaluate_population(
        pop, *[_f32(a) for a in (rates, d, g, s, th)],
        torch.tensor(lam1), torch.tensor(lam2), TSYSP, z, 100.0, 8, repair,
        hetero=_f32(hetero)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)
    if kill is not None and not repair:
        assert not fin.all()


# ------------------------------------------------------------------ the GA

def _run_all(z, seed, lam1, lam2, repair, kill=None, u=8, c=8):
    """JAX compiled + JAX host GA on one key; the port's compiled + host GA
    on that key's draws."""
    rates, d, g, s, th = _context(u, c, seed, kill=kill)
    jcfg, cfg = _cfgs(generations=5, population=10, elitism=2, repair_infeasible=repair)
    key = jax.random.PRNGKey(seed + 100)
    draws = jax_ga_draws(key, u, c, cfg)
    j_host = jsearch.run_ga_host(key, rates, d, g, s, th, lam1, lam2, JSYSP, z, 100.0, cfg=jcfg)
    j_comp = jax.jit(functools.partial(jsearch.ga_decide, sysp=JSYSP, z=z, v_weight=100.0,
                                       cfg=jcfg))(
        key, *[jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)],
        lam1=jnp.float32(lam1), lam2=jnp.float32(lam2))
    t_host = tsearch.run_ga_host(draws, rates, d, g, s, th, lam1, lam2, TSYSP, z, 100.0,
                                 cfg=cfg)
    t_comp = tsearch.ga_decide(draws, *[_f32(a) for a in (rates, d, g, s, th)],
                               torch.tensor(lam1), torch.tensor(lam2), TSYSP, z, 100.0,
                               cfg=cfg)
    return j_host, j_comp, t_host, t_comp


def _assert_ga(j_host, j_comp, t_host, t_comp):
    for k in ("assign", "a", "q"):
        want = np.asarray(getattr(j_comp, k))
        np.testing.assert_array_equal(getattr(t_comp, k).numpy(), want, err_msg=k)
        np.testing.assert_array_equal(getattr(t_host, k), getattr(j_host, k), err_msg=k)
        np.testing.assert_array_equal(getattr(t_host, k), want, err_msg=k)
    for k in ("f", "energy", "latency", "data_term", "quant_term", "payload_bits"):
        np.testing.assert_array_equal(getattr(t_host, k), getattr(j_host, k), err_msg=k)
        np.testing.assert_allclose(getattr(t_comp, k).numpy(), np.asarray(getattr(j_comp, k)),
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(t_host.energy, t_comp.energy.numpy(), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("z,seed,lam1,lam2,repair,kill", [
    (5122, 1, 5.0, 20.0, False, None),     # tiny model, light queues
    (246590, 7, 30.0, 150.0, True, None),  # FEMNIST payload, repair mode
    (246590, 2, 10.0, 60.0, True, 2),      # infeasible client dropped
    (246590, 4, 10.0, 60.0, False, 5),     # infeasible -> fitness 0
    (576778, 5, 1.0, 120.0, True, None),   # CIFAR payload
])
def test_ga_matches_reference(z, seed, lam1, lam2, repair, kill):
    res = _run_all(z, seed, lam1, lam2, repair, kill=kill)
    _assert_ga(*res)
    if kill is not None:
        assert int(res[3].a[kill]) == 0 and res[2].a[kill] == 0


@pytest.mark.parametrize("u,c", [(6, 9), (10, 6)])
def test_ga_rectangular_channel_matrix(u, c):
    res = _run_all(246590, 13, 20.0, 90.0, True, u=u, c=c)
    _assert_ga(*res)
    assert int(res[3].a.sum()) <= min(u, c)


def test_ga_all_infeasible_schedules_nobody():
    u = c = 6
    z = 246590
    rates = np.full((u, c), 1e6)
    d, ones = np.full(u, 1000.0), np.ones(u)
    jcfg, cfg = _cfgs(generations=3, population=8, repair_infeasible=False)
    key = jax.random.PRNGKey(0)
    draws = jax_ga_draws(key, u, c, cfg)
    j_host = jsearch.run_ga_host(key, rates, d, ones, ones, ones, 10.0, 50.0, JSYSP, z,
                                 100.0, cfg=jcfg)
    t_host = tsearch.run_ga_host(draws, rates, d, ones, ones, ones, 10.0, 50.0, TSYSP, z,
                                 100.0, cfg=cfg)
    t_comp = tsearch.ga_decide(draws, *[_f32(a) for a in (rates, d, ones, ones, ones)],
                               torch.tensor(10.0), torch.tensor(50.0), TSYSP, z, 100.0,
                               cfg=cfg)
    assert int(j_host.a.sum()) == 0 and int(t_host.a.sum()) == 0 and int(t_comp.a.sum()) == 0
    assert np.all(t_host.assign == -1) and bool((t_comp.assign == -1).all())
    assert bool((t_comp.slots == -1).all())


def test_ga_on_device_entropy_matches_host_oracle():
    """The port's own draws (DeviceEntropy): compiled GA == numpy oracle,
    and the winner respects C1-C5."""
    u, c, z = 12, 6, 246590
    rates, d, g, s, th = _context(u, c, 3)
    cfg = GAConfig(generations=6, population=12, elitism=2, repair_infeasible=True)
    draws = DeviceEntropy(3, "cpu").ga_draws(0, u, c, cfg)
    assert sorted(draws.perm_u[0].tolist()) == list(range(u))
    host = tsearch.run_ga_host(draws, rates, d, g, s, th, 20.0, 90.0, TSYSP, z, 100.0, cfg=cfg)
    comp = tsearch.ga_decide(draws, *[_f32(a) for a in (rates, d, g, s, th)],
                             torch.tensor(20.0), torch.tensor(90.0), TSYSP, z, 100.0, cfg=cfg)
    for k in ("assign", "a", "q", "slots"):
        np.testing.assert_array_equal(getattr(comp, k).numpy(), getattr(host, k), err_msg=k)
    np.testing.assert_allclose(comp.energy.numpy(), host.energy, rtol=1e-4, atol=1e-12)
    assign = comp.assign.numpy()
    used = assign[assign >= 0]
    assert len(set(used.tolist())) == len(used) > 0
    a = comp.a.numpy().astype(bool)
    q, f, lat = comp.q.numpy(), comp.f.numpy(), comp.latency.numpy()
    assert np.all((q[a] >= 1) & (q[a] <= 8)) and np.all(q[~a] == 0)
    assert np.all(f[a] >= TSYSP.f_min * (1 - 1e-6)) and np.all(f[a] <= TSYSP.f_max * (1 + 1e-6))
    assert np.all(lat[a] <= TSYSP.t_max * (1 + 1e-5))


def test_ga_refuses_what_is_not_ported():
    u, c = 4, 3
    rates, d, g, s, th = _context(u, c, 0)
    cfg = GAConfig(generations=2, population=4)
    draws = DeviceEntropy(0, "cpu").ga_draws(0, u, c, cfg)
    args = [_f32(a) for a in (rates, d, g, s, th)] + [torch.tensor(1.0), torch.tensor(1.0),
                                                      TSYSP, 5122, 100.0]
    # with_stats is ported: the decision is the stat-free one, plus the taps
    plain = tsearch.ga_decide(draws, *args, cfg=cfg)
    for fn in (tsearch.ga_decide, tsearch.baseline_same_size):
        fd, stats = fn(draws, *args, cfg=cfg, with_stats=True)
        assert set(stats) == {"ga_best", "ga_median"}
        assert all(v.shape == () and v.dtype == torch.float32 for v in stats.values())
        assert float(stats["ga_best"]) <= float(stats["ga_median"])
    fd, _ = tsearch.ga_decide(draws, *args, cfg=cfg, with_stats=True)
    assert torch.equal(fd.assign, plain.assign) and torch.equal(fd.energy, plain.energy)
    with pytest.raises(ValueError, match="perm_u"):
        tsearch.ga_decide(DeviceEntropy(0, "cpu").ga_draws(0, u + 1, c, cfg), *args, cfg=cfg)
    with pytest.raises(AssertionError, match="two channels"):
        tsearch.ga_decide(draws, *[_f32(a[:, :1]) if a.ndim == 2 else a for a in args[:1]],
                          *args[1:], cfg=cfg)
