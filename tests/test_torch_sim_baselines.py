"""The paper's baselines in the port (``repro_torch.sim.policy``'s four
decision functions, ``repro_torch.sim.search.baseline_same_size``) against
``repro.sim``, and each mode's compiled run against its host replay.

  * at fixed contexts: ``account_baseline`` and the four baselines, the
    port against the JAX functions on the same fp32 inputs (and the GA's
    draws for SameSize): assignment, slots, participation and q equal;
    f, energy, latency, the bound terms and the payload within rtol 1e-5;
  * end to end (U = 8, seed 21, q_cap 16, 6 rounds, the JAX package's own
    draws through ``torch_replay.ReplayEntropy``): the port's
    ``run_compiled(mode)`` against the JAX package's ``run_compiled(mode)``:
    q and schedule equal; energy, latency and payload within rtol 1e-5; the
    Lyapunov queues within rtol 1e-4 plus one fp32 ulp of their epsilon per
    round (``_queue_atol``);
  * the port's ``run_compiled(mode) == run_host_policy(make_host_policy())``,
    as ``tests/test_sim_baselines.py`` holds the JAX package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genetic import GAConfig as JGAConfig
from repro.core.genetic import SystemParams as JSystemParams
from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro.sim import policy as jpol
from repro.sim import search as jsearch
from repro.wireless.channel import ChannelModel, ChannelParams
from repro_torch.core.genetic import GAConfig, SystemParams
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from repro_torch.sim import policy as tpol
from repro_torch.sim import search as tsearch
from torch_replay import ReplayEntropy, jax_ga_draws, one_torch_thread  # noqa: F401 (autouse fixture)

JSYSP, TSYSP = JSystemParams(), SystemParams()
SEED, U, ROUNDS = 21, 8, 6
GA_KW = dict(generations=6, population=10, repair_infeasible=True)


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _context(u, c, seed):
    rng = np.random.default_rng(seed)
    rates = ChannelModel(ChannelParams(n_clients=u, n_channels=c), seed=seed).draw_rates()
    d = np.maximum(rng.normal(1200, 300, u), 50)
    g = rng.uniform(0.5, 2.0, u); g /= g.mean()
    s = rng.uniform(0.5, 2.0, u); s /= s.mean()
    th = rng.uniform(0.2, 1.5, u)
    return rates, d, g, s, th


def _compare(jd, td):
    for k in ("assign", "slots", "a", "q"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                      err_msg=k)
    for k in ("f", "v_assigned", "energy", "latency", "data_term", "quant_term",
              "payload_bits", "q_cont"):
        np.testing.assert_allclose(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                   rtol=1e-5, atol=1e-12, err_msg=k)


# ------------------------------------------------------ fixed contexts

@pytest.mark.parametrize("z,seed,u,c,q_cap,drop_late", [
    (5122, 0, 8, 8, 16, False),
    (246590, 1, 10, 6, 16, True),
    (246590, 2, 6, 9, 8, True),
    (576778, 3, 8, 8, 8, False),
])
def test_account_baseline_matches(z, seed, u, c, q_cap, drop_late):
    rates, d, g, s, th = _context(u, c, seed)
    rng = np.random.default_rng(seed + 50)
    assign = tpol.greedy_assign_host(rates)
    assign[0] = -1
    q = rng.integers(1, 33, u).astype(np.float32)
    f = rng.uniform(TSYSP.f_min, TSYSP.f_max, u).astype(np.float32)
    jd = jax.jit(functools.partial(jpol.account_baseline, sysp=JSYSP, z=z, q_cap=q_cap,
                                   drop_late=drop_late))(
        jnp.asarray(assign, jnp.int32), *[jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)],
        q_raw=jnp.asarray(q), f=jnp.asarray(f))
    td = tpol.account_baseline(torch.from_numpy(assign), *[_f32(a) for a in (rates, d, g, s, th)],
                               _f32(q), _f32(f), TSYSP, z, q_cap, drop_late=drop_late)
    _compare(jd, td)
    assert int(td.a[assign[0] if assign[0] >= 0 else 0] >= 0)
    assert int(td.q.max()) <= q_cap


@pytest.mark.parametrize("z,seed,u,c", [(5122, 0, 8, 8), (246590, 4, 12, 6),
                                        (246590, 5, 5, 9)])
@pytest.mark.parametrize("mode", ["no_quant", "channel_allocate", "principle"])
def test_fast_baselines_match(mode, z, seed, u, c):
    rates, d, g, s, th = _context(u, c, seed)
    jargs = [jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)]
    targs = [_f32(a) for a in (rates, d, g, s, th)]
    if mode == "principle":
        for ridx in (0, 31, 65):
            jd = jax.jit(jpol.baseline_principle, static_argnums=(6, 7, 8))(
                jnp.int32(ridx), *jargs, JSYSP, z, 16)
            _compare(jd, tpol.baseline_principle(ridx, *targs, TSYSP, z, 16))
        return
    jfn = {"no_quant": jpol.baseline_no_quant,
           "channel_allocate": jpol.baseline_channel_allocate}[mode]
    tfn = {"no_quant": tpol.baseline_no_quant,
           "channel_allocate": tpol.baseline_channel_allocate}[mode]
    for q_cap in (8, 16):
        jd = jax.jit(jfn, static_argnums=(5, 6, 7))(*jargs, JSYSP, z, q_cap)
        _compare(jd, tfn(*targs, TSYSP, z, q_cap))


@pytest.mark.parametrize("z,seed,lam1,lam2", [(5122, 1, 5.0, 20.0), (246590, 7, 30.0, 150.0)])
def test_same_size_matches(z, seed, lam1, lam2):
    u = c = 8
    rates, d, g, s, th = _context(u, c, seed)
    jcfg, cfg = JGAConfig(**GA_KW), GAConfig(**GA_KW)
    key = jax.random.PRNGKey(seed)
    jd = jax.jit(functools.partial(jsearch.baseline_same_size, sysp=JSYSP, z=z,
                                   v_weight=100.0, cfg=jcfg, q_cap=16))(
        key, *[jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)],
        lam1=jnp.float32(lam1), lam2=jnp.float32(lam2))
    td = tsearch.baseline_same_size(jax_ga_draws(key, u, c, cfg),
                                    *[_f32(a) for a in (rates, d, g, s, th)],
                                    torch.tensor(lam1), torch.tensor(lam2), TSYSP, z, 100.0,
                                    cfg=cfg, q_cap=16)
    _compare(jd, td)


# ------------------------------------------------------------ end to end

MODES = ["no_quant", "channel_allocate", "principle", "same_size", "compiled-ga"]


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(SEED)))


@functools.lru_cache(maxsize=None)
def _runs(mode):
    """(JAX sim, its run_compiled, the port's run_compiled, the port's
    replay)."""
    kw = dict(n_clients=U, seed=SEED, q_cap=16, policy_mode=mode, n_test=64)
    jsim = jeng.build_sim("tiny", ga_config=JGAConfig(**GA_KW), **kw)
    jres = jsim.run_compiled(ROUNDS)

    def port():
        return teng.build_sim("tiny", ga_config=GAConfig(**GA_KW), device="cpu",
                              init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                              entropy=ReplayEntropy(jsim, ROUNDS), **kw)

    tres = port().run_compiled(ROUNDS)
    sim = port()
    hres = sim.run_host_policy(sim.make_host_policy(), ROUNDS, channel="sim")
    return jsim, jres, tres, hres


def _queue_atol(eps):
    """A queue is lambda + term - eps in fp32: where the term nearly cancels
    eps, one rounding of the term (its sum over clients runs in another
    order in XLA and torch) moves the queue by an ulp of eps. Over the
    run's rounds that is at most one such ulp per round."""
    return ROUNDS * float(np.spacing(np.float32(eps)))


@pytest.mark.parametrize("mode", MODES)
def test_run_compiled_matches_jax(mode):
    jsim, jres, tres, _ = _runs(mode)
    np.testing.assert_array_equal(tres.q_levels, jres.q_levels)
    np.testing.assert_array_equal(tres.n_scheduled, jres.n_scheduled)
    np.testing.assert_array_equal(tres.rates > 0, jres.rates > 0)
    for k in ("energy", "latency", "payload_bits", "rates"):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for k, eps in (("lambda1", jsim.eps1), ("lambda2", jsim.eps2)):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-4,
                                   atol=_queue_atol(eps), err_msg=k)
    assert tres.n_scheduled.max() > 0
    assert tres.q_levels.max() <= 16


@pytest.mark.parametrize("mode", MODES)
def test_run_compiled_equals_host_replay(mode):
    _, _, tres, hres = _runs(mode)
    np.testing.assert_array_equal(tres.q_levels, np.stack([r.q_levels for r in hres.records]))
    np.testing.assert_array_equal(tres.n_scheduled, [r.n_scheduled for r in hres.records])
    for k in ("energy", "latency", "payload_bits"):
        np.testing.assert_allclose(getattr(tres, k), [getattr(r, k) for r in hres.records],
                                   rtol=1e-5, atol=1e-12, err_msg=k)
    acc_h = np.array([r.accuracy for r in hres.records])
    assert np.max(np.abs(acc_h - tres.accuracy)) <= 1e-6


def test_no_quant_pays_fp32_airtime():
    """NoQuant's energy is accounted at q = 32 while the recorded levels are
    clamped to the q_cap = 16 wire format."""
    nq = _runs("no_quant")[2]
    kw = dict(n_clients=U, seed=SEED, q_cap=16, n_test=64, device="cpu")
    greedy = teng.build_sim("tiny", **kw).run_compiled(4, with_eval=False)
    no_quant = teng.build_sim("tiny", policy_mode="no_quant", **kw).run_compiled(
        4, with_eval=False)
    assert np.all(nq.q_levels[nq.q_levels > 0] == 16)
    assert np.all(no_quant.q_levels[no_quant.q_levels > 0] == 16)
    assert no_quant.energy.sum() > 2.0 * greedy.energy.sum()
