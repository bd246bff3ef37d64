"""The port's greedy decision (``repro_torch.sim.policy``) against
``repro.sim.policy`` on the same fp32 rates, on the cases of
``tests/test_sim_policy.py``: identical assignment, slots, participation
and levels; f, energy, latency and the bound terms within rtol 1e-5 (fp32
transcendental functions differ in the last bits between XLA and torch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genetic import SystemParams as JSystemParams
from repro.sim import channel as jch
from repro.sim import policy as jpol
from repro.wireless.channel import ChannelModel, ChannelParams
from repro_torch.core.genetic import SystemParams as TSystemParams
from repro_torch.sim import channel as tch
from repro_torch.sim import policy as tpol
from repro_torch.wireless.channel import ChannelParams as TChannelParams

JSYSP, TSYSP = JSystemParams(), TSystemParams()
# jitted references: op-by-op JAX re-dispatches every loop step
J_DECIDE = jax.jit(jpol.decide, static_argnums=(6, 7, 8))
J_SOLVE_KKT = jax.jit(jpol.solve_kkt, static_argnums=(5, 6, 7), static_argnames=("q_cap",))


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("u,c,seed", [(8, 8, 0), (12, 6, 1), (5, 9, 2), (32, 16, 3)])
def test_greedy_assign_and_slots_match(u, c, seed):
    rates = ChannelModel(ChannelParams(n_clients=u, n_channels=c), seed=seed).draw_rates()
    want = np.asarray(jpol.greedy_assign(jnp.asarray(rates, jnp.float32)))
    got = tpol.greedy_assign(_f32(rates)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpol.greedy_assign_host(rates), jpol.greedy_assign_host(rates))
    kept = np.where(np.arange(c) % 3 == 1, -1, want)
    np.testing.assert_array_equal(
        tpol.compact_slots(torch.tensor(kept), u).numpy(),
        np.asarray(jpol.compact_slots(jnp.asarray(kept, jnp.int32), u)))
    np.testing.assert_array_equal(tpol.compact_slots_host(kept, u),
                                  jpol.compact_slots_host(kept, u))


@pytest.mark.parametrize("z,lam2,vw", [
    (246590, 50.0, 100.0),    # FEMNIST payload, mid-training queue
    (246590, 500.0, 100.0),   # heavy queue
    (576778, 120.0, 1000.0),  # CIFAR payload, large V
    (5122, 20.0, 100.0),      # tiny model: cases collapse to the cap
])
def test_solve_kkt_matches(z, lam2, vw):
    rng = np.random.default_rng(z % 97 + int(lam2))
    n = 160
    v, w = rng.uniform(3e7, 3e8, n), rng.uniform(0.02, 0.3, n)
    d, th = rng.uniform(100, 3000, n), rng.uniform(0.01, 3.0, n)
    jq, jf, jfeas, jqh = J_SOLVE_KKT(
        jnp.asarray(v, jnp.float32), jnp.asarray(w, jnp.float32),
        jnp.asarray(d, jnp.float32), jnp.asarray(th, jnp.float32),
        jnp.float32(lam2), JSYSP, z, vw, q_cap=8)
    tq, tf, tfeas, tqh = tpol.solve_kkt(_f32(v), _f32(w), _f32(d), _f32(th),
                                        torch.tensor(lam2, dtype=torch.float32),
                                        TSYSP, z, vw, q_cap=8)
    np.testing.assert_array_equal(tfeas.numpy(), np.asarray(jfeas))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(tqh.numpy(), np.asarray(jqh), rtol=1e-5)


def _context(u, seed):
    rng = np.random.default_rng(seed)
    rates = ChannelModel(ChannelParams(n_clients=u, n_channels=u), seed=seed).draw_rates()
    d = np.maximum(rng.normal(1200, 300, u), 50)
    g = rng.uniform(0.5, 2.0, u); g /= g.mean()
    s = rng.uniform(0.5, 2.0, u); s /= s.mean()
    th = rng.uniform(0.2, 1.5, u)
    return rates, d, g, s, th, float(rng.uniform(0, 300))


def _compare_decisions(jd, td):
    for k in ("assign", "slots", "a", "q"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                      err_msg=k)
    for k in ("f", "energy", "latency", "v_assigned", "data_term", "quant_term",
              "payload_bits"):
        np.testing.assert_allclose(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("z,seed", [(5122, 0), (246590, 7), (246590, 11)])
def test_decide_matches_fixed_contexts(z, seed):
    rates, d, g, s, th, lam2 = _context(8, seed)
    j_args = [jnp.asarray(a, jnp.float32) for a in (rates, d, g, s, th)]
    jd = J_DECIDE(*j_args, jnp.float32(lam2), JSYSP, z, 100.0)
    td = tpol.decide(*[_f32(a) for a in (rates, d, g, s, th)],
                     torch.tensor(lam2, dtype=torch.float32), TSYSP, z, 100.0)
    _compare_decisions(jd, td)
    hetero = 1.0 + np.random.default_rng(seed).uniform(0, 1, 8)
    jd = J_DECIDE(*j_args, jnp.float32(lam2), JSYSP, z, 100.0,
                     hetero=jnp.asarray(hetero, jnp.float32))
    td = tpol.decide(*[_f32(a) for a in (rates, d, g, s, th)],
                     torch.tensor(lam2, dtype=torch.float32), TSYSP, z, 100.0,
                     hetero=_f32(hetero))
    _compare_decisions(jd, td)


def test_decide_drops_infeasible_clients():
    u, z = 6, 246590
    rates = ChannelModel(ChannelParams(n_clients=u, n_channels=u), seed=1).draw_rates()
    rates[2, :] = 1e6   # ~1 Mbit/s: 2 Z bits cannot fit in 20 ms
    d, ones = np.full(u, 1000.0), np.ones(u)
    jd = J_DECIDE(*[jnp.asarray(a, jnp.float32) for a in (rates, d, ones, ones, ones)],
                     jnp.float32(50.0), JSYSP, z, 100.0)
    td = tpol.decide(*[_f32(a) for a in (rates, d, ones, ones, ones)],
                     torch.tensor(50.0), TSYSP, z, 100.0)
    _compare_decisions(jd, td)
    assert int(td.a[2]) == 0 and float(td.energy[2]) == 0.0
    assert 2 not in td.slots.tolist()


@pytest.mark.parametrize("u,c,seed", [(8, 4, 0), (16, 8, 3)])
def test_draw_rates_from_reference_normals(u, c, seed):
    model = ChannelModel(ChannelParams(n_clients=u, n_channels=c), seed=seed)
    dist = jnp.asarray(model.distances, jnp.float32)[None, :]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jch.draw_rates(key, model.params, dist, "best"))
    kx, ky = jax.random.split(key)
    nx = np.array(jax.random.normal(kx, (1, u, c)))
    ny = np.array(jax.random.normal(ky, (1, u, c)))
    got = tch.draw_rates(torch.from_numpy(nx), torch.from_numpy(ny),
                         TChannelParams(n_clients=u, n_channels=c),
                         torch.tensor(np.asarray(dist)), "best")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
