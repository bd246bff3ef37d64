"""The quantized server->client downlink in the port (``DownlinkConfig``,
``FleetSim._downlink_apply``, ``core.quantization.quantize_array``, the
``dl_term`` of the QCCF decisions) against ``repro.sim.engine``.

  * ``quantize_array`` is bit-equal to the JAX function for the same
    uniforms, and the broadcast's next-round term is bit-equal to the JAX
    engine's and equals ``bounds.downlink_term`` within rtol 1e-6;
  * ``quant`` and ``delta`` runs (greedy, and the GA with ``delta``)
    against the JAX engine on its own draws (U = 8, C = 4, 3 rounds): q and
    schedule identical, energy within rtol 1e-5, queues within rtol 1e-4
    plus one fp32 ulp of their epsilon per round, loss within rtol 1e-3,
    accuracy within 1/64, the final (broadcast) model within 1e-5 on every
    coordinate;
  * the port's compiled run equals its ``run_host_policy`` replay bit for
    bit in the model;
  * off leaves the draws as they were: ``downlink="off"`` equals no
    downlink bit for bit, and a run with the downlink on sees the same
    first round.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jquant
from repro.core.genetic import GAConfig as JGAConfig
from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro_torch.core import bounds
from repro_torch.core import quantization as tquant
from repro_torch.core.genetic import GAConfig, RoundContext
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from repro_torch.sim import policy as tpol
from torch_replay import ReplayEntropy, one_torch_thread  # noqa: F401 (autouse fixture)

U, C, ROUNDS, SEED = 8, 4, 3, 3
GA_KW = dict(generations=4, population=8, elitism=2, repair_infeasible=True)


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(SEED)))


CASES = {
    "quant": ({"downlink": "quant"}, {"downlink": "quant"}),
    "delta": ({"downlink": "delta"}, {"downlink": "delta"}),
    "ga-delta-q4": (
        {"downlink": jeng.DownlinkConfig("delta", 4), "policy_mode": "compiled-ga",
         "ga_config": JGAConfig(**GA_KW)},
        {"downlink": teng.DownlinkConfig("delta", 4), "policy_mode": "compiled-ga",
         "ga_config": GAConfig(**GA_KW)}),
}


@functools.lru_cache(maxsize=None)
def _runs(case):
    jkw, tkw = CASES[case]
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64)
    jsim = jeng.build_sim("tiny", **kw, **jkw)
    jres = jsim.run_compiled(ROUNDS)
    tsim = teng.build_sim("tiny", device="cpu",
                          init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                          entropy=ReplayEntropy(jsim, ROUNDS), **kw, **tkw)
    return jsim, jres, tsim, tsim.run_compiled(ROUNDS)


# ------------------------------------------------------------- the wire

@pytest.mark.parametrize("q_bits", [1, 2, 8, 16])
def test_quantize_array_bit_equal(q_bits):
    rng = np.random.default_rng(q_bits)
    x = rng.normal(0.0, 0.3, 5122).astype(np.float32)
    key = jax.random.PRNGKey(q_bits)
    want, want_theta = jquant.quantize_array(key, jnp.asarray(x), q_bits)
    u01 = torch.tensor(np.asarray(jax.random.uniform(key, x.shape, jnp.float32)))
    got, theta = tquant.quantize_array(u01, torch.from_numpy(x), q_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert theta.item() == float(want_theta)
    # the all-zero vector stays zero with a zero range
    zeros, t0 = tquant.quantize_array(u01, torch.zeros(5122), q_bits)
    assert t0.item() == 0.0 and not zeros.any()


def test_payload_and_variance_bound():
    assert tquant.payload_bits(246590, 8) == jquant.payload_bits(246590, 8) == 246590 * 9 + 32
    for q in (1, 4, 8):
        assert tquant.variance_bound(5122, 0.3, q).item() == float(
            jquant.variance_bound(5122, 0.3, q))


def test_downlink_config_validation():
    assert teng.DownlinkConfig().mode == "off" and not teng.DownlinkConfig().enabled
    assert teng.DOWNLINK_OFF == teng.DownlinkConfig()
    assert teng.DownlinkConfig(mode="delta", q_bits=4).enabled
    with pytest.raises(ValueError):
        teng.DownlinkConfig(mode="fp8")
    with pytest.raises(ValueError):
        teng.DownlinkConfig(mode="quant", q_bits=0)
    with pytest.raises(ValueError):
        teng.DownlinkConfig(mode="quant", q_bits=17)
    sim = teng.build_sim("tiny", n_clients=4, n_channels=2, n_test=8, device="cpu",
                         downlink="delta")
    assert sim.downlink == teng.DownlinkConfig("delta", 8)


@pytest.mark.parametrize("mode,q_bits", [("quant", 8), ("delta", 8), ("delta", 2)])
def test_downlink_apply_matches_reference(mode, q_bits):
    """The broadcast and its next-round term: bit-equal to the JAX engine's
    ``_downlink_apply`` on the same uniforms; the term is the formula of
    ``bounds.downlink_term`` at the broadcast range."""
    jsim = jeng.build_sim("tiny", n_clients=4, n_channels=2, seed=0, n_test=8,
                          downlink=jeng.DownlinkConfig(mode, q_bits))
    tsim = teng.build_sim("tiny", n_clients=4, n_channels=2, seed=0, n_test=8, device="cpu",
                          downlink=teng.DownlinkConfig(mode, q_bits))
    rng = np.random.default_rng(5)
    flat = (rng.normal(size=tsim.z) * 0.3).astype(np.float32)
    new = flat + (rng.normal(size=tsim.z) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jb, jdl = jsim._downlink_apply(key, jnp.asarray(new), jnp.asarray(flat))
    u01 = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, jeng.DOWNLINK_KEY_TAG), (tsim.z,), jnp.float32)))
    tb, tdl = tsim._downlink_apply(u01, torch.from_numpy(new), torch.from_numpy(flat))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tdl.dtype == torch.float32 and tdl.item() == float(jdl)
    theta = float(np.abs(new if mode == "quant" else new - flat).max())
    want = bounds.downlink_term(tsim.sysp.bound_constants(), tsim.z, theta, q_bits)
    assert tdl.item() == pytest.approx(want, rel=1e-6)
    step = theta / (2**q_bits - 1)
    assert np.abs(tb.numpy() - new).max() <= step * (1 + 1e-5)


def test_dl_term_shifts_quant_term_only():
    """The term is added to the quant term and to nothing else: same
    schedule, same q, quant term up by exactly the term, on the device
    decision and on the host oracles (the runs against the JAX engine
    below hold the term's value)."""
    rng = np.random.default_rng(0)
    rates = (rng.random((U, C)) * 2e6 + 2e6).astype(np.float32)
    d = rng.integers(100, 300, U).astype(np.float32)
    ones = np.ones(U, np.float32)
    sim = teng.build_sim("tiny", n_clients=U, n_channels=C, seed=1, n_test=8, device="cpu")
    z, sysp = sim.z, sim.sysp
    t_args = [torch.from_numpy(a) for a in (rates, d, ones, ones, ones)]
    base = tpol.decide(*t_args, torch.tensor(50.0), sysp, z, 100.0)
    dl = torch.tensor(0.125)
    shifted = tpol.decide(*t_args, torch.tensor(50.0), sysp, z, 100.0, dl_term=dl)
    assert torch.equal(base.q, shifted.q) and torch.equal(base.a, shifted.a)
    assert base.a.sum() > 0
    assert shifted.quant_term.item() == pytest.approx(base.quant_term.item() + 0.125)

    def ctx():
        return RoundContext(rates=rates.astype(np.float64), d_sizes=d.astype(np.float64),
                            g_sq=np.ones(U), sigma_sq=np.ones(U), theta_max=np.ones(U), z=z)

    draws = teng.DeviceEntropy(1, "cpu").ga_draws(0, U, C, sim.ga_config)
    for make in (sim.make_host_policy, sim.make_host_ga_policy):
        pol_a, pol_b = make(), make()
        for pol in (pol_a, pol_b):      # non-empty queues: the GA's cold start schedules nobody
            pol.lambda1 = pol.lambda2 = 30.0
        pol_b.set_downlink_term(0.125)
        if hasattr(pol_a, "set_round_draws"):
            pol_a.set_round_draws(draws)
            pol_b.set_round_draws(draws)
        dec_a, dec_b = pol_a.decide(ctx()), pol_b.decide(ctx())
        np.testing.assert_array_equal(dec_a.a, dec_b.a)
        np.testing.assert_array_equal(dec_a.q, dec_b.q)
        assert dec_a.a.sum() > 0
        assert dec_b.quant_term == pytest.approx(dec_a.quant_term + 0.125)


# ----------------------------------------------------------- end to end

def _queue_atol(eps):
    return ROUNDS * float(np.spacing(np.float32(eps)))


@pytest.mark.parametrize("case", list(CASES))
def test_downlink_run_matches_reference(case):
    jsim, jres, tsim, tres = _runs(case)
    np.testing.assert_array_equal(tres.q_levels, jres.q_levels)
    np.testing.assert_array_equal(tres.n_scheduled, jres.n_scheduled)
    np.testing.assert_array_equal(tres.rates > 0, jres.rates > 0)
    for k in ("energy", "latency", "payload_bits"):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for k, eps in (("lambda1", jsim.eps1), ("lambda2", jsim.eps2)):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-4,
                                   atol=_queue_atol(eps), err_msg=k)
    np.testing.assert_allclose(tres.loss, jres.loss, rtol=1e-3)
    assert np.abs(tres.accuracy - jres.accuracy).max() <= 1.0 / 64
    np.testing.assert_allclose(tsim.final_flat.numpy(), np.asarray(jsim.final_flat), rtol=0,
                               atol=1e-5)
    assert tres.n_scheduled.max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_downlink_run_equals_host_replay(case):
    _jkw, tkw = CASES[case]
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64, device="cpu", **tkw)
    scan_sim = teng.build_sim("tiny", **kw)
    scan = scan_sim.run_compiled(ROUNDS)
    sim = teng.build_sim("tiny", **kw)
    host = sim.run_host_policy(sim.make_host_policy(), ROUNDS)
    np.testing.assert_array_equal(scan.q_levels, np.stack([r.q_levels for r in host.records]))
    np.testing.assert_array_equal(scan.n_scheduled, [r.n_scheduled for r in host.records])
    np.testing.assert_allclose(scan.energy, [r.energy for r in host.records], rtol=1e-5,
                               atol=1e-12)
    assert np.max(np.abs(np.array([r.accuracy for r in host.records]) - scan.accuracy)) <= 1e-6
    assert torch.equal(scan_sim.final_flat, sim.final_flat)


def test_downlink_off_leaves_the_draws():
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64, device="cpu")
    none_sim = teng.build_sim("tiny", **kw)
    off_sim = teng.build_sim("tiny", downlink="off", **kw)
    assert not off_sim.downlink.enabled and len(off_sim._init_carry()) == 6
    a, b = none_sim.run_compiled(2), off_sim.run_compiled(2)
    for f in ("energy", "accuracy", "loss", "q_levels", "lambda1", "lambda2", "rates"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert torch.equal(none_sim.final_flat, off_sim.final_flat)
    assert torch.equal(none_sim.entropy.generator.get_state(),
                       off_sim.entropy.generator.get_state())
    # with the broadcast on, round 0 decides before any broadcast error
    # exists and draws the same rates, batches and uplink uniforms
    on = teng.build_sim("tiny", downlink="quant", **kw).run_compiled(1, with_eval=False)
    np.testing.assert_array_equal(on.q_levels[0], a.q_levels[0])
    assert on.energy[0] == a.energy[0] and on.lambda1[0] == a.lambda1[0]
