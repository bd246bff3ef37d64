"""Scenarios in the port (``repro_torch.sim.scenario``, ``build_sim(scenario=)``)
against ``repro.sim.scenario`` and the JAX engine.

  * the dataclasses' validation and the preset registry, as
    ``tests/test_scenario.py`` holds the JAX package, and each preset equal
    to the JAX package's field by field;
  * the cell-free drop from the JAX package's own uniforms: distances within
    rtol 1e-6 (torch's and XLA's sin/cos differ in the last ulp), and the
    per-round rates of both associations from the JAX normals within rtol
    1e-6;
  * ``scenario="single_bs"`` equals ``scenario=None`` bit for bit;
  * each preset's ``run_compiled(3)`` against the JAX engine on its own
    draws (``torch_replay.ReplayEntropy``, U = 8, C = 4): q and schedule
    identical; energy, latency and payload within rtol 1e-5; the queues
    within rtol 1e-4 plus one fp32 ulp of their epsilon per round (as
    ``tests/test_torch_sim_baselines.py``); loss within rtol 1e-3, accuracy
    within 1/64 of the 64 test images (``tests/test_torch_sim_round.py``);
  * ``noniid_a01``'s heterogeneity vector, and the compiled run against
    ``run_host_policy`` under the cell-free and non-IID scenarios.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.sim import channel as jch
from repro.sim import engine as jeng
from repro.sim import scenario as jscen
from repro.wireless.channel import ChannelParams as JChannelParams
from repro_torch.models import cnn as tcnn
from repro_torch.sim import channel as tch
from repro_torch.sim import engine as teng
from repro_torch.sim import scenario as tscen
from repro_torch.wireless.channel import ChannelParams, ap_ring_layout
from torch_replay import ReplayEntropy, one_torch_thread  # noqa: F401 (autouse fixture)

U, C, ROUNDS, SEED = 8, 4, 3, 21
PRESETS = ["single_bs", "cellfree_a4", "noniid_a01", "single_bs_faulty"]


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(SEED)))


@functools.lru_cache(maxsize=None)
def _runs(preset):
    """(JAX sim, its run_compiled(3), the port's sim, its run_compiled(3)),
    the port on the JAX engine's draws."""
    kw = dict(scenario=preset, n_clients=U, n_channels=C, seed=SEED, n_test=64)
    jsim = jeng.build_sim("tiny", **kw)
    jres = jsim.run_compiled(ROUNDS)
    tsim = teng.build_sim("tiny", device="cpu",
                          init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                          entropy=ReplayEntropy(jsim, ROUNDS), **kw)
    return jsim, jres, tsim, tsim.run_compiled(ROUNDS)


# ------------------------------------------------------ dataclasses, registry

def test_scenario_validation():
    topo = tscen.Topology(ap_xy=np.zeros((1, 2)))
    ch = ChannelParams(n_clients=4, n_channels=4)
    with pytest.raises(ValueError, match="unknown policy"):
        tscen.Scenario(name="bad", topology=topo, channel=ch, policy="not_a_policy")
    with pytest.raises(ValueError, match="exactly one AP"):
        tscen.Topology(ap_xy=np.zeros((3, 2)), mode="single_bs")
    with pytest.raises(ValueError, match="association"):
        tscen.Topology(ap_xy=np.zeros((2, 2)), association="coherent")
    with pytest.raises(ValueError, match="mode"):
        tscen.Topology(ap_xy=np.zeros((2, 2)), mode="mesh")
    with pytest.raises(ValueError, match=r"\(A, 2\)"):
        tscen.Topology(ap_xy=np.zeros((2, 3)), mode="cellfree")
    sc = tscen.Scenario(name="ok", topology=topo, channel=ch)
    assert sc.with_policy("no_quant").policy == "no_quant"
    assert sc.with_fleet(16, 8).channel.n_clients == 16
    assert sc.with_fleet(16, 8).channel.n_channels == 8
    assert sc.with_faults(tscen.FaultSpec(nan_p=0.1)).faults.nan_p == 0.1
    assert tscen.POLICIES == jscen.POLICIES and tscen.ASSOCIATIONS == jscen.ASSOCIATIONS


def test_registry_presets():
    assert tscen.scenario_names() == jscen.scenario_names() == sorted(PRESETS)
    sc = tscen.get_scenario("cellfree_a4", n_clients=32, n_channels=4)
    assert sc.channel.n_clients == 32 and sc.channel.n_channels == 4
    assert sc.topology.n_aps == 4 and sc.topology.association == "combine"
    assert tscen.get_scenario("single_bs", n_clients=12).channel.n_channels == 12
    with pytest.raises(KeyError):
        tscen.get_scenario("no_such_scenario")


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_equal_reference(preset):
    t = tscen.get_scenario(preset, n_clients=10, n_channels=3)
    j = jscen.get_scenario(preset, n_clients=10, n_channels=3)
    assert (t.name, t.policy) == (j.name, j.policy)
    np.testing.assert_array_equal(t.topology.ap_xy, j.topology.ap_xy)
    assert (t.topology.mode, t.topology.association) == (j.topology.mode, j.topology.association)
    for field in ("channel", "data", "lyapunov", "faults"):
        assert dataclasses.asdict(getattr(t, field)) == dataclasses.asdict(getattr(j, field)), field


def test_register_scenario_builds_through_build_sim():
    def wide_ring(n_clients, n_channels, **kw):
        params = ChannelParams(n_clients=n_clients, n_channels=n_channels)
        return tscen.Scenario(
            name="ring3", channel=params,
            topology=tscen.Topology(ap_xy=ap_ring_layout(3, 0.8 * params.radius_m),
                                    mode="cellfree", association="best"), **kw)

    tscen.register_scenario("ring3_test", wide_ring)
    try:
        sim = teng.build_sim("tiny", scenario="ring3_test", n_clients=6, n_channels=3,
                             n_test=16, device="cpu")
        assert sim.name == "sim_ring3_qccf" and tuple(sim.channel.distances.shape) == (3, 6)
        assert sim.channel.association == "best"
    finally:
        tscen._REGISTRY.pop("ring3_test")


# ------------------------------------------------------------------ channel

@pytest.mark.parametrize("association", ["best", "combine"])
def test_cellfree_drop_and_rates_match_reference(association):
    params = ChannelParams(n_clients=24, n_channels=5)
    jparams = JChannelParams(n_clients=24, n_channels=5)
    ap = ap_ring_layout(4, 0.5 * params.radius_m)
    jtopo = jscen.Topology(ap_xy=ap, mode="cellfree", association=association)
    ttopo = tscen.Topology(ap_xy=ap, mode="cellfree", association=association)
    key = jax.random.PRNGKey(7)
    k_r, k_phi = jax.random.split(key)
    u_r = torch.tensor(np.asarray(jax.random.uniform(k_r, (24,))))
    u_phi = torch.tensor(np.asarray(jax.random.uniform(k_phi, (24,))))
    jd = np.asarray(jtopo.drop(key, jparams))
    td = ttopo.drop(u_r, u_phi, params)
    assert td.dtype == torch.float32 and tuple(td.shape) == (4, 24)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    assert td.min().item() >= params.near_field_m
    # the round's rates on the reference's distances and normals
    k_ch = jax.random.PRNGKey(11)
    kx, ky = jax.random.split(k_ch)
    shape = (4, 24, 5)
    nx = torch.tensor(np.asarray(jax.random.normal(kx, shape)))
    ny = torch.tensor(np.asarray(jax.random.normal(ky, shape)))
    want = np.asarray(jch.draw_rates(k_ch, jparams, jd, association))
    got = tch.draw_rates(nx, ny, params, torch.tensor(jd), association)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    chan = tch.SimChannel.from_topology(u_r, u_phi, params, ttopo)
    assert chan.shape == shape and chan.association == association


def test_single_bs_drop_is_the_numpy_one():
    topo = tscen.Topology(ap_xy=np.zeros((1, 2)))
    with pytest.raises(ValueError, match="ChannelModel"):
        topo.drop(torch.rand(4), torch.rand(4), ChannelParams(n_clients=4))


# ------------------------------------------------------------------- engine

def test_single_bs_scenario_equals_no_scenario():
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64, device="cpu")
    legacy = teng.build_sim("tiny", **kw)
    scen = teng.build_sim("tiny", scenario="single_bs", **kw)
    assert scen.name == "sim_single_bs_qccf" and legacy.name == "sim_qccf"
    assert torch.equal(legacy.channel.distances, scen.channel.distances)
    assert (legacy.eps1, legacy.eps2) == (scen.eps1, scen.eps2)
    r0, r1 = legacy.run_compiled(2), scen.run_compiled(2)
    for f in ("accuracy", "loss", "energy", "q_levels", "n_scheduled", "rates", "lambda1",
              "lambda2", "latency", "payload_bits"):
        np.testing.assert_array_equal(getattr(r0, f), getattr(r1, f), err_msg=f)
    assert torch.equal(legacy.final_flat, scen.final_flat)


def _queue_atol(eps):
    return ROUNDS * float(np.spacing(np.float32(eps)))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_run_matches_reference(preset):
    jsim, jres, tsim, tres = _runs(preset)
    assert tsim.name == jsim.name
    np.testing.assert_allclose(tsim.channel.distances.numpy(), np.asarray(jsim.channel.distances),
                               rtol=1e-6)
    assert (tsim.eps1, tsim.eps2) == pytest.approx((jsim.eps1, jsim.eps2), rel=1e-6)
    np.testing.assert_array_equal(tres.q_levels, jres.q_levels)
    np.testing.assert_array_equal(tres.n_scheduled, jres.n_scheduled)
    np.testing.assert_array_equal(tres.rates > 0, jres.rates > 0)
    for k in ("energy", "latency", "payload_bits", "rates"):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for k, eps in (("lambda1", jsim.eps1), ("lambda2", jsim.eps2)):
        np.testing.assert_allclose(getattr(tres, k), getattr(jres, k), rtol=1e-4,
                                   atol=_queue_atol(eps), err_msg=k)
    np.testing.assert_allclose(tres.loss, jres.loss, rtol=1e-3)
    assert np.abs(tres.accuracy - jres.accuracy).max() <= 1.0 / 64
    assert tres.n_scheduled.max() > 0


def test_cellfree_sim_layout():
    _jsim, _jres, tsim, _tres = _runs("cellfree_a4")
    assert tsim.host_channel is None and tsim.channel.association == "combine"
    assert tuple(tsim.channel.distances.shape) == (4, U)
    with pytest.raises(ValueError, match="host ChannelModel"):
        tsim.run_host_policy(tsim.make_host_policy(), 1, channel="host")


def test_noniid_hetero_vector():
    jsim, _jres, tsim, _tres = _runs("noniid_a01")
    assert tsim.hetero is not None and tsim.hetero.shape == (U,)
    np.testing.assert_array_equal(tsim.hetero, jsim.hetero)
    assert tsim.hetero.min() >= 1.0 and tsim.hetero.max() > 1.0
    np.testing.assert_array_equal(tsim._hetero.numpy(), tsim.hetero.astype(np.float32))
    clean = teng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=16, device="cpu")
    assert clean.hetero is None


@pytest.mark.parametrize("preset", ["cellfree_a4", "noniid_a01"])
def test_scenario_run_equals_host_replay(preset):
    """The port's compiled run against its own numpy oracle on the default
    draws: the cell-free (A, U, C) rates and the heterogeneity multiplier
    reach both sides."""
    kw = dict(scenario=preset, n_clients=U, n_channels=C, seed=3, n_test=64, device="cpu")
    scan = teng.build_sim("tiny", **kw).run_compiled(ROUNDS)
    sim = teng.build_sim("tiny", **kw)
    host = sim.run_host_policy(sim.make_host_policy(), ROUNDS)
    np.testing.assert_array_equal(scan.q_levels, np.stack([r.q_levels for r in host.records]))
    np.testing.assert_array_equal(scan.n_scheduled, [r.n_scheduled for r in host.records])
    np.testing.assert_allclose(scan.energy, [r.energy for r in host.records], rtol=1e-5)
    acc = np.array([r.accuracy for r in host.records])
    assert np.max(np.abs(acc - scan.accuracy)) <= 1e-6


def test_scenario_overrides_and_policy():
    sim = teng.build_sim("tiny", scenario="noniid_a01", n_clients=6, n_channels=3, n_test=16,
                         device="cpu", hetero_weight=0.0, policy_mode="no_quant", q_cap=16)
    assert sim.hetero is None and sim.policy_mode == "no_quant"
    assert sim.name == "sim_noniid_a01_no_quant"
    ga = teng.build_sim("tiny", n_test=16, device="cpu",
                        scenario=tscen.get_scenario("single_bs", n_clients=6, n_channels=3,
                                                    policy="qccf_ga"))
    assert ga.policy_mode == "compiled-ga" and ga.name == "sim_single_bs_qccf_ga"
    assert ga.fleet.n_clients == 6 and ga.channel.params.n_channels == 3


@pytest.mark.parametrize("kwargs", [{"telemetry": object()}, {"ledger": object()}],
                         ids=["telemetry", "ledger"])
def test_telemetry_and_ledger_still_refused_under_a_scenario(kwargs):
    # both are ported: a scenario takes a MetricsConfig and a Ledger, and
    # refuses anything else of either name
    from repro_torch.obs import Ledger, MetricsConfig

    with pytest.raises(TypeError, match="MetricsConfig or None|Ledger or None"):
        teng.build_sim("tiny", scenario="cellfree_a4", n_clients=4, n_channels=2, n_test=8,
                       device="cpu", **kwargs)
    sim = teng.build_sim("tiny", scenario="cellfree_a4", n_clients=4, n_channels=2, n_test=8,
                         device="cpu", telemetry=MetricsConfig(enabled=True),
                         ledger=Ledger(None))
    assert sim.metrics_cfg.enabled and not sim.ledger.enabled
