"""Host-policy replay in the port (``FleetSim.run_host_policy``, the numpy
oracles of each mode, ``repro_torch.fl.baselines``) against ``repro.sim``
and ``repro.fl``.

  * at fixed contexts the port's numpy oracles (``decide_host``,
    ``HostFastPolicy``, the ``fl.baselines`` policies, ``HostGAPolicy`` on
    the JAX key's draws) equal the JAX package's: the same f64 code;
  * end to end (tiny task, U = 8, the JAX engine's draws through
    ``torch_replay.ReplayEntropy``): the port's compiled run equals its own
    replay, and its replay matches the JAX package's replay: schedule and q
    equal, energy within rtol 1e-5, accuracy within 1/256 (one of the 256
    test images: the fp32 SGD of the two frameworks differs in the last
    bits, ``tests/test_torch_sim_round.py``);
  * the GA's cold start (round 0 schedules nobody, as in
    ``tests/test_sim_search.py``), ``channel="host"`` runs, ``run()`` and
    ``SimResult.to_result``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.controller import QCCFController as JQCCFController
from repro.core.genetic import GAConfig as JGAConfig
from repro.core.genetic import RoundContext as JRoundContext
from repro.core.genetic import SystemParams as JSystemParams
from repro.fl import baselines as jbase
from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro.sim import policy as jpol
from repro.sim import search as jsearch
from repro.wireless.channel import ChannelModel, ChannelParams
from repro_torch.core.controller import QCCFController as TQCCFController
from repro_torch.core.genetic import GAConfig, RoundContext, SystemParams
from repro_torch.fl import baselines as tbase
from repro_torch.fl.trainer import ExperimentResult
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from repro_torch.sim import policy as tpol
from repro_torch.sim import search as tsearch
from torch_replay import ReplayEntropy, jax_ga_draws, one_torch_thread  # noqa: F401 (autouse fixture)

JSYSP, TSYSP = JSystemParams(), SystemParams()
GA_KW = dict(generations=4, population=8, elitism=2, repair_infeasible=True)


def _contexts(u, c, seed, n, z=246590):
    """n successive rounds' (JAX, port) RoundContexts on one channel model."""
    rng = np.random.default_rng(seed)
    model = ChannelModel(ChannelParams(n_clients=u, n_channels=c), seed=seed)
    d = np.maximum(rng.normal(1200, 300, u), 50)
    out = []
    for _ in range(n):
        g = rng.uniform(0.5, 2.0, u); g /= g.mean()
        s = rng.uniform(0.5, 2.0, u); s /= s.mean()
        kw = dict(rates=model.draw_rates(), d_sizes=d, g_sq=g, sigma_sq=s,
                  theta_max=rng.uniform(0.2, 1.5, u), z=z)
        out.append((JRoundContext(**kw), RoundContext(**kw)))
    return out


def _same_decision(jd, td):
    for f in dataclasses.fields(td):
        want, got = getattr(jd, f.name), getattr(td, f.name)
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name
    if hasattr(jd, "q_cont"):
        np.testing.assert_array_equal(td.q_cont, jd.q_cont)


# ------------------------------------------------------ fixed contexts

@pytest.mark.parametrize("u,c,seed,z,q_cap", [(8, 8, 0, 5122, 8), (12, 6, 1, 246590, 8),
                                              (5, 9, 2, 576778, 16)])
def test_decide_host_equals_reference(u, c, seed, z, q_cap):
    (jctx, _tctx), = _contexts(u, c, seed, 1, z=z)
    hetero = 1.0 + np.random.default_rng(seed).uniform(0, 1, u)
    for het in (None, hetero):
        args = (jctx.rates, jctx.d_sizes, jctx.g_sq, jctx.sigma_sq, jctx.theta_max, 70.0)
        want = jpol.decide_host(*args, JSYSP, z, 100.0, q_cap=q_cap, hetero=het)
        got = tpol.decide_host(*args, TSYSP, z, 100.0, q_cap=q_cap, hetero=het)
        for k in ("assign", "slots", "a", "q", "f", "v_assigned", "energy", "latency",
                  "q_cont"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        for k in ("data_term", "quant_term", "payload_bits"):
            assert getattr(got, k) == getattr(want, k), k


def _policy_pairs(u, c):
    jga = jsearch.HostGAPolicy(JSYSP, 150.0, 0.5, 100.0, cfg=JGAConfig(**GA_KW))
    tga = tsearch.HostGAPolicy(TSYSP, 150.0, 0.5, 100.0, cfg=GAConfig(**GA_KW))
    return {
        "greedy": (jpol.HostFastPolicy(JSYSP, 150.0, 0.5, 100.0),
                   tpol.HostFastPolicy(TSYSP, 150.0, 0.5, 100.0)),
        "host_ga": (jga, tga),
        "no_quant": (jbase.NoQuantPolicy(JSYSP), tbase.NoQuantPolicy(TSYSP)),
        "channel_allocate": (jbase.ChannelAllocatePolicy(JSYSP),
                             tbase.ChannelAllocatePolicy(TSYSP)),
        "principle": (jbase.PrinciplePolicy(JSYSP, double_every=2),
                      tbase.PrinciplePolicy(TSYSP, double_every=2)),
        "same_size": (jbase.SameSizePolicy(jsearch.HostGAPolicy(
                          JSYSP, 150.0, 0.5, 100.0, cfg=JGAConfig(**GA_KW))),
                      tbase.SameSizePolicy(tsearch.HostGAPolicy(
                          TSYSP, 150.0, 0.5, 100.0, cfg=GAConfig(**GA_KW)))),
        "qccf": (jbase.QCCFPolicy(JQCCFController(u, JSYSP, 100.0, 150.0, 0.5,
                                                  ga=JGAConfig(generations=3, population=6),
                                                  seed=4)),
                 tbase.QCCFPolicy(TQCCFController(u, TSYSP, 100.0, 150.0, 0.5,
                                                  ga=GAConfig(generations=3, population=6),
                                                  seed=4))),
    }


@pytest.mark.parametrize("name", ["greedy", "host_ga", "no_quant", "channel_allocate",
                                  "principle", "same_size", "qccf"])
def test_host_policies_equal_reference(name):
    """Four rounds of decide + commit at fixed contexts: every decision and
    the policy's state equal the JAX package's."""
    u, c = 8, 6
    jp, tp = _policy_pairs(u, c)[name]
    assert tp.name == jp.name
    for n, (jctx, tctx) in enumerate(_contexts(u, c, 3, 4)):
        if hasattr(jp, "set_round_key"):
            key = jax.random.PRNGKey(100 + n)
            jp.set_round_key(key)
            tp.set_round_draws(jax_ga_draws(key, u, c, GAConfig(**GA_KW)))
        jd, td = jp.decide(jctx), tp.decide(tctx)
        _same_decision(jd, td)
        jp.commit(jd)
        tp.commit(td)
    for attr in ("lambda1", "lambda2", "round"):
        for obj in ((jp, tp), (getattr(jp, "controller", None), getattr(tp, "controller", None))):
            if hasattr(obj[0], attr):
                assert getattr(obj[1], attr) == getattr(obj[0], attr), attr


# ------------------------------------------------------------ end to end

def _pair(mode, rounds, seed=1, **kw):
    """(JAX sim, port sim on the JAX draws and weights), tiny task, U = 8."""
    kw = dict(n_clients=8, seed=seed, n_test=256, policy_mode=mode, **kw)
    jsim = jeng.build_sim("tiny", ga_config=JGAConfig(**GA_KW), **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(seed)))
    tsim = teng.build_sim("tiny", ga_config=GAConfig(**GA_KW), device="cpu",
                          init_params=tcnn.params_from_numpy(params, "cpu"),
                          entropy=ReplayEntropy(jsim, rounds), **kw)
    return jsim, tsim


def _records(res):
    return {k: np.array([getattr(r, k) for r in res.records])
            for k in ("energy", "accuracy", "n_scheduled", "q_levels", "latency",
                      "payload_bits", "rates")}


def _assert_same_run(got, want, acc_atol):
    np.testing.assert_array_equal(got["q_levels"], want["q_levels"])
    np.testing.assert_array_equal(got["n_scheduled"], want["n_scheduled"])
    np.testing.assert_array_equal(got["rates"] > 0, want["rates"] > 0)
    for k in ("energy", "latency", "payload_bits"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-12, err_msg=k)
    assert np.max(np.abs(got["accuracy"] - want["accuracy"])) <= acc_atol


@pytest.fixture(scope="module")
def greedy_runs():
    jsim, tsim = _pair("greedy", 6)
    want = _records(jsim.run_host_policy(
        jpol.HostFastPolicy(jsim.sysp, jsim.eps1, jsim.eps2, jsim.v_weight, q_cap=8), 6))
    scan = tsim.run_compiled(6)
    replay = tsim.run_host_policy(tsim.make_host_policy(), 6, channel="sim")
    return want, scan, replay


def test_greedy_scan_equals_replay(greedy_runs):
    _want, scan, replay = greedy_runs
    assert replay.name == "greedy_kkt"
    _assert_same_run(_records(replay), _records(scan.to_result()), acc_atol=1e-6)


def test_greedy_replay_matches_reference(greedy_runs):
    want, _scan, replay = greedy_runs
    _assert_same_run(_records(replay), want, acc_atol=1.0 / 256)


@pytest.fixture(scope="module")
def ga_runs():
    jsim, tsim = _pair("compiled-ga", 5)
    want = _records(jsim.run_host_policy(jsim.make_host_ga_policy(), 5, channel="sim"))
    scan = tsim.run_compiled(5)
    # run() dispatches on the sim's mode: host-ga needs a sim of its own
    _jsim, tsim2 = _pair("host-ga", 5)
    replay = tsim2.run(5)
    return want, scan, replay


def test_ga_scan_equals_replay(ga_runs):
    _want, scan, replay = ga_runs
    assert isinstance(replay, ExperimentResult) and replay.name == "host_ga"
    _assert_same_run(_records(replay), _records(scan.to_result()), acc_atol=1e-6)


def test_ga_replay_matches_reference(ga_runs):
    want, _scan, replay = ga_runs
    _assert_same_run(_records(replay), want, acc_atol=1.0 / 256)


def test_ga_cold_start_then_schedules(ga_runs):
    """Empty queues: the GA minimizes V * energy by scheduling nobody; then
    the data queue fills and participation jumps."""
    _want, scan, _replay = ga_runs
    assert scan.n_scheduled[0] == 0 and np.all(scan.q_levels[0] == 0)
    assert scan.n_scheduled[-1] > 0 and scan.q_levels[-1].max() >= 1


@pytest.mark.parametrize("mode", ["greedy", "no_quant"])
def test_host_channel_replay_matches_reference(mode):
    """channel="host": the numpy ChannelModel's stream (the same stream in
    both packages after build_sim's probe draw) with the engine's batch and
    quantizer draws."""
    jsim, tsim = _pair(mode, 4, seed=2, q_cap=16)
    want = _records(jsim.run_host_policy(jsim.make_host_policy(), 4, channel="host"))
    got = tsim.run_host_policy(tsim.make_host_policy(), 4, channel="host")
    _assert_same_run(_records(got), want, acc_atol=1.0 / 256)
    # another stream than the sim's rates
    scan = _records(_pair(mode, 4, seed=2, q_cap=16)[1].run_compiled(4).to_result())
    assert not np.allclose(_records(got)["rates"], scan["rates"])


def test_to_result_and_modes():
    sim = teng.build_sim("tiny", n_clients=6, n_channels=3, seed=2, n_test=32, device="cpu",
                         policy_mode="qccf")
    assert sim.policy_mode == "greedy"
    res = sim.run_compiled(3, with_eval=False)
    er = res.to_result()
    assert er.name == res.name and len(er.records) == 3
    np.testing.assert_array_equal(er.cum_energy, np.cumsum(res.energy))
    for n, r in enumerate(er.records):
        assert r.round == n and r.n_scheduled == int(res.n_scheduled[n])
        np.testing.assert_array_equal(r.q_levels, res.q_levels[n])
        np.testing.assert_array_equal(r.rates, res.rates[n])
        assert r.latency == float(res.latency[n])
    assert er.summary()["rounds"] == 3
    kw = dict(n_clients=4, n_channels=2, n_test=8, device="cpu")
    assert teng.build_sim("tiny", policy_mode="qccf_ga", **kw).policy_mode == "compiled-ga"
    with pytest.raises(ValueError, match="policy_mode"):
        teng.build_sim("tiny", policy_mode="bogus", **kw)
    with pytest.raises(ValueError, match="host-ga"):
        teng.build_sim("tiny", policy_mode="host-ga", **kw).run_compiled(1)
    with pytest.raises(ValueError, match="channel"):
        sim.run_host_policy(sim.make_host_policy(), 1, channel="air")


def test_replay_refuses_an_inconsistent_decision():
    """A decision that schedules a client without a channel would train the
    wrong slot set: the replay stops before executing it."""
    sim = teng.build_sim("tiny", n_clients=4, n_channels=2, seed=0, n_test=8, device="cpu")

    class Bad(tpol.HostFastPolicy):
        def decide(self, ctx):
            dec = super().decide(ctx)
            dec.a = np.ones_like(dec.a)
            dec.q = np.maximum(dec.q, 1)
            return dec

    with pytest.raises(ValueError, match="inconsistent"):
        sim.run_host_policy(Bad(sim.sysp, sim.eps1, sim.eps2, sim.v_weight), 1)
