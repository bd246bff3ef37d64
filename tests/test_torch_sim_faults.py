"""Fault injection in the port (``FaultSpec``, the fault helpers and
``screen_slots`` of ``repro_torch.sim.engine``, ``policy.realized_terms``)
against ``repro.sim``.

  * each fault helper on the JAX package's own draws
    (``torch_replay.jax_fault_draws``), u8 and u16 planes: outage, fade,
    burst, corruption and the screen's verdict and counters bit-equal;
  * the screen's unit cases, the Markov outage statistics, a corrupted
    sign plane caught at q = 8;
  * ``realized_terms`` against the JAX function (rtol 1e-5, fp32 sums in
    another order) and the numpy one, and equal to the decision's own
    terms when every slot delivers;
  * end to end (U = 8, C = 4): the port under faults against the JAX
    engine on its draws (q and schedule identical, the suites' float
    tolerances), the port's compiled run against its ``run_host_policy``
    replay (bit for bit in the model), a full burst freezing the model bit
    for bit, an aggressive spec keeping it finite, and faults off leaving
    the draws as they were.

A burst slot's NaN/Inf goes through the quantizer, where a float->uint cast
of NaN is undefined: those planes are never compared, only the range's
finiteness and the screen's verdict.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genetic import SystemParams as JSystemParams
from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro.sim import policy as jpol
from repro.sim.scenario import FaultSpec as JFaultSpec
from repro_torch.core import bounds
from repro_torch.core.genetic import SystemParams
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from repro_torch.sim import policy as tpol
from repro_torch.sim.entropy import DeviceEntropy
from repro_torch.sim.scenario import FAULTS_OFF, FaultSpec, get_scenario
from torch_replay import ReplayEntropy, jax_fault_draws, one_torch_thread  # noqa: F401 (autouse fixture)

U, C, ROUNDS, SEED = 8, 4, 3, 1
AGGRESSIVE = dict(outage_p=0.15, outage_corr=0.4, fade_p=0.1, corrupt_p=0.05, nan_p=0.02)
SYSP, JSYSP = SystemParams(), JSystemParams()


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(SEED)))


def _port(**kw):
    return teng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=64,
                          device="cpu", **kw)


# ------------------------------------------------------------------ spec

def test_faultspec_validation():
    assert not FAULTS_OFF.enabled
    assert FaultSpec(outage_p=0.1).enabled and FaultSpec(nan_p=0.5).enabled
    assert not FaultSpec(outage_corr=0.5).enabled
    for bad in (dict(outage_p=1.5), dict(outage_corr=1.0), dict(corrupt_p=0.1, corrupt_frac=0.0),
                dict(fade_db=-1.0), dict(nan_p=-0.1)):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
    spec = dict(outage_p=0.1, outage_corr=0.3, fade_p=0.2, fade_db=7.0, corrupt_p=0.05,
                corrupt_frac=0.2, nan_p=0.01)
    fv = FaultSpec(**spec).dyn_vector()
    assert fv.shape == (7,) and fv.dtype == np.float32
    np.testing.assert_array_equal(fv, JFaultSpec(**spec).dyn_vector())


def test_faulty_scenario_preset():
    sc = get_scenario("single_bs_faulty")
    assert sc.faults.enabled and sc.faults.outage_p == 0.1 and sc.faults.outage_corr == 0.5
    assert not get_scenario("single_bs").faults.enabled
    sim = teng.build_sim("tiny", scenario="single_bs_faulty", n_clients=4, n_channels=2,
                         n_test=8, device="cpu")
    assert sim.faults == sc.faults and len(sim._init_carry()) == 7
    assert teng.build_sim("tiny", scenario="single_bs_faulty", n_clients=4, n_channels=2,
                          n_test=8, device="cpu", faults=FAULTS_OFF).faults == FAULTS_OFF


# ------------------------------------------------------------- helpers

def _wire(q_cap, s, zpad, seed):
    """A (S, Zpad) wire of valid planes at per-slot q, slot S-1 empty."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, q_cap + 1, s).astype(np.int32)
    q[-1] = 0
    idx = np.minimum(rng.integers(0, 2**16, (s, zpad)), (1 << np.maximum(q, 1))[:, None] - 1)
    dtype = np.uint8 if q_cap <= 8 else np.uint16
    signs = (rng.random((s, zpad)) < 0.5).astype(np.uint8)
    return q, idx.astype(dtype), signs


@pytest.mark.parametrize("q_cap", [8, 16], ids=["u8", "u16"])
def test_fault_helpers_match_reference(q_cap):
    s, zpad, u = 4, 512, 6
    spec = FaultSpec(outage_p=0.4, outage_corr=0.5, fade_p=0.5, fade_db=30.0, corrupt_p=0.6,
                     corrupt_frac=0.1, nan_p=0.5)
    fv_np = spec.dyn_vector()
    fv, jfv = torch.from_numpy(fv_np), jnp.asarray(fv_np)
    key = jax.random.PRNGKey(q_cap)
    draws = jax_fault_draws(key, u, s, zpad)
    k_out, k_fade, k_corr, k_burst = jeng.fault_keys(key)
    state = np.array([0, 1, 0, 1, 1, 0], np.float32)
    down = teng.draw_outage(draws.outage, torch.from_numpy(state), fv)
    np.testing.assert_array_equal(down.numpy(), np.asarray(
        jeng.draw_outage(k_out, jnp.asarray(state), jfv)))
    hit, mult = teng.draw_fade(draws.fade, fv)
    jhit, jmult = jeng.draw_fade(k_fade, u, jfv)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(mult.numpy(), np.asarray(jmult))
    slots = np.array([3, 0, 5, -1], np.int64)
    flat_s = np.random.default_rng(1).normal(0, 0.1, (s, 300)).astype(np.float32)
    burst = teng.inject_burst(draws.burst, torch.from_numpy(slots), torch.from_numpy(flat_s), fv)
    np.testing.assert_array_equal(burst.numpy(), np.asarray(jeng.inject_burst(
        k_burst, jnp.asarray(slots, jnp.int32), jnp.asarray(flat_s), jfv)))
    q, idx, signs = _wire(q_cap, s, zpad, q_cap)
    ti, ts = teng.corrupt_planes(draws.hit, draws.site, draws.bits, torch.from_numpy(idx),
                                 torch.from_numpy(signs), fv)
    ji, js = jeng.corrupt_planes(k_corr, jnp.asarray(idx), jnp.asarray(signs), jfv)
    assert ti.dtype == (torch.uint8 if q_cap <= 8 else torch.uint16) and ts.dtype == torch.uint8
    np.testing.assert_array_equal(ti.to(torch.int32).numpy(), np.asarray(ji).astype(np.int32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.to(torch.int32) != torch.from_numpy(idx.astype(np.int32))).any()
    # the screen on the corrupted planes, one range non-finite
    d = np.array([120.0, 80.0, 200.0, 0.0], np.float32)
    v = np.array([2e5, 3e4, 1e6, 0.0], np.float32)
    f = np.array([1e9, 5e8, 2e9, 0.0], np.float32)
    theta = np.array([0.5, np.nan, 0.2, 0.0], np.float32)
    targs = [torch.from_numpy(a) for a in (slots, q.astype(np.int64), d, v, f, theta)]
    got = teng.screen_slots(*targs, ti, ts, down, mult, hit, SYSP, 5122)
    want = jeng.screen_slots(
        jnp.asarray(slots, jnp.int32), jnp.asarray(q), *[jnp.asarray(a) for a in (d, v, f, theta)],
        ji, js, jnp.asarray(down.numpy()), jmult, jhit, JSYSP, 5122)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_screen_slots_unit_cases():
    """Each failure mode fails exactly its slot: outage, a realized (faded)
    timeout, a non-finite range, an out-of-range plane; an unfaulted
    feasible slot delivers and an empty slot is not counted."""
    s, zp = 5, 16
    slots = torch.tensor([0, 1, 2, 3, -1])
    q = torch.full((s,), 4)
    d = torch.full((s,), 100.0)
    v = torch.full((s,), 1e6)
    f = torch.full((s,), 1e9)
    theta = torch.tensor([1.0, 1.0, float("nan"), 1.0, 1.0])
    idx = torch.zeros((s, zp), dtype=torch.uint8)
    idx[3, 0] = 200                        # > 2^4 - 1: a corrupted plane
    signs = torch.zeros((s, zp), dtype=torch.uint8)
    down = torch.tensor([False, True, False, False])
    fade_hit = torch.tensor([True, False, False, False])
    fade_mult = torch.where(fade_hit, 1e-7, 1.0)
    ok, n_drop, n_tmo, n_scr = teng.screen_slots(slots, q, d, v, f, theta, idx, signs, down,
                                                 fade_mult, fade_hit, SYSP, 1000.0)
    assert ok.tolist() == [False] * 5
    assert (n_drop.item(), n_tmo.item(), n_scr.item()) == (1.0, 1.0, 4.0)
    ok2, a, b, c = teng.screen_slots(slots, q, d, v, f, torch.ones(s), torch.zeros_like(idx),
                                     signs, torch.zeros(4, dtype=torch.bool), torch.ones(4),
                                     torch.zeros(4, dtype=torch.bool), SYSP, 1000.0)
    assert ok2.tolist() == [True, True, True, True, False]
    assert a.item() == b.item() == c.item() == 0.0


def test_corrupt_sign_plane_is_screened():
    """At q = 8 every u8 byte is a legal index: the sign plane (0/1) is
    what catches a corrupted wire."""
    fv = torch.from_numpy(FaultSpec(corrupt_p=1.0, corrupt_frac=0.5).dyn_vector())
    draws = DeviceEntropy(7, "cpu").fault_draws(0, 4, 4, 64)
    zeros = torch.zeros((4, 64), dtype=torch.uint8)
    idx_c, signs_c = teng.corrupt_planes(draws.hit, draws.site, draws.bits, zeros, zeros, fv)
    assert int((torch.amax(signs_c, dim=1) > 1).sum()) == 4
    assert torch.equal(idx_c, signs_c)    # the same sites and bytes on both planes


def test_markov_outage_statistics():
    """Stationary rate p for any corr, P(down | was down) = p + corr (1 - p),
    and corr = 0 is i.i.d."""
    p, corr, u = 0.2, 0.5, 256
    fv = torch.from_numpy(FaultSpec(outage_p=p, outage_corr=corr).dyn_vector())
    fv0 = torch.from_numpy(FaultSpec(outage_p=p).dyn_vector())
    gen = torch.Generator().manual_seed(0)
    state, state0, hist, hist0 = torch.zeros(u), torch.zeros(u), [], []
    for _ in range(400):
        uni = torch.rand(u, generator=gen)
        down, down0 = teng.draw_outage(uni, state, fv), teng.draw_outage(uni, state0, fv0)
        hist.append(down.numpy())
        hist0.append(down0.numpy())
        state, state0 = down.float(), down0.float()
    h, h0 = np.stack(hist), np.stack(hist0)
    assert abs(h[50:].mean() - p) < 0.02
    assert abs(h[51:][h[50:-1]].mean() - (p + corr * (1 - p))) < 0.03
    assert abs(h0[51:][h0[50:-1]].mean() - p) < 0.03


def test_realized_terms():
    rng = np.random.default_rng(0)
    d = rng.integers(50, 200, U).astype(np.float32)
    g = rng.uniform(0.5, 2.0, U).astype(np.float32)
    s2 = rng.uniform(0.1, 0.5, U).astype(np.float32)
    th = rng.uniform(0.5, 1.5, U).astype(np.float32)
    q = rng.integers(1, 9, U)
    hetero = (1.0 + rng.uniform(0, 1, U)).astype(np.float32)
    a_plan = np.ones(U, np.float32)
    a_real = a_plan.copy()
    a_real[[2, 5]] = 0.0
    consts, z = SYSP.bound_constants(), 5122
    dt_p, _ = bounds.realized_terms(consts, a_plan, d, g, s2, th, q, z)
    for het, dl in ((None, None), (hetero, 0.25)):
        dt_r, qt_r = bounds.realized_terms(consts, a_real, d, g, s2, th, q, z, hetero=het,
                                           dl_term=0.0 if dl is None else dl)
        t = tpol.realized_terms(*[torch.from_numpy(a) for a in (a_real, d, g, s2, th)],
                                torch.from_numpy(q), SYSP, z,
                                hetero=None if het is None else torch.from_numpy(het),
                                dl_term=None if dl is None else torch.tensor(dl))
        j = jpol.realized_terms(*[jnp.asarray(a) for a in (a_real, d, g, s2, th)],
                                jnp.asarray(q, jnp.int32), JSYSP, z,
                                hetero=None if het is None else jnp.asarray(het),
                                dl_term=None if dl is None else jnp.float32(dl))
        for got, jw, hw in zip(t, j, (dt_r, qt_r)):
            np.testing.assert_allclose(got.item(), float(jw), rtol=1e-5)
            np.testing.assert_allclose(got.item(), hw, rtol=1e-5)
    assert dt_r > dt_p, "losing clients grows the scheduling-exclusion term"


def test_realized_terms_equal_the_decision_when_all_deliver():
    rng = np.random.default_rng(3)
    rates = torch.from_numpy((rng.random((U, C)) * 2e6 + 2e6).astype(np.float32))
    d = torch.from_numpy(rng.integers(100, 300, U).astype(np.float32))
    g, s2, th = (torch.from_numpy(rng.uniform(0.5, 1.5, U).astype(np.float32)) for _ in range(3))
    dec = tpol.decide(rates, d, g, s2, th, torch.tensor(30.0), SYSP, 5122, 100.0,
                      dl_term=torch.tensor(0.5))
    dt, qt = tpol.realized_terms(dec.a, d, g, s2, th, dec.q, SYSP, 5122,
                                 dl_term=torch.tensor(0.5))
    assert dec.a.sum() > 0
    assert torch.equal(dt, dec.data_term) and torch.equal(qt, dec.quant_term)


# ----------------------------------------------------------- end to end

@functools.lru_cache(maxsize=None)
def _runs(mode):
    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64, policy_mode=mode, q_cap=16)
    jsim = jeng.build_sim("tiny", faults=JFaultSpec(**AGGRESSIVE), **kw)
    jres = jsim.run_compiled(ROUNDS)
    tsim = teng.build_sim("tiny", faults=FaultSpec(**AGGRESSIVE), device="cpu",
                          init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                          entropy=ReplayEntropy(jsim, ROUNDS), **kw)
    return jsim, jres, tsim, tsim.run_compiled(ROUNDS)


def _queue_atol(eps):
    return ROUNDS * float(np.spacing(np.float32(eps)))


def _one_level(sim, rounds):
    """The largest quantizer level theta_k / (2^q_k - 1) of a scheduled slot
    over the rounds of ``sim`` (stepped again; its weight bounded by 1)."""
    carry, level = sim._init_carry(), 0.0
    with torch.no_grad():
        for n in range(rounds):
            carry, out = sim._round_body(carry, n, with_eval=False)
            q = out["q_levels"].numpy()
            theta = carry[3].double().numpy()
            level = max(level, float(np.max(np.where(q > 0, theta / (2.0**q - 1.0), 0.0))))
    return level


@pytest.mark.parametrize("mode", ["greedy", "channel_allocate"])
def test_faults_run_matches_reference(mode):
    jsim, jres, tsim, tres = _runs(mode)
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
    # as tests/test_torch_sim_round.py: a last-bit SGD difference moves a
    # coordinate whose uniform sits at its rounding boundary by one level
    diff = np.abs(tsim.final_flat.numpy() - np.asarray(jsim.final_flat))
    assert np.mean(diff <= 1e-5) >= 0.999
    assert diff.max() <= _one_level(tsim, ROUNDS) + 1e-5


@pytest.mark.parametrize("mode", ["greedy", "no_quant", "compiled-ga"])
def test_faults_run_equals_host_replay(mode):
    from repro_torch.core.genetic import GAConfig

    kw = dict(n_clients=U, n_channels=C, seed=SEED, n_test=64, device="cpu", policy_mode=mode,
              q_cap=16, faults=FaultSpec(**AGGRESSIVE),
              ga_config=GAConfig(generations=3, population=6, repair_infeasible=True))
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


def _step(sim, rounds):
    """Step the compiled round, returning its per-round outputs."""
    carry, outs = sim._init_carry(), []
    with torch.no_grad():
        for n in range(rounds):
            carry, out = sim._round_body(carry, n, with_eval=True)
            outs.append(out)
    return carry, outs


def test_aggressive_faults_keep_the_model_finite():
    sim = _port(faults=FaultSpec(outage_p=0.3, fade_p=0.2, corrupt_p=0.5, nan_p=0.25))
    carry, outs = _step(sim, 4)
    assert torch.isfinite(carry[0]).all()
    assert all(np.isfinite(float(o[k])) for o in outs for k in ("accuracy", "loss", "lambda1"))
    scr = np.array([float(o["n_screened"]) for o in outs])
    drop = np.array([float(o["n_dropped"]) for o in outs])
    sched = np.array([float(o["n_scheduled"]) for o in outs])
    assert scr.sum() > 0 and (drop <= scr).all() and (scr <= sched).all()
    assert (scr < sched).any(), "some slot must still deliver"


def test_full_burst_freezes_the_model_bitwise():
    sim = _port(faults=FaultSpec(nan_p=1.0))
    carry, outs = _step(sim, 3)
    assert torch.equal(carry[0], sim.flat0)
    assert [float(o["n_screened"]) for o in outs] == [float(o["n_scheduled"]) for o in outs]
    assert sum(float(o["n_scheduled"]) for o in outs) > 0


def test_faults_off_leaves_the_draws():
    none_sim, off_sim = _port(), _port(faults=FAULTS_OFF)
    assert len(off_sim._init_carry()) == 6 and off_sim._fv is None
    a, b = none_sim.run_compiled(2), off_sim.run_compiled(2)
    for f in ("energy", "accuracy", "loss", "q_levels", "lambda1", "lambda2", "rates"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert torch.equal(none_sim.final_flat, off_sim.final_flat)
    assert torch.equal(none_sim.entropy.generator.get_state(),
                       off_sim.entropy.generator.get_state())
