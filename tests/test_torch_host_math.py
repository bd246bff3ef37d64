"""The port's numpy host maths are copies of the JAX package's: at equal
seeds they must agree exactly (channel, data, eps probe, KKT, bounds)."""
import numpy as np
import pytest

from repro.core import bounds as j_bounds
from repro.core import kkt as j_kkt
from repro.core.controller import auto_epsilons as j_auto_eps
from repro.core.genetic import RoundContext as JRoundContext
from repro.data import synthetic as j_syn
from repro.wireless.channel import ChannelModel as JChannel
from repro.wireless.channel import ChannelParams as JParams
from repro.wireless.system import FEMNIST_SYSTEM as J_FEMNIST

from repro_torch.core import bounds as t_bounds
from repro_torch.core import kkt as t_kkt
from repro_torch.core.controller import auto_epsilons as t_auto_eps
from repro_torch.core.genetic import RoundContext as TRoundContext
from repro_torch.data import synthetic as t_syn
from repro_torch.wireless.channel import ChannelModel as TChannel
from repro_torch.wireless.channel import ChannelParams as TParams
from repro_torch.wireless.system import FEMNIST_SYSTEM as T_FEMNIST


@pytest.mark.parametrize("u,c,seed", [(8, 4, 0), (12, 6, 1), (32, 16, 3)])
def test_channel_rates_exact(u, c, seed):
    jm = JChannel(JParams(n_clients=u, n_channels=c), seed=seed)
    tm = TChannel(TParams(n_clients=u, n_channels=c), seed=seed)
    np.testing.assert_array_equal(jm.distances, tm.distances)
    for _ in range(3):
        np.testing.assert_array_equal(jm.draw_rates(), tm.draw_rates())


@pytest.mark.parametrize("seed", [0, 5])
def test_datasets_exact(seed):
    js = j_syn.gaussian_sizes(8, 200.0, 40.0, seed=seed)
    ts = t_syn.gaussian_sizes(8, 200.0, 40.0, seed=seed)
    np.testing.assert_array_equal(js, ts)
    jd = j_syn.make_federated_datasets(j_syn.SyntheticImageTask(j_syn.TINY_TASK, seed),
                                       8, js, alpha=0.5, seed=seed)
    td = t_syn.make_federated_datasets(t_syn.SyntheticImageTask(t_syn.TINY_TASK, seed),
                                       8, ts, alpha=0.5, seed=seed)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    jt = j_syn.make_test_set(j_syn.SyntheticImageTask(j_syn.TINY_TASK, seed), 64, seed + 999)
    tt = t_syn.make_test_set(t_syn.SyntheticImageTask(t_syn.TINY_TASK, seed), 64, seed + 999)
    np.testing.assert_array_equal(jt["x"], tt["x"])
    np.testing.assert_array_equal(j_syn.hetero_kl(jd, 10), t_syn.hetero_kl(td, 10))


@pytest.mark.parametrize("z,target_q", [(5122, 6.0), (246590, 4.0)])
def test_auto_epsilons_exact(z, target_q):
    u = 16
    rates = JChannel(JParams(n_clients=u, n_channels=8), seed=2).draw_rates()
    sizes = j_syn.gaussian_sizes(u, 1200.0, 150.0, seed=2).astype(np.float64)
    ones = np.full(u, 1.0)
    jctx = JRoundContext(rates=rates, d_sizes=sizes, g_sq=ones, sigma_sq=ones,
                         theta_max=ones, z=z)
    tctx = TRoundContext(rates=rates, d_sizes=sizes, g_sq=ones, sigma_sq=ones,
                         theta_max=ones, z=z)
    assert j_auto_eps(jctx, J_FEMNIST, target_q) == t_auto_eps(tctx, T_FEMNIST, target_q)


@pytest.mark.parametrize("lam2,seed", [(50.0, 0), (500.0, 1), (5.0, 2)])
def test_kkt_solve_client_exact(lam2, seed):
    rng = np.random.default_rng(seed)
    sp = J_FEMNIST
    for _ in range(24):
        kw = dict(v=float(rng.uniform(3e7, 3e8)), w=float(rng.uniform(0.02, 0.3)),
                  d_size=float(rng.uniform(100, 3000)), z=246590,
                  theta_max=float(rng.uniform(0.01, 3.0)), lambda2=lam2, eps2=0.0,
                  v_weight=100.0, p=sp.p_tx, alpha=sp.alpha, gamma=sp.gamma,
                  tau_e=sp.tau_e, t_max=sp.t_max, f_min=sp.f_min, f_max=sp.f_max,
                  lipschitz=sp.lipschitz)
        jd = j_kkt.solve_client(j_kkt.ClientEnv(**kw))
        td = t_kkt.solve_client(t_kkt.ClientEnv(**kw))
        if jd is None:
            assert td is None
            continue
        assert (jd.q, jd.f, jd.energy, jd.latency) == (td.q, td.f, td.energy, td.latency)


def test_bound_terms_exact():
    rng = np.random.default_rng(4)
    u = 10
    a = (rng.uniform(size=u) > 0.3).astype(np.float64)
    d = rng.uniform(100, 2000, u)
    w_full = d / d.sum()
    w_round = a * d / max((a * d).sum(), 1e-12)
    g, s, th = rng.uniform(0.5, 2.0, u), rng.uniform(0.1, 1.0, u), rng.uniform(0.1, 2.0, u)
    q = rng.integers(1, 9, u)
    jc, tc = J_FEMNIST.bound_constants(), T_FEMNIST.bound_constants()
    assert (jc.a1, jc.a2) == (tc.a1, tc.a2)
    assert j_bounds.data_term(jc, a, w_full, w_round, g, s) == \
        t_bounds.data_term(tc, a, w_full, w_round, g, s)
    assert j_bounds.quant_term(jc, w_round, 5122, th, q) == \
        t_bounds.quant_term(tc, w_round, 5122, th, q)
