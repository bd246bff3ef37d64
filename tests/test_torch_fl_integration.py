"""The paper's Sec.-VI claims on the port's object runtime, on the CPU at
the sizes of ``tests/test_fl_integration.py`` (its checks, unchanged):
QCCF learns, spends under half of NoQuant's energy, its q does not fall
with training (Remark 1) and falls with D at a fixed rate (Remark 2, at
FEMNIST's Z = 246,590), it meets T_max, and the other baselines run.
"""
import numpy as np
import pytest

from repro_torch.fl import build_experiment, run_policy
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def qccf_result():
    return run_policy("qccf", task="tiny", n_rounds=25, seed=3, device="cpu")


@pytest.fixture(scope="module")
def noquant_result():
    return run_policy("no_quant", task="tiny", n_rounds=25, seed=3, device="cpu")


def test_qccf_trains(qccf_result):
    accs = qccf_result.accuracy
    assert accs[-1] > accs[0] + 0.05, accs


def test_qccf_energy_below_noquant(qccf_result, noquant_result):
    e_q = qccf_result.cum_energy[-1]
    e_n = noquant_result.cum_energy[-1]
    assert e_q < 0.5 * e_n, (e_q, e_n)


def test_q_levels_rise_with_training(qccf_result):
    """Remark 1: quantization level rises with the round index."""
    qs = [r.q_levels[r.q_levels > 0].mean()
          for r in qccf_result.records if (r.q_levels > 0).any()]
    first = np.mean(qs[: max(len(qs) // 3, 1)])
    last = np.mean(qs[-max(len(qs) // 3, 1):])
    assert last >= first - 0.5, (first, last)


def test_q_negatively_correlated_with_dataset_size():
    """Remark 2: clients with more data quantize coarser, ceteris paribus:
    regress q on (1, v, D) per round and check the D coefficient."""
    exp = build_experiment("qccf", task="femnist", beta=300.0, seed=11, device="cpu")
    d = np.array([c.d_size for c in exp.clients], dtype=np.float64)
    res = exp.run(10, eval_every=50)
    d_coefs = []
    for r in res.records:
        m = r.q_levels > 0
        if m.sum() >= 4 and np.std(r.q_levels[m]) > 0 and np.std(d[m]) > 0:
            x = np.stack([np.ones(int(m.sum())), r.rates[m], d[m]], axis=1)
            coef, *_ = np.linalg.lstsq(x, r.q_levels[m].astype(np.float64), rcond=None)
            d_coefs.append(coef[2])
    assert d_coefs and np.mean(d_coefs) < 0.0, d_coefs


def test_latency_constraint_respected(qccf_result):
    t_max = 0.02
    for r in qccf_result.records:
        assert r.latency <= t_max * (1 + 1e-6)


@pytest.mark.parametrize("pol", ["channel_allocate", "principle_24", "same_size_26"])
def test_baselines_run(pol):
    res = run_policy(pol, task="tiny", n_rounds=6, seed=5, device="cpu")
    assert len(res.records) == 6
    assert np.isfinite(res.cum_energy[-1])
