"""The object runtime in the port (``repro_torch.fl``: ``FLClient``,
``FLExperiment``, ``build_experiment``, ``run_policy``) against
``repro.fl``.

  * ``FLClient.local_update`` from the JAX package's weights draws the same
    batches (``default_rng(seed + cid)``) and returns the parameters within
    rtol 1e-5 / atol 1e-6, G^2 and sigma^2 within rtol 1e-5;
  * ``FLExperiment.run`` of each of the five policies on the tiny task
    (U = C = 8, 5 rounds, seed 3) from the JAX weights, with the JAX upload
    key chain replayed (``torch_replay.UploadReplay``): scheduled counts, q,
    energy, latency, payload bits and rates identical; accuracy within
    1e-3; every final parameter within one quantization level (the largest
    w_i theta_i / (2^q_i - 1) of a scheduled client in any round, read from
    the JAX run) plus 1e-5, and 99 % of them within 1e-5 (a coordinate
    whose uniform sits at its rounding boundary moves a whole level);
  * the port's fleet sim against its object runtime driven by
    ``HostFastPolicy`` (U = 8, seed 21, 12 rounds): identical scheduled
    counts and q, as ``tests/test_sim_parity.py`` holds for the JAX package;
  * without CUDA, ``build_experiment`` and ``run_policy`` raise unless the
    caller passes a device;
  * the example twins (``examples/*_torch.py``) import neither JAX nor
    ``repro``, and the Fig.-3 example runs on the CPU.
"""
import ast
import functools
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.fl import build_experiment as jbuild
from repro.fl.client import FLClient as JFLClient
from repro.models import cnn as jcnn
from repro_torch import tree as tree_util
from repro_torch.fl import FLClient, FLExperiment, build_experiment, run_policy
from repro_torch.fl.trainer import UploadEntropy
from repro_torch.models import cnn as tcnn
from repro_torch.sim import build_sim
from repro_torch.sim.policy import HostFastPolicy
from torch_replay import UploadReplay, one_torch_thread  # noqa: F401 (autouse fixture)

U, ROUNDS, SEED = 8, 5, 3
POLICIES = ("qccf", "no_quant", "channel_allocate", "principle_24", "same_size_26")
PARAM_ATOL = 1e-5


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("cid", [0, 5])
def test_local_update_matches_jax(cid):
    task = jsyn.SyntheticImageTask(jsyn.TINY_TASK, seed=1)
    sizes = jsyn.gaussian_sizes(6, 200.0, 40.0, seed=1)
    data = jsyn.make_federated_datasets(task, 6, sizes, seed=1)[cid]
    params = _numpy_tree(jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(2)))
    jc = JFLClient(cid, data, functools.partial(jcnn.loss_fn, jcnn.TINY_CNN), seed=4)
    tc = FLClient(cid, data, functools.partial(tcnn.loss_fn, tcnn.TINY_CNN), seed=4,
                  device="cpu")
    assert tc.d_size == jc.d_size and tc.batch_size == jc.batch_size
    for _ in range(2):     # the second call draws the generator's next batches
        jp, jg, jv = jc.local_update(params, 6, 0.05)
        tp, tg, tv = tc.local_update(tcnn.params_from_numpy(params, "cpu"), 6, 0.05)
        assert isinstance(tg, float) and isinstance(tv, float)
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        for (k, n), leaf in zip(tree_util.paths(tp), tree_util.leaves(tp)):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[k][n]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}/{n}")
        params = _numpy_tree(jp)


class _Spy:
    """Records the policy's decisions (which clients uploaded, at what q)."""

    def __init__(self, inner):
        self.inner, self.name, self.decisions = inner, inner.name, []

    def decide(self, ctx):
        self.decisions.append(self.inner.decide(ctx))
        return self.decisions[-1]

    def commit(self, dec):
        self.inner.commit(dec)


@pytest.fixture(scope="module", params=POLICIES)
def pair(request):
    """(JAX records, port records, one-level bound, JAX final params, port
    final params) of one policy. The JAX run goes round by round to read
    each round's ranges."""
    pol = request.param
    jexp = jbuild(pol, task="tiny", n_clients=U, n_channels=U, seed=SEED)
    init = tcnn.params_from_numpy(_numpy_tree(jexp.params), "cpu")
    jexp.policy = _Spy(jexp.policy)
    jrecs, level = [], 0.0
    for _ in range(ROUNDS):
        jrecs += jexp.run(1).records
        dec = jexp.policy.decisions[-1]
        a = dec.a.astype(bool)
        if a.any():
            w = jexp.d_sizes / float(np.sum(dec.a * jexp.d_sizes))
            steps = w * jexp.theta_max / (2.0 ** np.maximum(dec.q, 1) - 1.0)
            level = max(level, float(steps[a].max()))
    texp = build_experiment(pol, task="tiny", n_clients=U, n_channels=U, seed=SEED,
                            device="cpu", init_params=init, entropy=UploadReplay(SEED))
    tres = texp.run(ROUNDS)
    assert tres.name == pol
    return jrecs, tres.records, level, jexp.params, texp.params


def test_schedule_and_q_identical(pair):
    jrecs, trecs, *_ = pair
    assert [r.n_scheduled for r in trecs] == [r.n_scheduled for r in jrecs]
    np.testing.assert_array_equal(np.stack([r.q_levels for r in trecs]),
                                  np.stack([r.q_levels for r in jrecs]))
    np.testing.assert_array_equal(np.stack([r.rates for r in trecs]),
                                  np.stack([r.rates for r in jrecs]))
    assert sum(r.n_scheduled for r in trecs) > 0


def test_energy_latency_payload_identical(pair):
    jrecs, trecs, *_ = pair
    for field in ("energy", "cum_energy", "latency", "payload_bits"):
        assert [getattr(r, field) for r in trecs] == [getattr(r, field) for r in jrecs], field


def test_accuracy_within_1e3(pair):
    jrecs, trecs, *_ = pair
    acc_j = np.array([r.accuracy for r in jrecs])
    acc_t = np.array([r.accuracy for r in trecs])
    assert np.abs(acc_t - acc_j).max() <= 1e-3, (acc_t, acc_j)
    np.testing.assert_allclose([r.loss for r in trecs], [r.loss for r in jrecs], rtol=1e-4)


def test_final_params_within_one_level(pair):
    *_, level, jparams, tparams = pair
    diffs = np.concatenate([
        np.abs(leaf.numpy() - np.asarray(jparams[k][n])).reshape(-1)
        for (k, n), leaf in zip(tree_util.paths(tparams), tree_util.leaves(tparams))])
    assert diffs.max() <= level + PARAM_ATOL, (diffs.max(), level)
    assert np.mean(diffs <= PARAM_ATOL) >= 0.99, np.mean(diffs <= PARAM_ATOL)


@pytest.fixture(scope="module")
def sim_and_object():
    """The tests/test_sim_parity.py pairing inside the port."""
    sim = build_sim("tiny", n_clients=8, seed=21, device="cpu")
    res_sim = sim.run_compiled(12)
    exp = build_experiment("qccf", task="tiny", n_clients=8, n_channels=8, seed=21,
                           device="cpu")
    exp.policy = HostFastPolicy(sim.sysp, sim.eps1, sim.eps2, sim.v_weight, q_cap=8)
    return sim, exp, res_sim, exp.run(12, eval_every=1)


def test_sim_and_object_runtime_same_setup(sim_and_object):
    sim, exp, _res_sim, _res_obj = sim_and_object
    assert sim.z == exp.z
    np.testing.assert_array_equal(sim.fleet.d_sizes, exp.d_sizes.astype(np.int64))


def test_sim_and_object_runtime_scheduled_counts(sim_and_object):
    _sim, _exp, res_sim, res_obj = sim_and_object
    np.testing.assert_array_equal([r.n_scheduled for r in res_obj.records], res_sim.n_scheduled)


def test_sim_and_object_runtime_q_levels(sim_and_object):
    _sim, _exp, res_sim, res_obj = sim_and_object
    q_obj = np.stack([r.q_levels for r in res_obj.records])
    np.testing.assert_array_equal(q_obj, res_sim.q_levels)
    assert np.all(res_sim.q_levels[0] == 1)
    assert np.mean(res_sim.q_levels[-1]) > np.mean(res_sim.q_levels[0])


def test_default_upload_entropy_reruns_bit_equal():
    """Two experiments from one seed give the same run; the default
    entropy draws one fp32 uniform tensor per leaf."""
    ent = UploadEntropy(3, "cpu")
    u = ent.upload_uniforms([(2, 3), (4,)])
    assert [tuple(t.shape) for t in u] == [(2, 3), (4,)]
    assert all(t.dtype == torch.float32 and 0 <= t.min() and t.max() < 1 for t in u)
    runs = []
    for _ in range(2):
        exp = build_experiment("principle_24", task="tiny", n_clients=4, n_channels=4,
                               seed=1, device="cpu")
        assert isinstance(exp, FLExperiment) and exp.device == torch.device("cpu")
        runs.append((exp.run(2), exp.params))
    (a, pa), (b, pb) = runs
    assert [r.accuracy for r in a.records] == [r.accuracy for r in b.records]
    assert all(torch.equal(x, y) for x, y in zip(tree_util.leaves(pa), tree_util.leaves(pb)))


@pytest.mark.parametrize("entry", [build_experiment, run_policy],
                         ids=["build_experiment", "run_policy"])
def test_no_device_raises_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry("qccf", task="tiny", n_clients=4, n_channels=4)


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.mark.parametrize("name", ["quickstart_torch.py", "fl_femnist_torch.py"])
def test_example_twins_import_no_jax(name):
    tree = ast.parse((EXAMPLES / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch.fl" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_fl_femnist_twin_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["fl_femnist_torch.py", "--device", "cpu", "--rounds", "1",
                                      "--policies", "qccf", "no_quant"])
    runpy.run_path(str(EXAMPLES / "fl_femnist_torch.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "== comparison ==" in out and "QCCF saves" in out
