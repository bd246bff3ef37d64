"""One QCCF fleet round of the port against ``repro.sim.engine``, fed the
reference's own random draws through the entropy seam.

Tolerances: the wire quantizer is bit-equal; local SGD within rtol 1e-4
(fp32 convolutions summed in another order); over three rounds the
schedule and q are identical, energy within rtol 1e-5, the Lyapunov queues
within rtol 1e-4, loss within rtol 1e-3 and accuracy within 1/64 of the 64
test images. The final parameters agree within 1e-5 on >= 99.9 % of the
coordinates and within one quantizer level (max_k w_k theta_k / (2^q_k - 1)
+ 1e-5) on all: a last-bit SGD difference moves a coordinate whose uniform
sits at its rounding boundary by one level.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro.sim import fleet as jfleet
from repro_torch import tree as tree_util
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from repro_torch.sim import fleet as tfleet
from repro_torch.sim.entropy import DeviceEntropy
from torch_replay import ReplayEntropy, batch_indices, one_torch_thread  # noqa: F401 (autouse fixture)

U, C, ROUNDS, SEED = 8, 4, 3, 0


def _jax_params(seed=SEED):
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def runs():
    jsim = jeng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=64)
    jres = jsim.run_compiled(ROUNDS)
    tsim = teng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=64,
                          device="cpu", init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                          entropy=ReplayEntropy(jsim, ROUNDS))
    tres = tsim.run_compiled(ROUNDS)
    return jsim, jres, tsim, tres


@pytest.mark.parametrize("q_cap", [8, 16])
def test_quantize_wire_bit_equal(q_cap):
    rng = np.random.default_rng(q_cap)
    s, z, zpad = 4, 5122, jeng._pad_len(5122, 64)
    assert teng._pad_len(z) == zpad
    flat_s = rng.normal(0.0, 0.2, (s, z)).astype(np.float32)
    q = np.array([1, q_cap, 0, 5], np.int32)   # slot 2 is a padding slot
    key = jax.random.PRNGKey(q_cap)
    ji, js, jt = jeng._quantize_wire(key, jnp.asarray(flat_s), jnp.asarray(q), q_cap, zpad)
    u01 = np.asarray(jax.random.uniform(key, (s, zpad), jnp.float32))
    ti, ts, tt = teng._quantize_wire(torch.tensor(u01), torch.from_numpy(flat_s),
                                     torch.from_numpy(q).long(), q_cap, zpad)
    assert ti.dtype == (torch.uint8 if q_cap <= 8 else torch.uint16)
    np.testing.assert_array_equal(ti.to(torch.int32).numpy(), np.asarray(ji).astype(np.int32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_fleet_local_sgd_matches():
    from repro.data import synthetic as jsyn

    task = jsyn.SyntheticImageTask(jsyn.TINY_TASK, seed=1)
    sizes = jsyn.gaussian_sizes(3, 200.0, 40.0, seed=1)
    fleet = jfleet.build_fleet(jsyn.make_federated_datasets(task, 3, sizes, seed=1))
    tau, bsz, lr = 6, 32, 0.05
    key = jax.random.PRNGKey(5)
    loss = functools.partial(jcnn.loss_fn, jcnn.TINY_CNN)
    jp, jg, jv = jax.jit(jfleet.fleet_local_sgd, static_argnums=(0, 1, 2))(
        loss, tau, bsz, jax.tree_util.tree_map(jnp.asarray, _jax_params(2)),
        fleet.x, fleet.y, fleet.n_samples, lr, key)
    bidx = batch_indices(key, sizes.tolist(), tau, bsz)
    tp, tg, tv = tfleet.fleet_local_sgd(
        functools.partial(tcnn.loss_fn, tcnn.TINY_CNN), tau,
        tcnn.params_from_numpy(_jax_params(2), "cpu"),
        torch.tensor(np.asarray(fleet.x)), torch.tensor(np.asarray(fleet.y)).long(),
        torch.from_numpy(bidx), lr)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4)
    for (k, n), leaf in zip(tree_util.paths(tp), tree_util.leaves(tp)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[k][n]), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{k}/{n}")


def test_three_rounds_schedule_and_queues(runs):
    _jsim, jres, _tsim, tres = runs
    # identical schedule: the same clients on the same channels (the
    # assigned rate identifies the channel) at the same levels
    np.testing.assert_array_equal(tres.q_levels, jres.q_levels)
    np.testing.assert_array_equal(tres.n_scheduled, jres.n_scheduled)
    np.testing.assert_array_equal(tres.rates > 0, jres.rates > 0)
    np.testing.assert_allclose(tres.rates, jres.rates, rtol=1e-6)
    np.testing.assert_allclose(tres.energy, jres.energy, rtol=1e-5)
    np.testing.assert_allclose(tres.payload_bits, jres.payload_bits, rtol=1e-6)
    np.testing.assert_allclose(tres.lambda1, jres.lambda1, rtol=1e-4)
    np.testing.assert_allclose(tres.lambda2, jres.lambda2, rtol=1e-4)
    np.testing.assert_allclose(tres.loss, jres.loss, rtol=1e-3)
    assert np.abs(tres.accuracy - jres.accuracy).max() <= 1.0 / 64


def test_three_rounds_final_parameters(runs):
    jsim, _jres, tsim, tres = runs
    want = np.asarray(jsim.final_flat)
    got = tsim.final_flat.numpy()
    diff = np.abs(got - want)
    assert np.mean(diff <= 1e-5) >= 0.999

    # one quantizer level of the largest slot weight: replay the rounds
    # step by step and read each round's scheduled (w, theta, q)
    step_sim = teng.build_sim("tiny", n_clients=U, n_channels=C, seed=SEED, n_test=64,
                              device="cpu",
                              init_params=tcnn.params_from_numpy(_jax_params(), "cpu"),
                              entropy=ReplayEntropy(jsim, ROUNDS))
    d = step_sim.fleet.n_samples.double().numpy()
    carry, level = step_sim._init_carry(), 0.0
    for n in range(ROUNDS):
        carry, out = step_sim._round_body(carry, n, with_eval=False)
        q = out["q_levels"].numpy()
        a = q > 0
        w = np.where(a, d, 0.0) / (d * a).sum()
        theta = carry[3].double().numpy()
        step = w * theta / np.maximum(2.0 ** q - 1.0, 1.0)
        level = max(level, float(np.max(np.where(a, step, 0.0))))
    np.testing.assert_array_equal(carry[0].numpy(), got)
    assert diff.max() <= level + 1e-5, (diff.max(), level)


def test_default_entropy_runs_and_is_seeded():
    kw = dict(n_clients=6, n_channels=3, seed=2, n_test=32, device="cpu")
    a = teng.build_sim("tiny", **kw).run_compiled(2)
    b = teng.build_sim("tiny", **kw).run_compiled(2)
    for k in ("energy", "accuracy", "loss", "q_levels", "lambda1", "lambda2"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert np.isfinite(getattr(a, k)).all()
    assert a.q_levels.shape == (2, 6) and (a.n_scheduled > 0).all()
    ent = DeviceEntropy(0, "cpu")
    idx = ent.batch_indices(0, torch.tensor([1, 7, 300]), 6, 32)
    assert idx.shape == (3, 6, 32) and int(idx[0].max()) == 0
    assert int(idx[1].max()) <= 6 and int(idx[2].max()) <= 299 and int(idx.min()) >= 0


@pytest.mark.parametrize("kwargs", [{"telemetry": object()}], ids=["telemetry"])
def test_unported_options_raise(kwargs):
    # telemetry is ported: what is refused now is a gate that is not a
    # MetricsConfig, before any set-up work
    with pytest.raises(TypeError, match="MetricsConfig"):
        teng.build_sim("tiny", n_clients=4, n_channels=2, n_test=8, device="cpu", **kwargs)
