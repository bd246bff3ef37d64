"""A run of the port's fleet engine is a pure function of the sim, and it
fixes its own numeric mode.

  * every run starts from the entropy source's state when the sim was
    built: two ``run_compiled(3)`` calls on one sim are bit-equal, and on the
    JAX engine's draws, handed out as a sequential generator
    (``torch_replay.SequentialReplay``), both equal the JAX engine's
    ``run_compiled(3)`` (q and schedule equal, energy within rtol 1e-5,
    accuracy within 1/256 as in ``tests/test_torch_sim_replay.py``);
  * ``run_host_policy`` after ``run_compiled`` is the run a fresh sim gives,
    and ``resume_compiled`` still restores the checkpoint's own state;
  * rounds run with TF32 off and cuDNN's deterministic algorithms whatever
    the caller set, and the caller's flags are exactly as they were after
    the run, also when a round raises.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.genetic import GAConfig as JGAConfig
from repro.models import cnn as jcnn
from repro.sim import engine as jeng
from repro_torch.core.genetic import GAConfig
from repro_torch.models import cnn as tcnn
from repro_torch.sim import engine as teng
from torch_replay import SequentialReplay, one_torch_thread  # noqa: F401 (autouse fixture)

GA_KW = dict(generations=4, population=8, elitism=2, repair_infeasible=True)
FIELDS = ("energy", "accuracy", "loss", "n_scheduled", "q_levels", "latency",
          "payload_bits", "rates", "lambda1", "lambda2")


def _bit_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _pair(mode, seed=1):
    """(JAX sim, port sim on the JAX draws as a sequential source and the
    JAX weights), tiny task, U = 8; the source holds six rounds' keys, so a
    second 3-round run that did not rewind would draw rounds 3-5."""
    kw = dict(n_clients=8, seed=seed, n_test=256, policy_mode=mode)
    jsim = jeng.build_sim("tiny", ga_config=JGAConfig(**GA_KW), **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(seed)))
    tsim = teng.build_sim("tiny", ga_config=GAConfig(**GA_KW), device="cpu",
                          init_params=tcnn.params_from_numpy(params, "cpu"),
                          entropy=SequentialReplay(jsim, 6), **kw)
    return jsim, tsim


@pytest.mark.parametrize("mode", ["greedy", "compiled-ga"])
def test_two_runs_of_one_sim_are_the_jax_run(mode):
    jsim, tsim = _pair(mode)
    first = tsim.run_compiled(3)
    flat = tsim.final_flat.clone()
    assert tsim.entropy.cursor == 3
    second = tsim.run_compiled(3)
    _bit_equal(first, second)
    assert torch.equal(flat, tsim.final_flat)
    want = jsim.run_compiled(3)
    np.testing.assert_array_equal(second.q_levels, want.q_levels)
    np.testing.assert_array_equal(second.n_scheduled, want.n_scheduled)
    for k in ("energy", "latency", "payload_bits"):
        np.testing.assert_allclose(getattr(second, k), getattr(want, k), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    assert np.max(np.abs(second.accuracy - want.accuracy)) <= 1.0 / 256
    assert second.n_scheduled.max() > 0


def _tiny(**kw):
    return teng.build_sim("tiny", n_clients=8, n_channels=4, seed=2, n_test=64,
                          device="cpu", **kw)


def _records(res):
    return {k: np.array([getattr(r, k) for r in res.records])
            for k in ("energy", "accuracy", "loss", "n_scheduled", "q_levels", "latency",
                      "payload_bits", "rates")}


def test_default_entropy_reruns_and_replays_as_a_fresh_sim():
    """The default ``DeviceEntropy`` (a sequential generator): a warm-up run,
    then two runs, then the host replay on the same sim; the replay equals a
    fresh sim's replay bit for bit and replays the compiled run."""
    sim = _tiny()
    sim.run_compiled(1, with_eval=False)
    a = sim.run_compiled(3)
    b = sim.run_compiled(3)
    _bit_equal(a, b)
    host = _records(sim.run_host_policy(sim.make_host_policy(), 3))
    fresh_sim = _tiny()
    fresh = _records(fresh_sim.run_host_policy(fresh_sim.make_host_policy(), 3))
    for k in host:
        np.testing.assert_array_equal(host[k], fresh[k], err_msg=k)
    assert torch.equal(sim.final_flat, fresh_sim.final_flat)
    np.testing.assert_array_equal(host["q_levels"], a.q_levels)
    np.testing.assert_array_equal(host["n_scheduled"], a.n_scheduled)
    assert a.n_scheduled.max() > 0


def test_resume_on_a_sim_that_ran_restores_the_checkpoint_state(tmp_path):
    sim = _tiny(downlink="delta")
    full = sim.run_compiled(4)
    sim.run_compiled(4, segment=2, ckpt_dir=str(tmp_path))
    sim.run_compiled(1)
    resumed = sim.resume_compiled(str(tmp_path))
    _bit_equal(full, resumed)


FLAGS = (
    (torch.backends.cudnn, "deterministic"),
    (torch.backends.cudnn, "benchmark"),
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_tf32"),
)
EXACT = {"deterministic": True, "benchmark": False, "allow_tf32": False}


@pytest.fixture
def caller_flags():
    """The flags a careless caller might set (TF32 everywhere, cuDNN's
    autotuned, non-deterministic algorithms), restored after the test."""
    before = [getattr(mod, name) for mod, name in FLAGS]
    set_to = {"deterministic": False, "benchmark": True, "allow_tf32": True}
    for mod, name in FLAGS:
        setattr(mod, name, set_to[name])
    yield [set_to[name] for _mod, name in FLAGS]
    for (mod, name), value in zip(FLAGS, before):
        setattr(mod, name, value)


def _flags():
    return [getattr(mod, name) for mod, name in FLAGS]


@pytest.mark.parametrize("entry", ["run_compiled", "run_host_policy", "resume_compiled"])
def test_rounds_fix_their_numeric_mode_and_restore_the_callers(caller_flags, entry, tmp_path):
    sim = _tiny()
    seen = []
    real = teng.fleet_local_sgd

    def spy(*args, **kwargs):
        seen.append(_flags())
        return real(*args, **kwargs)

    if entry == "resume_compiled":
        sim.run_compiled(2, segment=1, ckpt_dir=str(tmp_path))
        assert _flags() == caller_flags
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teng, "fleet_local_sgd", spy)
        if entry == "run_compiled":
            sim.run_compiled(2)
        elif entry == "run_host_policy":
            sim.run_host_policy(sim.make_host_policy(), 2)
        else:
            sim.resume_compiled(str(tmp_path))
    assert seen and all(f == [EXACT[name] for _mod, name in FLAGS] for f in seen)
    assert torch.backends.cudnn.enabled
    assert _flags() == caller_flags


def test_flags_come_back_when_a_round_raises(caller_flags):
    sim = _tiny()

    def boom(*args, **kwargs):
        assert _flags() == [EXACT[name] for _mod, name in FLAGS]
        raise RuntimeError("round failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teng, "fleet_local_sgd", boom)
        with pytest.raises(RuntimeError, match="round failed"):
            sim.run_compiled(1)
    assert _flags() == caller_flags
