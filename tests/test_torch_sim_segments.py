"""Segmented runs, checkpoints and resume in the port
(``run_compiled(segment=, ckpt_dir=)``, ``resume_compiled``,
``repro_torch.ckpt``, ``tree.pytree_hash``), held as
``tests/test_sim_faults.py`` holds the JAX engine.

  * a segmented run equals the unsegmented one bit for bit (faults and the
    downlink on, and a clean sim);
  * a fresh sim resumed from the mid-run checkpoint finishes bit for bit
    equal to the unsegmented run: the checkpoint holds the entropy source's
    generator state, which a sequential generator needs where the JAX
    engine's keyed draws do not;
  * the refusals: another seed, other fault rates, another kind, another
    device type, a carry of another arity, an entropy source that keeps no
    state; and the argument rules;
  * the checkpoint files: the port's ``load_checkpoint`` reads a tree that
    the JAX package's ``save_checkpoint`` wrote and the other way round,
    crash-safe ``latest_step``, a corrupted file refused.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.models import cnn as jcnn
from repro_torch import ckpt
from repro_torch import tree as tree_util
from repro_torch.sim import engine as teng
from repro_torch.sim.scenario import FaultSpec
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

SEED = 1
AGGRESSIVE = FaultSpec(outage_p=0.15, outage_corr=0.4, fade_p=0.1, corrupt_p=0.05, nan_p=0.02)
FIELDS = ("accuracy", "loss", "energy", "n_scheduled", "q_levels", "rates", "latency",
          "payload_bits", "lambda1", "lambda2")


def _sim(**kw):
    kw = {"faults": AGGRESSIVE, "downlink": "delta", **kw}
    return teng.build_sim("tiny", n_clients=8, n_channels=4, seed=kw.pop("seed", SEED),
                          n_test=64, device="cpu", **kw)


def _assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.fixture(scope="module")
def full():
    sim = _sim()
    return sim.run_compiled(6), sim.final_flat


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 6-round run in segments of 2, checkpointed after rounds 2 and 4."""
    d = str(tmp_path_factory.mktemp("ck"))
    sim = _sim()
    return d, sim.run_compiled(6, segment=2, ckpt_dir=d), sim.final_flat


def test_segmented_equals_unsegmented(full, saved):
    res, flat = full
    _d, seg, seg_flat = saved
    _assert_same(res, seg)
    assert torch.equal(flat, seg_flat)
    clean_full = _sim(faults=None, downlink=None)
    clean_seg = _sim(faults=None, downlink=None)
    _assert_same(clean_full.run_compiled(4), clean_seg.run_compiled(4, segment=3))
    assert torch.equal(clean_full.final_flat, clean_seg.final_flat)


def test_checkpoints_on_disk(saved):
    d, _seg, _flat = saved
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000002.npz", "step_00000002.npz.json",
                                     "step_00000004.npz", "step_00000004.npz.json"]
    tree, meta = ckpt.load_checkpoint(d)
    assert meta["kind"] == "sim_segment" and meta["next_round"] == 4
    assert (meta["n_rounds"], meta["segment"], meta["seed"]) == (6, 2, SEED)
    assert meta["device_type"] == "cpu" and meta["sim_name"] == "sim_qccf"
    assert sorted(tree["carry"]) == [f"c{i:02d}" for i in range(8)]
    assert tree["entropy"]["round"].dtype == np.uint8
    assert tree["out"]["energy"].shape == (4,)


def test_resume_is_bitwise(full, saved, tmp_path):
    res, flat = full
    d, _seg, _flat = saved
    fresh = _sim()
    resumed = fresh.resume_compiled(d)
    _assert_same(res, resumed)
    assert torch.equal(flat, fresh.final_flat)
    # from the round-2 checkpoint too, which keeps checkpointing
    d2 = str(tmp_path)
    for f in ("step_00000002.npz", "step_00000002.npz.json"):
        with open(os.path.join(d, f), "rb") as src, open(os.path.join(d2, f), "wb") as dst:
            dst.write(src.read())
    _assert_same(res, _sim().resume_compiled(d2))
    assert ckpt.latest_step(d2) == 4


def test_resume_without_the_generator_state_drifts(full, saved):
    """What the saved generator state is for: the same carry with a fresh
    generator draws other numbers from round 4 on."""
    res, _flat = full
    d, _seg, _flat2 = saved
    tree, meta = ckpt.load_checkpoint(d)
    sim = _sim()
    carry = tuple(torch.as_tensor(tree["carry"][k]) for k in sorted(tree["carry"]))
    drift = sim._run_segments(6, True, 2, None, start=4, carry=carry, parts=[tree["out"]])
    np.testing.assert_array_equal(drift.energy[:4], res.energy[:4])
    assert not np.array_equal(drift.lambda1[4:], res.lambda1[4:]) or not np.array_equal(
        drift.accuracy[4:], res.accuracy[4:])


def test_resume_refuses_another_sim(saved, tmp_path):
    d, _seg, _flat = saved
    with pytest.raises(ckpt.CheckpointError, match="seed"):
        _sim(seed=SEED + 1).resume_compiled(d)
    with pytest.raises(ckpt.CheckpointError, match="scenario leaves"):
        _sim(faults=FaultSpec(outage_p=0.9)).resume_compiled(d)
    with pytest.raises(ckpt.CheckpointError, match="carry has 8 slots"):
        _sim(downlink=None).resume_compiled(d)

    class Stateless:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            if name in ("get_state", "set_state"):
                raise AttributeError(name)
            return getattr(self.inner, name)

    stateless = _sim()
    stateless.entropy = Stateless(stateless.entropy)
    with pytest.raises(ckpt.CheckpointError, match="entropy"):
        stateless.resume_compiled(d)
    other = str(tmp_path / "params")
    ckpt.save_checkpoint(other, 3, {"w": np.ones(3, np.float32)}, extra={"kind": "params"})
    with pytest.raises(ckpt.CheckpointError, match="params checkpoint"):
        _sim().resume_compiled(other)
    # a checkpoint taken on another device type
    moved = str(tmp_path / "moved")
    tree, meta = ckpt.load_checkpoint(d)
    extra = {k: v for k, v in meta.items() if k not in ("step", "keys", "arrays")}
    ckpt.save_checkpoint(moved, 4, tree, extra={**extra, "device_type": "cuda"})
    with pytest.raises(ckpt.CheckpointError, match="device type"):
        _sim().resume_compiled(moved)


def test_segment_argument_rules(tmp_path):
    sim = _sim()
    with pytest.raises(ValueError, match="requires segment"):
        sim.run_compiled(4, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="segment=0"):
        sim.run_compiled(4, segment=0)
    host_ga = teng.build_sim("tiny", n_clients=4, n_channels=2, n_test=8, device="cpu",
                             policy_mode="host-ga")
    with pytest.raises(ValueError, match="host-ga"):
        host_ga.run_compiled(2, segment=1)
    with pytest.raises(FileNotFoundError):
        sim.resume_compiled(str(tmp_path / "nothing"))
    # a segment longer than the run is one segment, and no checkpoint
    one = _sim()
    one.run_compiled(2, segment=5, ckpt_dir=str(tmp_path / "one"))
    assert ckpt.latest_step(str(tmp_path / "one")) is None


# ------------------------------------------------------------------- files

def _jax_tree():
    return jax.tree_util.tree_map(
        np.asarray, jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(3)))


def test_port_reads_a_reference_checkpoint(tmp_path):
    params = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 7, params, extra={"kind": "params", "note": "x"})
    tree, meta = ckpt.load_checkpoint(str(tmp_path))
    assert meta["step"] == 7 and meta["note"] == "x"
    assert sorted(tree) == sorted(params)
    for k in params:
        for n in params[k]:
            np.testing.assert_array_equal(tree[k][n], params[k][n])


def test_reference_reads_a_port_checkpoint(tmp_path):
    params = {k: {n: torch.from_numpy(np.array(v)) for n, v in leaf.items()}
              for k, leaf in _jax_tree().items()}
    ckpt.save_checkpoint(str(tmp_path), 2, params, extra={"kind": "params"})
    tree, meta = jckpt.load_checkpoint(str(tmp_path))
    assert meta["kind"] == "params"
    for k in params:
        for n in params[k]:
            np.testing.assert_array_equal(tree[k][n], params[k][n].numpy())


def test_checkpoint_crash_safety(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d + "/missing") is None
    ckpt.save_checkpoint(d, 1, {"a": np.arange(3)})
    # a crash mid-save: an npz without its sidecar, and a stray temp file
    with open(os.path.join(d, "step_00000005.npz"), "wb") as f:
        f.write(b"partial")
    with open(os.path.join(d, "junk.tmp"), "wb") as f:
        f.write(b"x")
    assert ckpt.latest_step(d) == 1
    tree, _ = ckpt.load_checkpoint(d)
    np.testing.assert_array_equal(tree["a"], np.arange(3))
    with pytest.raises(ckpt.CheckpointError, match="unreadable"):
        ckpt.load_checkpoint(d, step=5)
    # a sidecar that disagrees with its npz
    side = os.path.join(d, "step_00000001.npz.json")
    meta = json.load(open(side))
    meta["arrays"]["a"]["shape"] = [4]
    with open(side, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        ckpt.load_checkpoint(d, step=1)


def test_pytree_hash():
    base = {"eps": np.array([1.0, 2.0], np.float32), "d": {"x": torch.arange(4.0)}}
    h = tree_util.pytree_hash(base)
    assert h == tree_util.pytree_hash({"d": {"x": np.arange(4.0, dtype=np.float32)},
                                       "eps": torch.tensor([1.0, 2.0])})
    for other in ({**base, "eps": np.array([1.0, 2.5], np.float32)},
                  {**base, "eps": np.array([1.0, 2.0], np.float64)},
                  {**base, "d": {"y": torch.arange(4.0)}},
                  {**base, "d": {"x": torch.arange(4.0).reshape(2, 2)}}):
        assert tree_util.pytree_hash(other) != h
    assert len(h) == 16
