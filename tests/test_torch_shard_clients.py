"""``FleetSim.shard_clients`` of the port on 2 and 4 CPU ranks of a gloo
group: the client-sharded fleet (each rank holds its clients' rows, the
slots' rows assembled by an all-reduce) runs bit-equal to the unsharded
sim in every output and the final parameters: greedy, the compiled GA,
faults, the downlink, a segmented run and its resume, and U = 6 on 4
ranks (replicated, as the divisibility rule says). Its q and schedule equal
the JAX package's ``shard_clients`` run on 8 forced host devices (a
subprocess), the port replaying the JAX engine's draws.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.sim import engine as jeng
from repro_torch.core.genetic import GAConfig
from repro_torch.sim import engine as teng
from repro_torch.sim.scenario import FaultSpec
from torch_replay import ReplayEntropy, join_all, one_torch_thread, spawn_gloo  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 2
BASE = dict(n_test=64, device="cpu")
CONFIGS = {
    "greedy": dict(n_clients=8, seed=4),
    "compiled-ga": dict(n_clients=8, seed=5, policy_mode="compiled-ga",
                        ga_config=GAConfig(generations=4, population=8, elitism=2,
                                           repair_infeasible=True)),
    "faults": dict(n_clients=8, seed=6, faults=FaultSpec(outage_p=0.15, outage_corr=0.4,
                                                          fade_p=0.1, corrupt_p=0.05,
                                                          nan_p=0.02)),
    "downlink": dict(n_clients=8, seed=7, downlink="quant"),
    "u6": dict(n_clients=6, seed=8),
}


class RecordedEntropy:
    """Hands out, in order, the draws a source gave one run (``record``):
    a sharded rank makes the unsharded run's calls in the same order."""

    def __init__(self, calls):
        self.calls = list(calls)
        self.i = 0

    def __getattr__(self, name):
        if name.startswith("_") or name in ("get_state", "set_state"):
            raise AttributeError(name)

        def replay(*_args, **_kw):
            want, value = self.calls[self.i]
            assert want == name, (self.i, want, name)
            self.i += 1
            return value

        return replay

    @classmethod
    def record(cls, source):
        calls = []

        class Recorder:
            def __getattr__(self, name):
                if name.startswith("_") or name in ("get_state", "set_state"):
                    raise AttributeError(name)
                fn = getattr(source, name)

                def rec(*a, **kw):
                    out = fn(*a, **kw)
                    calls.append((name, out))
                    return out

                return rec

        return Recorder(), calls


def _outputs(res, sim) -> dict:
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
           if isinstance(getattr(res, f.name), np.ndarray)}
    out["final_flat"] = sim.final_flat.clone()
    return out


def _same(a: dict, b: dict) -> list:
    """The names of the outputs that differ (NaN equal to NaN)."""
    bad = [k for k in a if k != "final_flat" and not np.array_equal(a[k], b[k], equal_nan=True)]
    if not torch.equal(a["final_flat"], b["final_flat"]):
        bad.append("final_flat")
    return bad


def _baselines() -> dict:
    """Each config's unsharded run (and the 4-round greedy run the segments
    are held to)."""
    out = {}
    for name, kw in CONFIGS.items():
        sim = teng.build_sim("tiny", **BASE, **kw)
        out[name] = _outputs(sim.run_compiled(ROUNDS), sim)
    sim = teng.build_sim("tiny", **BASE, **CONFIGS["greedy"])
    out["greedy4"] = _outputs(sim.run_compiled(4), sim)
    return out


def _shard_ranks(rank, world, inputs, out_dir):
    """Each config sharded on this rank against its unsharded run; the
    segmented run and its resume; the replayed run. Differences pickled per
    rank."""
    from torch.distributed.device_mesh import init_device_mesh

    with open(inputs, "rb") as f:
        baselines, calls, params = pickle.load(f)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res = {}
    for name, kw in CONFIGS.items():
        base = baselines[name]
        sim = teng.build_sim("tiny", **BASE, **kw)
        sim.shard_clients(mesh)
        sharded = sim.fleet.group is not None
        rows = (sim.fleet.client_offset, int(sim.fleet.x.shape[0]), sim.fleet.n_clients)
        res[name] = (_same(base, _outputs(sim.run_compiled(ROUNDS), sim)), sharded, rows)
    # segments and a resume: 4 rounds in segments of 2, each rank checkpointing
    # into its own directory, against the unsharded unsegmented run
    kw, base = CONFIGS["greedy"], baselines["greedy4"]
    ckpt = f"{out_dir}/ckpt_w{world}_r{rank}"
    sim = teng.build_sim("tiny", **BASE, **kw)
    sim.shard_clients(mesh)
    seg = _outputs(sim.run_compiled(4, segment=2, ckpt_dir=ckpt), sim)
    fresh = teng.build_sim("tiny", **BASE, **kw)
    fresh.shard_clients(mesh)
    resumed = _outputs(fresh.resume_compiled(ckpt), fresh)
    res["segments"] = (_same(base, seg), True, None)
    res["resume"] = (_same(base, resumed), True, None)
    # the JAX engine's draws, recorded from the unsharded replay
    sim = teng.build_sim("tiny", n_clients=8, seed=4, **BASE, entropy=RecordedEntropy(calls),
                         init_params=params)
    sim.shard_clients(mesh)
    r = sim.run_compiled(ROUNDS, with_eval=False)
    res["replay"] = {"q_levels": r.q_levels, "rates": r.rates, "n_scheduled": r.n_scheduled}
    with open(f"{out_dir}/rank{rank}_w{world}.pkl", "wb") as f:
        pickle.dump(res, f)


def _jax_params():
    import jax

    from repro.models import cnn as jcnn
    from repro_torch.models import cnn as tcnn

    params = jax.tree_util.tree_map(np.asarray,
                                    jcnn.init_params(jcnn.TINY_CNN, jax.random.PRNGKey(4)))
    return tcnn.params_from_numpy(params, "cpu")


_JAX_SHARDED = r"""
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.sim import build_sim
assert len(jax.devices()) == 8, jax.devices()
sim = build_sim("tiny", n_clients=8, seed=4, n_test=64)
sim.shard_clients(Mesh(np.array(jax.devices()), ("data",)), axis="data")
res = sim.run_compiled(2, with_eval=False)
print("JAX-SHARDED " + json.dumps({"q_levels": np.asarray(res.q_levels).tolist(),
                                    "scheduled": (np.asarray(res.rates) > 0).tolist(),
                                    "n_scheduled": np.asarray(res.n_scheduled).tolist()}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SHARDED], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        jsim = jeng.build_sim("tiny", n_clients=8, seed=4, n_test=64)
        recorder, calls = RecordedEntropy.record(ReplayEntropy(jsim, ROUNDS))
        params = _jax_params()
        tsim = teng.build_sim("tiny", n_clients=8, seed=4, **BASE, entropy=recorder,
                              init_params=params)
        unsharded = tsim.run_compiled(ROUNDS, with_eval=False)
        with open(out / "inputs.pkl", "wb") as f:
            pickle.dump((_baselines(), calls, params), f)
        join_all(*(spawn_gloo(_shard_ranks, world, out, str(out / "inputs.pkl"), str(out),
                              join=False) for world in (2, 4)))
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    jax_res = json.loads([ln for ln in stdout.splitlines()
                          if ln.startswith("JAX-SHARDED ")][0][len("JAX-SHARDED "):])
    ranks = {}
    for world in (2, 4):
        for r in range(world):
            with open(out / f"rank{r}_w{world}.pkl", "rb") as f:
                ranks[world, r] = pickle.load(f)
    return ranks, unsharded, jax_res


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["greedy", "compiled-ga", "faults", "downlink", "segments",
                                  "resume"])
def test_sharded_run_bit_equal_to_unsharded(runs, world, name):
    ranks, _, _ = runs
    for r in range(world):
        bad, sharded, _rows = ranks[world, r][name]
        assert sharded and bad == [], (world, r, name, bad)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_clients_rows(runs, world):
    ranks, _, _ = runs
    per = 8 // world
    for r in range(world):
        assert ranks[world, r]["greedy"][2] == (r * per, per, 8)


def test_indivisible_fleet_replicates_and_still_matches(runs):
    ranks, _, _ = runs
    for r in range(2):             # 6 clients divide over 2 ranks
        bad, sharded, rows = ranks[2, r]["u6"]
        assert sharded and bad == [] and rows == (r * 3, 3, 6)
    for r in range(4):             # and not over 4: the spec replicates
        bad, sharded, rows = ranks[4, r]["u6"]
        assert not sharded and bad == [] and rows == (0, 6, 6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_q_and_schedule_equal_jax_sharded(runs, world):
    ranks, unsharded, jax_res = runs
    np.testing.assert_array_equal(unsharded.q_levels, np.asarray(jax_res["q_levels"]))
    np.testing.assert_array_equal(unsharded.rates > 0, np.asarray(jax_res["scheduled"]))
    for r in range(world):
        got = ranks[world, r]["replay"]
        np.testing.assert_array_equal(got["q_levels"], np.asarray(jax_res["q_levels"]))
        np.testing.assert_array_equal(got["rates"] > 0, np.asarray(jax_res["scheduled"]))
        np.testing.assert_array_equal(got["n_scheduled"], np.asarray(jax_res["n_scheduled"]))
        np.testing.assert_array_equal(got["rates"], unsharded.rates)


def test_shard_clients_twice_raises():
    class Mesh:
        mesh_dim_names = ("data",)

    sim = teng.build_sim("tiny", n_clients=8, seed=4, **BASE)
    sim.fleet = dataclasses.replace(sim.fleet, group=object())
    with pytest.raises(ValueError, match="sharded already"):
        sim.shard_clients(Mesh)
