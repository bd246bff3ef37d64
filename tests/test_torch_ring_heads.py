"""The sequence ring with heads on ``model`` on 4 CPU ranks of a gloo group
(``seq`` 2 x ``model`` 2, a ``(1, 1, 2, 2)`` mesh under its serve plan,
parameters placed as DTensors): the reduced Llama-3-8B with flash
attention at S = 4,096, with KV 2 (both head counts divide ``model``:
each rank runs the ring over its seq group on its H/2 and KV/2 heads) and
with its own KV 1 (KV does not divide: the heads stay replicated under the
ring, the JAX package's rule, the query weights gathered over ``model``).

``forward_logits`` against the JAX package's under ``activation_mesh`` of
the same mesh shape on 4 forced host devices (a subprocess) and against
the port's unsharded forward, fp32, rtol 1e-5; the prefill's logits and
cache (each rank's KV heads) against the unsharded prefill's; and the
ring's group: ``mesh.get_group("seq")`` is the seq group at the rank's
model coordinate.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"kv2_heads_on_model": 2, "kv1_heads_replicated": 1}
S, B = 4096, 1

_JAX_FORWARD = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.dist.activations import activation_mesh
from repro.dist.plan import make_plan
from repro.models import forward_logits
out_dir = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 2, 2), ("pod", "data", "seq", "model"))
for name, kv in zip(sys.argv[2::2], sys.argv[3::2]):
    cfg = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash", n_kv_heads=int(kv))
    data = dict(np.load(f"{out_dir}/{name}.npz"))
    params = {}
    for key, arr in data.items():
        if key != "tokens":
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(arr)
    fwd = jax.jit(lambda p, b: forward_logits(cfg, p, b))
    with activation_mesh(make_plan(mesh, mode="serve")):
        logits = np.asarray(fwd(params, {"tokens": jnp.asarray(data["tokens"])}))
    np.save(f"{out_dir}/{name}_logits.npy", logits)
print("JAX-RING-HEADS-OK")
"""


def _inputs(name):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model

    cfg = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash",
                              n_kv_heads=CASES[name])
    params = model.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    return cfg, params, toks


def _ring_rank(rank, world, out_dir):
    import torch.distributed as dist
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan, mesh_coord
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import decode
    from repro_torch.models import model

    mesh = make_production_mesh(shape=(1, 1, 2, 2), device="cpu")
    plan = make_plan(mesh, mode="serve")
    res = {"seq_group": dist.get_process_group_ranks(mesh.get_group("seq")),
           "coord": mesh_coord(mesh)}
    for name in CASES:
        cfg, params, toks = _inputs(name)
        placed = place_tree(plan, params)
        with activation_mesh(plan):
            res[name, "logits"] = model.forward_logits(cfg, placed, {"tokens": toks})
            res[name, "prefill"] = decode.prefill(cfg, placed, {"tokens": toks}, S + 2)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import tree as tree_util
    from repro_torch.models import decode
    from repro_torch.models import model

    out = tmp_path_factory.mktemp("ring_heads")
    args = []
    for name in CASES:
        _cfg, params, toks = _inputs(name)
        flat = {"/".join(p): t.numpy() for p, t in zip(tree_util.paths(params),
                                                       tree_util.leaves(params))}
        np.savez(out / f"{name}.npz", tokens=toks.numpy().astype(np.int32), **flat)
        args += [name, str(CASES[name])]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FORWARD, str(out), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        spawn_gloo(_ring_rank, 4, out, str(out))
        refs = {}
        for name in CASES:
            cfg, params, toks = _inputs(name)
            refs[name] = dict(logits=model.forward_logits(cfg, params, {"tokens": toks}),
                              prefill=decode.prefill(cfg, params, {"tokens": toks}, S + 2))
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-RING-HEADS-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    for name in CASES:
        refs[name]["jax"] = np.load(out / f"{name}_logits.npy")
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


@pytest.mark.parametrize("name", CASES)
def test_ring_with_heads_matches_jax_and_unsharded(runs, name):
    ranks, refs = runs
    for res in ranks:
        got = res[name, "logits"].numpy()
        np.testing.assert_allclose(got, refs[name]["jax"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, refs[name]["logits"].numpy(), rtol=1e-5, atol=1e-5)
    for res in ranks[1:]:
        assert torch.equal(res[name, "logits"], ranks[0][name, "logits"])


@pytest.mark.parametrize("name", CASES)
def test_prefill_cache_holds_the_ranks_heads(runs, name):
    ranks, refs = runs
    want_logits, want = refs[name]["prefill"]
    m = 2 if CASES[name] % 2 == 0 else 1        # KV heads on model only where they divide
    for res in ranks:
        logits, cache = res[name, "prefill"]
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(cache["slot_pos"], want["slot_pos"]) and cache["pos"] == want["pos"]
        kv = want["k"].shape[3] // m
        lo = res["coord"]["model"] * kv if m > 1 else 0
        for key in ("k", "v"):
            assert cache[key].shape[3] == kv
            np.testing.assert_allclose(cache[key].numpy(), want[key][:, :, :, lo:lo + kv].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_seq_group_is_at_the_ranks_model_coordinate(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        model_idx = res["coord"]["model"]
        assert res["seq_group"] == [model_idx, model_idx + 2], (r, res["seq_group"])
        assert res["coord"]["seq"] == r // 2
