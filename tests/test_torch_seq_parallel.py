"""Sequence-parallel dense forward and prefill of the port on 4 CPU ranks
of a gloo group (a ``(1, 1, 4, 1)`` mesh, ``activation_mesh`` of its serve
plan): the reduced Llama-3-8B and StarCoder2-7B (sliding window) with
``attn_impl="flash"`` at S = 4,096 against the JAX package's
``forward_logits`` under ``activation_mesh`` of the same mesh shape on 4
forced host devices (a subprocess) and against the port's unsharded
forward; the prefill's cache and logits and the greedy tokens against the
unsharded ones; and the refusals (other families, a context off the ring
path, a model axis for a family without tensor parallelism).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import model as tmodel
from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3_8b", "starcoder2_7b")
S, B, NEW = 4096, 2, 3

# the JAX forward on the port's weights (the same tree, leaf for leaf)
_JAX_FORWARD = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.dist.activations import activation_mesh
from repro.dist.plan import make_plan
from repro.models import forward_logits
out_dir = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 4, 1), ("pod", "data", "seq", "model"))
for arch in sys.argv[2:]:
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="flash")
    data = dict(np.load(f"{out_dir}/{arch}.npz"))
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
    np.save(f"{out_dir}/{arch}_logits.npy", logits)
print("JAX-SEQ-OK")
"""


def _inputs(arch):
    """The reduced ``arch`` with flash attention, its fp32 weights from seed
    0 and a (B, S) context."""
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="flash")
    params = tmodel.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    return cfg, params, toks


def _save(path, params, toks):
    from repro_torch import tree as tree_util

    flat = {"/".join(p): t.numpy() for p, t in zip(tree_util.paths(params),
                                                   tree_util.leaves(params))}
    np.savez(path, tokens=toks.numpy().astype(np.int32), **flat)


def _seq_ranks(rank, world, out_dir):
    """Every sharded run of this module on one rank, pickled to
    ``out_dir/rank<r>.pkl``: logits, prefill logits and cache, greedy tokens
    and the refusals' messages."""
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import decode

    mesh = make_production_mesh(shape=(1, 1, world, 1), device="cpu")
    plan = make_plan(mesh, mode="serve")
    res = {}
    for arch in ARCHS:
        cfg, params, toks = _inputs(arch)
        with activation_mesh(plan):
            res[arch, "logits"] = tmodel.forward_logits(cfg, params, {"tokens": toks})
            res[arch, "prefill"] = decode.prefill(cfg, params, {"tokens": toks}, S + NEW)
            res[arch, "tokens"] = serve.generate(cfg, params, toks, NEW, device="cpu").tokens
    small = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash")
    params = tmodel.init_params(small, 0, device="cpu")
    refusals = {
        "granite": (get_reduced("granite_moe_1b_a400m"), S),
        "rwkv6": (get_reduced("rwkv6_7b"), S),
        "zamba2": (get_reduced("zamba2_7b"), S),
        "internvl2": (get_reduced("internvl2_26b"), S),
        "seamless": (get_reduced("seamless_m4t_large_v2"), S),
        "short": (small, 1024),
        "chunked": (dataclasses.replace(small, attn_impl="chunked"), S),
        "indivisible": (small, S + 64),     # S % n == 0, S % (n chunk_size) != 0
    }
    for name, (cfg, s) in refusals.items():
        batch = {"tokens": torch.zeros((1, s), dtype=torch.int64)}
        try:
            with activation_mesh(plan):
                p = params if cfg is small or cfg.family == "dense" else None
                tmodel.forward_logits(cfg, p, batch)
            res["refusal", name] = None
        except ValueError as e:
            res["refusal", name] = str(e)
    # a model axis above 1 for a recurrent family takes tensor parallelism;
    # beside a seq axis above 1 its sequence-parallel path is distribution
    # part B2c, not ported
    m22 = make_production_mesh(shape=(1, 1, 2, 2), device="cpu")
    rwkv = get_reduced("rwkv6_7b")
    try:
        with activation_mesh(make_plan(m22, mode="serve")):
            tmodel.forward_logits(rwkv, tmodel.init_params(rwkv, 0, device="cpu"),
                                  {"tokens": torch.zeros((1, 64), dtype=torch.int64)})
        res["refusal", "model_axis"] = None
    except ValueError as e:
        res["refusal", "model_axis"] = str(e)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4 gloo ranks and the unsharded references
    run side by side."""
    from repro_torch.launch import serve
    from repro_torch.models import decode

    out = tmp_path_factory.mktemp("seq")
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    for arch, (_cfg, params, toks) in inputs.items():
        _save(out / f"{arch}.npz", params, toks)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FORWARD, str(out), *ARCHS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        spawn_gloo(_seq_ranks, 4, out, str(out))
        refs = {arch: dict(logits=tmodel.forward_logits(cfg, params, {"tokens": toks}),
                           prefill=decode.prefill(cfg, params, {"tokens": toks}, S + NEW),
                           tokens=serve.generate(cfg, params, toks, NEW, device="cpu").tokens)
                for arch, (cfg, params, toks) in inputs.items()}
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-SEQ-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    for arch in ARCHS:
        refs[arch]["jax"] = np.load(out / f"{arch}_logits.npy")
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_jax_and_unsharded(runs, arch):
    ranks, refs = runs
    for res in ranks:
        got = res[arch, "logits"].numpy()
        np.testing.assert_allclose(got, refs[arch]["jax"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, refs[arch]["logits"].numpy(), rtol=1e-5, atol=1e-5)
    for res in ranks[1:]:          # every rank leaves with the same logits
        assert torch.equal(res[arch, "logits"], ranks[0][arch, "logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_unsharded(runs, arch):
    ranks, refs = runs
    want_logits, want = refs[arch]["prefill"]
    for res in ranks:
        logits, cache = res[arch, "prefill"]
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
        assert cache["pos"] == want["pos"] == S
        assert torch.equal(cache["slot_pos"], want["slot_pos"])
        for name in ("k", "v"):
            assert cache[name].shape == want[name].shape
            np.testing.assert_allclose(cache[name].numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_greedy_tokens_identical(runs, arch):
    ranks, refs = runs
    for res in ranks:
        assert torch.equal(res[arch, "tokens"], refs[arch]["tokens"])


@pytest.mark.parametrize("name,match", [
    ("granite", "moe family"), ("rwkv6", "ssm family"), ("zamba2", "hybrid family"),
    ("internvl2", "vlm family"), ("seamless", "encdec family"),
    ("short", "takes the ring"), ("chunked", "takes the ring"),
    ("indivisible", "takes the ring"), ("model_axis", "B2"),
])
def test_off_ring_paths_raise(runs, name, match):
    ranks, _refs = runs
    for res in ranks:
        assert res["refusal", name] is not None and match in res["refusal", name], \
            res["refusal", name]


def test_no_plan_no_seq_axis_run_whole():
    """Without a plan, or under one whose seq axis does not divide S, the
    batch is not sharded: ``seq_shard`` hands it back as it came."""
    cfg = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash")
    batch = {"tokens": torch.zeros((1, 4096), dtype=torch.int64)}
    assert tmodel.seq_shard(cfg, batch) == (None, batch)
