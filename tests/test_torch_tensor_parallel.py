"""Tensor and expert parallelism on ``model`` with FSDP on ``data``
(``repro_torch.dist.parallel``) on CPU ranks of a gloo group: the reduced
Llama-3-8B (H 4 / KV 1: at ``model`` 2 its KV heads stay whole and each
rank expands GQA for its heads; at ``model`` 4 the same), Phi-3-medium's
head counts (H 40 / KV 10 at head_dim 16: at ``model`` 4, H divides and
KV does not), the reduced Granite-3.0 1B-A400M (experts on ``model``),
RWKV6-7B (WKV heads, channel-mix columns), Zamba2-7B (Mamba2 heads with
the in-projection's output gathered, the shared attention), SeamlessM4T-
large-v2 (self- and cross-attention heads, encoder and decoder SwiGLUs)
and InternVL2-26B (GQA expanded per rank, ``vis_proj`` gathered) on
``1x2``, ``2x2`` and ``1x4`` meshes. Parameters are placed as DTensors
(``dist.placement.place_tree``), every rank passes the global batch.

Tolerances: the loss within 1e-5 relative and every gradient leaf within
1e-5 of its largest magnitude of the port's unsharded ``value_and_grad``
(the row-parallel sums add m partial products where one matmul adds
them once); one adamw ``make_train_step`` of the reduced Llama on ``2x2``
against the JAX package's jitted step with ``param_specs`` shardings on 4
forced host devices (a subprocess), held with the Adam first-step bound
of ``tests/test_torch_train_step.py`` (``torch_replay.
assert_adam_step_close``); the same for the reduced Zamba2-7B on ``1x2``
against JAX's step on a ``1x2`` mesh, whose in-projection columns do not
line up with the heads; and the reduced Granite on ``1x4``, whose experts
and capacity both divide ``model``: the MoE's all-to-all route
(``models.moe``) against JAX's step, whose HLO holds an all-to-all.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_replay import assert_adam_step_close, one_torch_thread, spawn_gloo  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x2": 2, "2x2": 4, "1x4": 4}
CASES = ("llama3_8b", "phi3_h40_kv10", "granite_moe_1b_a400m", "rwkv6_7b", "zamba2_7b",
         "seamless_m4t_large_v2", "internvl2_26b")
JAX_STEPS = {"llama3_8b": "2x2", "zamba2_7b": "1x2",     # arch: mesh of the step held to JAX's
             "granite_moe_1b_a400m": "1x4"}
B, S, LR = 4, 64, 3e-3

_JAX_STEP = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.dist import sharding as shd
from repro.dist.activations import activation_mesh
from repro.dist.hlo_analysis import weighted_collectives
from repro.dist.plan import make_plan
from repro.launch import steps
from repro.models import model
from repro.optim import adamw, clip_by_global_norm
out, lr = sys.argv[1], float(sys.argv[2])
for arch, shape in zip(sys.argv[3::2], sys.argv[4::2]):
    cfg = get_reduced(arch)
    data = dict(np.load(f"{out}/weights_{arch}.npz"))
    params, batch = {}, {}
    for key, arr in data.items():
        if key.startswith("batch/"):
            batch[key[6:]] = jnp.asarray(arr)
            continue
        node = params
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    dims = tuple(int(n) for n in shape.split("x"))
    mesh = Mesh(np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims), ("data", "model"))
    plan = make_plan(mesh)
    opt = adamw(lr)
    step, _ = steps.make_train_step(cfg, mesh, opt)
    pspecs = plan.named(shd.param_specs(plan, params))
    state = opt.init(params)
    p = jax.device_put(params, pspecs)
    st = jax.device_put(state, plan.named(shd.make_opt_specs(mesh, state, pspecs)))
    with activation_mesh(plan):
        compiled = jax.jit(step).lower(p, st, batch).compile()
        new, _, met = compiled(p, st, batch)
    grads = jax.grad(lambda q: model.forward_train(cfg, q, batch)[0])(params)
    clipped, _ = clip_by_global_norm(grads, 1.0)
    res = {"loss": np.asarray(met["loss"]), "grad_norm": np.asarray(met["grad_norm"]),
           "a2a": weighted_collectives(compiled.as_text())["counts"].get("all-to-all", 0)}
    leaves = zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(clipped))
    for i, (a, c) in enumerate(leaves):
        res[f"p{i}"], res[f"c{i}"] = np.asarray(a), np.asarray(c)
    np.savez(f"{out}/jax_step_{arch}.npz", **res)
print("JAX-TP-OK")
"""


def _cfg(name):
    from repro_torch.configs import get_reduced

    if name == "phi3_h40_kv10":
        return dataclasses.replace(get_reduced("phi3_medium_14b"), n_heads=40, n_kv_heads=10,
                                   head_dim=16)
    return get_reduced(name)


def _batch(cfg):
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "mask": torch.as_tensor((rng.random((B, S)) > 0.2).astype(np.float32))}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(
            rng.standard_normal((B, 24, cfg.d_model), dtype=np.float32))
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
    return batch


def _params(cfg):
    from repro_torch.models import model

    return model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)


def _tp_rank(rank, world, out_dir, mesh_shape):
    """Loss and gathered gradients of every case and the train steps of
    ``JAX_STEPS`` on their meshes, on one rank; pickled by rank."""
    from repro_torch import tree as tree_util
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw

    mesh = make_production_mesh(shape=mesh_shape, device="cpu")
    plan = make_plan(mesh)
    res = {}
    for name in CASES:
        cfg = _cfg(name)
        placed = place_tree(plan, _params(cfg))
        with activation_mesh(plan), CollectiveCounter() as c:
            loss, _, grads = value_and_grad(cfg, placed, _batch(cfg))
        same = all(g.placements == p.placements
                   for g, p in zip(tree_util.leaves(grads), tree_util.leaves(placed)))
        res[name] = (loss, full_tree(grads), same)
        res["a2a", name] = sum(1 for r in c.log if r.kind == "all-to-all")
    for arch, shape in JAX_STEPS.items():
        if shape != mesh_shape:
            continue
        cfg = _cfg(arch)
        opt = adamw(LR)
        placed = place_tree(plan, _params(cfg))
        new, _, met = make_train_step(cfg, opt, mesh=mesh)(placed, opt.init(placed), _batch(cfg))
        res["step", arch] = (full_tree(new), met)
    with open(os.path.join(out_dir, f"{mesh_shape}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch import tree as tree_util
    from repro_torch.launch.steps import value_and_grad
    from torch_replay import join_all

    out = tmp_path_factory.mktemp("tp")
    for arch in JAX_STEPS:
        cfg = _cfg(arch)
        flat = {"/".join(p): t.numpy() for p, t in zip(tree_util.paths(_params(cfg)),
                                                       tree_util.leaves(_params(cfg)))}
        flat.update({f"batch/{k}": v.numpy().astype(np.int32 if v.dtype == torch.int64
                                                     else np.float32)
                     for k, v in _batch(cfg).items()})
        np.savez(out / f"weights_{arch}.npz", **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = [x for arch, shape in JAX_STEPS.items() for x in (arch, shape)]
    proc = subprocess.Popen([sys.executable, "-c", _JAX_STEP, str(out), str(LR), *jobs],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        for group in (("1x2", "2x2"), ("1x4",)):
            join_all(*[spawn_gloo(_tp_rank, MESHES[m], out, str(out), m, join=False)
                       for m in group])
        refs = {}
        for name in CASES:
            c = _cfg(name)
            refs[name] = value_and_grad(c, _params(c), _batch(c))
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-TP-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    ranks = {}
    for m, n in MESHES.items():
        for r in range(n):
            with open(out / f"{m}_rank{r}.pkl", "rb") as f:
                ranks[m, r] = pickle.load(f)
    return ranks, refs, {arch: dict(np.load(out / f"jax_step_{arch}.npz")) for arch in JAX_STEPS}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_loss_and_every_gradient_match_unsharded(runs, mesh, case):
    from repro_torch import tree as tree_util

    ranks, refs, _ = runs
    want_loss, _, want = refs[case]
    for r in range(MESHES[mesh]):
        loss, grads, same = ranks[mesh, r][case]
        assert same, "a gradient's placements differ from its parameter's"
        np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-5)
        for path, g, w in zip(tree_util.paths(want), tree_util.leaves(grads),
                              tree_util.leaves(want)):
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            assert err <= 1e-5 * scale, (path, err, scale)


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_gets_the_same_loss(runs, mesh):
    ranks, _, _ = runs
    for case in CASES:
        losses = [ranks[mesh, r][case][0] for r in range(MESHES[mesh])]
        assert all(torch.equal(x, losses[0]) for x in losses), (case, losses)


def _step_matches_jax(runs, arch):
    from repro_torch import tree as tree_util

    ranks, _, jax_steps = runs
    mesh, jax_step = JAX_STEPS[arch], jax_steps[arch]
    new, met = ranks[mesh, 0]["step", arch]
    np.testing.assert_allclose(met["loss"].item(), float(jax_step["loss"]), rtol=1e-5)
    np.testing.assert_allclose(met["grad_norm"].item(), float(jax_step["grad_norm"]), rtol=1e-5)
    leaves = tree_util.leaves(new)
    assert_adam_step_close([t.numpy() for t in leaves],
                           [jax_step[f"p{i}"] for i in range(len(leaves))],
                           [jax_step[f"c{i}"] for i in range(len(leaves))], LR)
    for r in range(1, MESHES[mesh]):   # every rank leaves with the same parameters
        got = tree_util.leaves(ranks[mesh, r]["step", arch][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves, got))


def test_train_step_on_2x2_matches_jax(runs):
    _step_matches_jax(runs, "llama3_8b")


@pytest.mark.parametrize("mesh", MESHES)
def test_granite_takes_the_all_to_all_route(runs, mesh):
    """Granite's 4 experts and its capacity (40 at S = 64) divide every
    mesh's ``model``: 6 all-to-alls a layer (forward, remat's recompute,
    backward); no other case issues one."""
    ranks, _, _ = runs
    for r in range(MESHES[mesh]):
        for case in CASES:
            want = 6 * _cfg(case).n_layers if case == "granite_moe_1b_a400m" else 0
            assert ranks[mesh, r]["a2a", case] == want, case


def test_granite_train_step_on_1x4_matches_jax(runs):
    """The all-to-all route against JAX's step, whose HLO holds an
    all-to-all too: route against route."""
    _step_matches_jax(runs, "granite_moe_1b_a400m")
    assert int(runs[2]["granite_moe_1b_a400m"]["a2a"]) > 0


def test_zamba2_train_step_on_1x2_matches_jax(runs):
    """The Mamba2 in-projection's columns at ``model`` 2 (536 a rank: all
    of z and part of x on rank 0) against GSPMD's own answer."""
    _step_matches_jax(runs, "zamba2_7b")
