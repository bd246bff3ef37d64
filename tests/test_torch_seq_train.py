"""Sequence parallelism in training on CPU ranks of a gloo group: the
train step on a ``(1, 1, 2, 1)`` mesh (2 ranks) and on ``(1, 2, 2, 1)``
(4 ranks: FSDP on ``data`` beside ``seq``), parameters placed as DTensors,
each rank passing the global batch and keeping its rows and its S / 2
positions (``models.model.seq_shard``).

The five families' reduced configs: Llama-3-8B (dense; K and V gathered
over ``seq`` with a reduce-scatter backward, GQA expanded per chunk),
Granite-3.0 1B-A400M (moe; one 512-token routing group a shard, the aux
values averaged over the shards; and at 512 positions, one routing group
across the two shards: one queue and capacity, the dispatch summed over
``seq``, the aux values of the whole group), InternVL2-26B (vlm; 8 patch positions
and 6 tokens, 7 positions a shard: shard 0 holds no text and its loss
runs one empty chunk), RWKV6-7B (ssm; the token-shift halos and the WKV
state fold), Zamba2-7B (hybrid; the conv halo, the SSD state fold and
the shared attention gathered) and SeamlessM4T-large-v2 (encdec; 128
source frames and 32 target tokens, each sequence cut by its own length,
the encoder's K/V and its memory gathered over ``seq``; and a 31-token
target, which does not divide and stays whole on every rank: the loss and
the decoder's gradients are not summed over ``seq``, the encoder's are).
Against the port's unsharded
``value_and_grad`` on the same weights and batch: the loss within 1e-5
relative and every gradient leaf within 1e-5 of its largest magnitude
(the sums over shards add in another order); the seq axis must have
carried all-gathers and reduce-scatters, and every rank the same
collectives in the same order.

The reduced Llama, Zamba2, Seamless and Granite (at 512 positions) adamw
``make_train_step`` on ``(1, 1, 2, 1)``
against the JAX package's jitted step on the same weights and batch on
one host device (a subprocess; GSPMD's seq-sharded step computes the same
function): loss and gradient norm within 1e-5 relative, the parameters
within the Adam first-step bound of ``tests/test_torch_train_step.py``
(``torch_replay.assert_adam_step_close``). And in one process, a reduced
RWKV6 layer and Mamba2 block as four shards through
``dist.seq.LocalSeq(4)`` against the unsharded layer, values and
gradients at the same bound.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_replay import assert_adam_step_close, join_all, spawn_gloo
from torch_replay import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEAMLESS = "seamless_m4t_large_v2"
# the context's tokens each (the encdec family: source frames, target tokens)
ARCHS = {"llama3_8b": 256, "granite_moe_1b_a400m": 1024, "internvl2_26b": 6, "rwkv6_7b": 128,
         "zamba2_7b": 128, SEAMLESS: (128, 32), "seamless_target_whole": (128, 31),
         "granite_group_across": 512}
# the cases that are not a config's own name: the config each runs
CONFIGS = {"seamless_target_whole": SEAMLESS, "granite_group_across": "granite_moe_1b_a400m"}
MESHES = {"1x1x2x1": (1, 1, 2, 1), "1x2x2x1": (1, 2, 2, 1)}
JAX_STEPS = ("llama3_8b", "zamba2_7b", SEAMLESS, "granite_group_across")
B, LR = 2, 3e-3

_JAX_STEP = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.launch import steps
from repro.models import model
from repro.optim import adamw, clip_by_global_norm
out, lr = sys.argv[1], float(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
for case in sys.argv[3:]:
    arch, name = case.split("=")
    cfg = get_reduced(name)
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
    opt = adamw(lr)
    step, _ = steps.make_train_step(cfg, mesh, opt)
    new, _, met = jax.jit(step)(params, opt.init(params), batch)
    grads = jax.grad(lambda q: model.forward_train(cfg, q, batch)[0])(params)
    clipped, _ = clip_by_global_norm(grads, 1.0)
    res = {"loss": np.asarray(met["loss"]), "grad_norm": np.asarray(met["grad_norm"])}
    leaves = zip(jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(clipped))
    for i, (a, c) in enumerate(leaves):
        res[f"p{i}"], res[f"c{i}"] = np.asarray(a), np.asarray(c)
    np.savez(f"{out}/jax_step_{arch}.npz", **res)
print("JAX-SEQ-STEP-OK")
"""


def _inputs(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model

    cfg = get_reduced(CONFIGS.get(arch, arch))
    s = ARCHS[arch]
    rng = np.random.default_rng(6)
    src = None
    if cfg.family == "encdec":
        src, s = s
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, s))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, s))),
             "mask": torch.as_tensor((rng.random((B, s)) > 0.2).astype(np.float32))}
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
    if src is not None:
        batch["src_embeds"] = torch.as_tensor(
            rng.standard_normal((B, src, cfg.d_model), dtype=np.float32))
    return cfg, model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32), batch


def _train_rank(rank, world, out_dir, name):
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw

    mesh = make_production_mesh(shape=MESHES[name], device="cpu")
    plan = make_plan(mesh)
    res = {}
    for arch in ARCHS:
        cfg, params, batch = _inputs(arch)
        placed = place_tree(plan, params)
        with CollectiveCounter() as counter, activation_mesh(plan):
            loss, met, grads = value_and_grad(cfg, placed, batch)
        res[arch] = dict(loss=loss, metrics=met, grads=full_tree(grads),
                         log=counter.signature(), totals=counter.totals())
        if name == "1x1x2x1" and arch in JAX_STEPS:
            opt = adamw(LR)
            new, _, step_met = make_train_step(cfg, opt, mesh=mesh)(placed, opt.init(placed),
                                                                     batch)
            res[arch].update(new=full_tree(new), step_metrics=step_met)
    with open(os.path.join(out_dir, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _save(path, params, batch):
    from repro_torch import tree as tree_util

    flat = {"/".join(p): t.numpy() for p, t in zip(tree_util.paths(params),
                                                   tree_util.leaves(params))}
    flat.update({f"batch/{k}": (v.numpy().astype(np.int32) if v.dtype == torch.int64
                                else v.numpy()) for k, v in batch.items()})
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.optim import clip_by_global_norm

    out = tmp_path_factory.mktemp("seq_train")
    for arch in JAX_STEPS:
        _cfg, params, batch = _inputs(arch)
        _save(out / f"weights_{arch}.npz", params, batch)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_STEP, str(out), str(LR),
                             *[f"{a}={CONFIGS.get(a, a)}" for a in JAX_STEPS]],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        worlds = [spawn_gloo(_train_rank, int(np.prod(s)), out, str(out), n, join=False)
                  for n, s in MESHES.items()]
        refs = {}
        for arch in ARCHS:
            cfg, params, batch = _inputs(arch)
            loss, met, grads = value_and_grad(cfg, params, batch)
            refs[arch] = dict(loss=loss, metrics=met, grads=grads,
                              clipped=clip_by_global_norm(grads, 1.0)[0])
        join_all(*worlds)
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-SEQ-STEP-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    for arch in JAX_STEPS:
        refs[arch]["jax"] = dict(np.load(out / f"jax_step_{arch}.npz"))
    ranks = {}
    for name, shape in MESHES.items():
        for r in range(int(np.prod(shape))):
            with open(out / f"{name}_rank{r}.pkl", "rb") as f:
                ranks[name, r] = pickle.load(f)
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MESHES)
def test_loss_and_gradients_match_unsharded(runs, name, arch):
    from repro_torch import tree as tree_util

    ranks, refs = runs
    want = refs[arch]
    for r in range(int(np.prod(MESHES[name]))):
        res = ranks[name, r][arch]
        np.testing.assert_allclose(res["loss"].item(), want["loss"].item(), rtol=1e-5)
        assert set(res["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k].item(), v.item(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for path, g, w in zip(tree_util.paths(want["grads"]), tree_util.leaves(res["grads"]),
                              tree_util.leaves(want["grads"])):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            assert err <= 1e-5 * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", MESHES)
def test_seq_collectives_alike_on_every_rank(runs, name, arch):
    ranks, _ = runs
    n = int(np.prod(MESHES[name]))
    seq = ranks[name, 0][arch]["totals"]["seq"]
    assert seq["all-gather"]["count"] > 0 and seq["reduce-scatter"]["count"] > 0, seq
    assert seq["all-reduce"]["count"] > 0, seq       # the gradient sum, the loss's sums
    if arch.startswith("seamless"):
        # 2 encoder layers' K, V in the forward and the recompute, the memory
        # once; with the target cut, 2 decoder layers' K, V too
        whole = arch == "seamless_target_whole"
        assert seq["all-gather"]["count"] == 2 * 2 * 2 + 1 + (0 if whole else 2 * 2 * 2)
        assert seq["reduce-scatter"]["count"] == (2 * 2 if whole else 2 * 2 * 2 + 1)
    if name == "1x2x2x1":
        data = ranks[name, 0][arch]["totals"]["data"]
        assert data["all-gather"]["count"] > 0 and data["reduce-scatter"]["count"] > 0, data
    logs = [ranks[name, r][arch]["log"] for r in range(n)]
    assert all(log == logs[0] for log in logs[1:])


@pytest.mark.parametrize("arch", JAX_STEPS)
def test_adamw_step_matches_jax(runs, arch):
    from repro_torch import tree as tree_util

    ranks, refs = runs
    jx = refs[arch]["jax"]
    n_leaves = len(tree_util.leaves(refs[arch]["grads"]))
    for r in range(2):
        res = ranks["1x1x2x1", r][arch]
        met = res["step_metrics"]
        np.testing.assert_allclose(met["loss"].item(), float(jx["loss"]), rtol=1e-5)
        np.testing.assert_allclose(met["grad_norm"].item(), float(jx["grad_norm"]), rtol=1e-5)
        assert_adam_step_close([t.numpy() for t in tree_util.leaves(res["new"])],
                               [jx[f"p{i}"] for i in range(n_leaves)],
                               [jx[f"c{i}"] for i in range(n_leaves)], LR, grad_rel=1e-5)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_local_seq_layer_matches_one_scan(arch):
    """One reduced RWKV6 layer and Mamba2 block over B = 2 x 256 positions
    as four shards in one process (``dist.seq.LocalSeq(4)``: the halos and
    the state fold) against the unsharded layer: outputs, final states and
    carries, and the input's and every weight's gradient, within 1e-5 of
    each one's largest magnitude."""
    from repro_torch import tree as tree_util
    from repro_torch.dist.seq import LocalSeq
    from repro_torch.models import model

    cfg, params, _ = _inputs(arch)
    lp = tree_util.map(lambda t: t.detach().requires_grad_(True), model.layer_params(params, 0))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((B, 256, cfg.d_model),
                                                                 dtype=np.float32))
    x.requires_grad_(True)

    def layer(seq):
        if arch == "rwkv6_7b":
            x_prev, s0 = model.rwkv_state(cfg, B, "cpu")
            return list(model._rwkv_block(cfg, lp, x, x_prev, x_prev, s0, seq=seq))
        out, st = model._mamba_block(cfg, lp, x, seq=seq)
        return [out, st["ssm"], st["conv"]]

    leaves = [x] + tree_util.leaves(lp)
    results = []
    for seq in (None, LocalSeq(4)):
        outs = layer(seq)
        loss = sum((o.float() ** 2).mean() for o in outs)
        results.append((outs, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                  materialize_grads=True)))
    (want, want_g), (got, got_g) = results
    for g, w in list(zip(got, want)) + list(zip(got_g, want_g)):
        g, w = g.detach(), w.detach()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= 1e-5 * scale, (err, scale)
