"""FSDP alone (``data`` 2, ``model`` 1) for all six families on 2 CPU
ranks of a gloo group: the reduced Llama-3-8B (dense), Granite-3.0
1B-A400M (moe), InternVL2-26B (vlm), SeamlessM4T-large-v2 (encdec),
RWKV6-7B (ssm) and Zamba2-7B (hybrid), parameters and adamw state as
DTensors, each rank keeping its half of the global batch.

Against the port's unsharded step on the same weights and batch: the
loss within 1e-5 relative, every gradient leaf within 1e-5 of its largest
magnitude, the gradient norm within 1e-6 relative (the partial sums of the
sharded leaves add in another order), one adamw ``make_train_step``'s
parameters within the Adam first-step bound of
``tests/test_torch_train_step.py`` (``torch_replay.assert_adam_step_close``);
the step's outputs keep their placements; both ranks issue the same
collectives in the same order (``dist.collectives.CollectiveCounter``'s
log). ``launch.train.main --mesh-shape 2x1`` trains the reduced Llama as
the unsharded launcher does (losses within 1e-5), its checkpoint, written
by rank 0, holds the whole tree, and its ledger holds one copy of the run
(rank 0's: the other ranks write none).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from torch_replay import assert_adam_step_close, one_torch_thread, spawn_gloo  # noqa: F401

ARCHS = ("llama3_8b", "granite_moe_1b_a400m", "internvl2_26b", "seamless_m4t_large_v2",
         "rwkv6_7b", "zamba2_7b")
B, S, SRC, LR = 4, 64, 48, 3e-3
TRAIN_ARGV = ["--arch", "llama3_8b", "--steps", "2", "--batch", "4", "--seq", "32",
              "--ckpt-every", "2"]


def _inputs(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import model

    cfg = get_reduced(arch)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
             "mask": torch.as_tensor((rng.random((B, S)) > 0.2).astype(np.float32))}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(rng.standard_normal((B, SRC, cfg.d_model),
                                                                  dtype=np.float32))
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
    return cfg, model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32), batch


def _fsdp_rank(rank, world, out_dir):
    from repro_torch import tree as tree_util
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw

    mesh = make_production_mesh(shape="2x1", device="cpu")
    plan = make_plan(mesh)
    res = {}
    for arch in ARCHS:
        cfg, params, batch = _inputs(arch)
        placed = place_tree(plan, params)
        with activation_mesh(plan):
            loss, _, grads = value_and_grad(cfg, placed, batch)
        opt = adamw(LR)
        state = opt.init(placed)
        with CollectiveCounter() as counter:
            new, new_state, met = make_train_step(cfg, opt, mesh=mesh)(placed, state, batch)
        kept = all(a.placements == b.placements for a, b in
                   zip(tree_util.leaves(new) + tree_util.leaves(new_state["mu"])
                       + tree_util.leaves(new_state["nu"]),
                       tree_util.leaves(placed) * 3))
        res[arch] = dict(loss=loss, grads=full_tree(grads), new=full_tree(new), metrics=met,
                         kept=kept, log=counter.signature())
    from repro_torch.launch import train

    run = train.main(TRAIN_ARGV + ["--mesh-shape", "2x1", "--ckpt-dir",
                                   os.path.join(out_dir, "ckpt"), "--ledger",
                                   os.path.join(out_dir, "ledger.jsonl")], device="cpu")
    res["launcher"] = (run.losses, run.grad_norms, run.params)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw, clip_by_global_norm

    out = tmp_path_factory.mktemp("fsdp")
    spawn_gloo(_fsdp_rank, 2, out, str(out))
    refs = {}
    for arch in ARCHS:
        cfg, params, batch = _inputs(arch)
        loss, _, grads = value_and_grad(cfg, params, batch)
        clipped, _ = clip_by_global_norm(grads, 1.0)
        opt = adamw(LR)
        new, _, met = make_train_step(cfg, opt)(params, opt.init(params), batch)
        refs[arch] = dict(loss=loss, grads=grads, clipped=clipped, new=new, metrics=met)
    from repro_torch.launch import train

    refs["launcher"] = train.main(TRAIN_ARGV, device="cpu")
    refs["ckpt_dir"] = out / "ckpt"
    refs["ledger"] = out / "ledger.jsonl"
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_unsharded(runs, arch):
    from repro_torch import tree as tree_util

    ranks, refs = runs
    want = refs[arch]
    for res in ranks:
        np.testing.assert_allclose(res[arch]["loss"].item(), want["loss"].item(), rtol=1e-5)
        for path, g, w in zip(tree_util.paths(want["grads"]), tree_util.leaves(res[arch]["grads"]),
                              tree_util.leaves(want["grads"])):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            assert err <= 1e-5 * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded(runs, arch):
    from repro_torch import tree as tree_util

    ranks, refs = runs
    want = refs[arch]
    for res in ranks:
        met = res[arch]["metrics"]
        np.testing.assert_allclose(met["loss"].item(), want["metrics"]["loss"].item(), rtol=1e-5)
        np.testing.assert_allclose(met["grad_norm"].item(), want["metrics"]["grad_norm"].item(),
                                   rtol=1e-6)
        assert set(met) == set(want["metrics"])
        assert_adam_step_close([t.numpy() for t in tree_util.leaves(res[arch]["new"])],
                               [t.numpy() for t in tree_util.leaves(want["new"])],
                               [t.numpy() for t in tree_util.leaves(want["clipped"])], LR,
                               grad_rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_kept_and_collectives_alike_on_both_ranks(runs, arch):
    ranks, _ = runs
    assert all(res[arch]["kept"] for res in ranks)
    log0, log1 = ranks[0][arch]["log"], ranks[1][arch]["log"]
    assert log0 and log0 == log1
    kinds = {rec[0] for rec in log0}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds, kinds


def test_train_launcher_mesh_shape(runs):
    from repro_torch import tree as tree_util
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.obs import read_ledger

    ranks, refs = runs
    events = [(e["event"], e.get("phase")) for e in read_ledger(str(refs["ledger"]))]
    assert events == [("run_header", None), ("timing", "first_step"),
                      ("timing", "train_loop")], events
    want = refs["launcher"]
    tree, meta = load_checkpoint(str(refs["ckpt_dir"]))
    assert int(meta["step"]) == 2
    for res in ranks:
        losses, gnorms, params = res["launcher"]
        np.testing.assert_allclose(losses, want.losses, rtol=1e-5)
        np.testing.assert_allclose(gnorms, want.grad_norms, rtol=1e-5)
        assert [tuple(t.shape) for t in tree_util.leaves(params)] == \
            [tuple(t.shape) for t in tree_util.leaves(want.params)]
        for saved, t in zip(tree_util.leaves(tree), tree_util.leaves(params)):
            assert np.array_equal(np.asarray(saved), t.numpy())
