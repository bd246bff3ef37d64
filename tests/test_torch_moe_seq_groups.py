"""A MoE routing group that spans ``seq`` shards (``repro_torch.models.moe``:
one queue, one capacity and one dispatched tensor a group, as the JAX
package's cumulative sum and contraction over the global sequence give).

The reduced Granite-3.0 1B-A400M (2 layers, d_model 256, E 4, top-2; C 320
at a 512-token group):

  * in one process, the layer of a (B, S, D) input from a numpy seed
    through ``dist.seq.LocalSeq(n)`` at S = 512 on 2 shards, 1,024 on 4,
    1,536 on 4 (384 positions a shard: groups that straddle the shards'
    edges unevenly) and 768 on 2 (one group of the whole S), at the
    config's capacity and at a capacity factor of 0.5 (dropped slots):
    every group's queue positions and ``keep`` identical to the unsharded
    layer's, its dispatched tensor bit-equal, the output and aux values
    within rtol 1e-5 of the JAX package's ``moe_apply`` on the whole
    sequence (fp32), and the input's and every weight's gradient within
    1e-5 of each one's largest magnitude of the unsharded layer's;
  * the same layer at S = 512 with ``model`` 2 beside ``seq`` 2: the
    all-to-all route (``LocalExchange(2)``), its exchanged blocks bit-equal
    to the all-reduce route's (each rank's experts, ``ExpertSlots``);
  * one 4-rank gloo world: ``forward_logits`` and ``decode.prefill`` at
    the four geometries (serve plans of ``1x1x4x1`` and ``1x1x2x1``) and
    the loss and every gradient leaf of ``value_and_grad`` (full remat)
    at each of them and at S = 512 on ``1x1x2x2`` (the all-to-all route
    over ``model``), against the unsharded port at
    ``tests/test_torch_seq_parallel.py``'s and
    ``tests/test_torch_seq_train.py``'s bounds; the group sums (one
    all-reduce over ``seq`` a layer forward, one in the recompute, one in
    the backward) and every rank issuing the same collectives in the same
    order.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ARCH = "granite_moe_1b_a400m"
B = 2
# (S, seq shards): one group over 2, 512-token groups over 4 (two shards
# each), groups across 384-position shards, one 768-token group over 2
GEOMETRIES = {"s512_n2": (512, 2), "s1024_n4": (1024, 4), "s1536_n4": (1536, 4),
              "s768_n2": (768, 2)}
WORLD = 4
A2A = "s512_n2_m2"                  # S 512 on 1x1x2x2: the all-to-all route beside seq 2
_JAX_APPLY = jax.jit(jmoe.moe_apply, static_argnames=("top_k", "capacity_factor"))


def _cfg():
    from repro_torch.configs import get_reduced

    return get_reduced(ARCH)


def _layer_inputs(s: int):
    """One MoE layer's fp32 weights and a (B, S, D) input (numpy, seeded)."""
    cfg = _cfg()
    rng = np.random.default_rng(29)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": 0.05 * rng.standard_normal((d, e)),
         "wg": 0.02 * rng.standard_normal((e, d, f)),
         "wu": 0.02 * rng.standard_normal((e, d, f)), "wd": 0.02 * rng.standard_normal((e, f, d))}
    x = rng.standard_normal((B, s, d))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


class _Spy:
    """Each ``moe._slots`` call's queue positions and ``keep``, and each
    ``moe._experts`` call's input and output, in call order."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.slots, self.experts = moe, [], []
        self._orig = (moe._slots, moe._experts)

    def __enter__(self):
        slots, experts = self._orig

        def spy_slots(*args, **kw):
            out = slots(*args, **kw)
            self.slots.append((out[0].detach(), out[1].detach()))
            return out

        def spy_experts(params, xe):
            y = experts(params, xe)
            self.experts.append((xe.detach(), y.detach()))
            return y

        self.moe._slots, self.moe._experts = spy_slots, spy_experts
        return self

    def __exit__(self, *exc):
        self.moe._slots, self.moe._experts = self._orig


def _by_group(slots, s: int, n: int, g: int):
    """The shards' pieces (``_slots`` calls in shard order, each shard's
    pieces in group order) put together into each group's (B, g K) queue
    positions and (B, g, K) keep."""
    from repro_torch.models import moe

    s_loc, groups = s // n, {}
    calls = iter(slots)
    for r in range(n):
        for j, _sl, _a in moe.group_pieces(r, s_loc, g):
            pos, keep = next(calls)
            groups.setdefault(j, []).append((pos, keep))
    assert next(calls, None) is None
    return [(torch.cat([p for p, _ in groups[j]], dim=1), torch.cat([q for _, q in groups[j]],
                                                                     dim=1))
            for j in sorted(groups)]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_layer_across_shards_matches_unsharded_and_jax(geometry, cf):
    from repro_torch.dist.seq import LocalSeq
    from repro_torch.models import moe

    cfg = _cfg()
    s, n = GEOMETRIES[geometry]
    p, x = _layer_inputs(s)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    kw = dict(top_k=cfg.top_k, capacity_factor=cf)
    runs = []
    for seq in (None, LocalSeq(n)):
        tx = torch.from_numpy(x).requires_grad_(True)
        with _Spy() as spy:
            out, aux = moe.moe_apply(tp, tx, seq=seq, **kw)
            loss = (out ** 2).mean() + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
            grads = torch.autograd.grad(loss, [tx, *tp.values()])
        runs.append((out.detach(), {a: v.detach() for a, v in aux.items()}, grads, spy))
    (want, want_aux, want_g, whole), (got, got_aux, got_g, sharded) = runs

    g = moe.group_length(s)
    pieces = _by_group(sharded.slots, s, n, g)
    assert len(pieces) == len(whole.slots) == s // g
    for (pos, keep), (want_pos, want_keep) in zip(pieces, whole.slots):
        assert torch.equal(pos, want_pos) and torch.equal(keep, want_keep)
    if cf < 1:
        assert 0 < want_aux["dropped_frac"] < 1     # the queues overflow
    # one expert call a group, its dispatched tensor and output bit-equal
    assert len(sharded.experts) == len(whole.experts) == s // g
    for (xe, y), (want_xe, want_y) in zip(sharded.experts, whole.experts):
        assert torch.equal(xe, want_xe) and torch.equal(y, want_y)

    jout, jaux = _JAX_APPLY({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert set(got_aux) == set(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(got_aux[k].item(), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got_aux[k].item(), want_aux[k].item(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for gg, w in zip(got_g, want_g):
        err, scale = float((gg - w).abs().max()), float(w.abs().max())
        assert err <= 1e-5 * scale, (err, scale)


def test_alltoall_route_beside_seq_shards():
    """S = 512 as 2 ``seq`` shards and 2 ``model`` ranks in one process:
    each rank's exchanged (B, E/2, C, D) blocks and expert outputs are
    bit-equal to the all-reduce route's on the same rank's experts (the
    group's dispatch summed over the shards either way), the outputs
    within rtol 1e-5 of the unsharded layer's."""
    from repro_torch.dist.seq import LocalSeq
    from repro_torch.models import moe

    cfg = _cfg()
    p, x = _layer_inputs(512)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, seq=LocalSeq(2))
    want, want_aux = moe.moe_apply(tp, tx, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    with _Spy() as a2a:
        out, aux = moe.moe_apply(tp, tx, route=moe.LocalExchange(2), **kw)
    e_loc = cfg.n_experts // 2
    parts, ranks = [], []
    for r in range(2):
        with _Spy() as ar:
            part, _ = moe.moe_apply(moe.expert_block(tp, 2, r), tx,
                                    route=moe.ExpertSlots(r * e_loc, (r + 1) * e_loc), **kw)
        parts.append(part)
        ranks.append(ar.experts)
    c = moe.group_capacity(512, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert len(a2a.experts) == 2 and all(len(t) == 1 for t in ranks)
    for r in range(2):
        (xe, y), (ref_xe, ref_y) = a2a.experts[r], ranks[r][0]
        assert xe.shape == (B, e_loc, c, cfg.d_model)
        assert torch.equal(xe, ref_xe) and torch.equal(y, ref_y)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), v.item(), rtol=1e-5, atol=1e-7, err_msg=k)


# ------------------------------------------------------------ the gloo world

def _batch(cfg, s: int):
    rng = np.random.default_rng(s)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, s))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, s))),
            "mask": torch.as_tensor((rng.random((B, s)) > 0.2).astype(np.float32))}


def _params(cfg):
    from repro_torch.models import model

    return model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)


def _cases():
    """name -> (S, mesh shape)."""
    cases = {name: (s, (1, 1, n, 1)) for name, (s, n) in GEOMETRIES.items()}
    cases[A2A] = (512, (1, 1, 2, 2))
    return cases


def _world_rank(rank, world, out_dir):
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import decode, model

    cfg = _cfg()
    params = _params(cfg)
    res, meshes = {}, {}
    for name, (s, shape) in _cases().items():
        if shape not in meshes:        # every rank builds each mesh once, in case order
            meshes[shape] = make_production_mesh(shape=shape, device="cpu")
        mesh = meshes[shape]
        if mesh is None:               # a mesh of fewer ranks than the world
            continue
        batch = _batch(cfg, s)
        plan = make_plan(mesh)
        placed = place_tree(plan, params)
        with CollectiveCounter() as c, activation_mesh(plan):
            loss, met, grads = value_and_grad(cfg, placed, batch, remat=True)
        res[name] = dict(loss=loss, metrics=met, grads=full_tree(grads), log=c.signature())
        if name == A2A:
            continue
        serve = make_plan(mesh, mode="serve")
        ctx = {"tokens": batch["tokens"]}
        with CollectiveCounter() as c, activation_mesh(serve):
            res[name]["logits"] = model.forward_logits(cfg, params, ctx)
            res[name]["prefill"] = decode.prefill(cfg, params, ctx, s + 4)
        res[name]["serve_log"] = c.signature()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import decode, model

    out = tmp_path_factory.mktemp("moe_seq")
    ctx = spawn_gloo(_world_rank, WORLD, out, str(out), join=False)
    cfg = _cfg()
    params = _params(cfg)
    refs = {}
    for s in sorted({s for s, _ in _cases().values()}):
        batch = _batch(cfg, s)
        loss, met, grads = value_and_grad(cfg, params, batch, remat=True)
        refs[s] = dict(loss=loss, metrics=met, grads=grads,
                       logits=model.forward_logits(cfg, params, {"tokens": batch["tokens"]}),
                       prefill=decode.prefill(cfg, params, {"tokens": batch["tokens"]}, s + 4))
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


def _mesh_ranks(name):
    return range(int(np.prod(_cases()[name][1])))


@pytest.mark.parametrize("name", GEOMETRIES)
def test_serving_across_shards_matches_unsharded(world, name):
    ranks, refs = world
    want = refs[GEOMETRIES[name][0]]
    want_logits, want_cache = want["prefill"]
    for r in _mesh_ranks(name):
        res = ranks[r][name]
        np.testing.assert_allclose(res["logits"].numpy(), want["logits"].numpy(), rtol=1e-5,
                                   atol=1e-5)
        logits, cache = res["prefill"]
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
        assert cache["pos"] == want_cache["pos"]
        for key, t in want_cache.items():
            if torch.is_tensor(t):
                np.testing.assert_allclose(cache[key].numpy(), t.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=key)


@pytest.mark.parametrize("name", list(_cases()))
def test_training_across_shards_matches_unsharded(world, name):
    from repro_torch import tree as tree_util

    ranks, refs = world
    want = refs[_cases()[name][0]]
    for r in _mesh_ranks(name):
        res = ranks[r][name]
        np.testing.assert_allclose(res["loss"].item(), want["loss"].item(), rtol=1e-5)
        assert set(res["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k].item(), v.item(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        for path, g, w in zip(tree_util.paths(want["grads"]), tree_util.leaves(res["grads"]),
                              tree_util.leaves(want["grads"])):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            assert err <= 1e-5 * scale, (path, err, scale)


@pytest.mark.parametrize("name", list(_cases()))
def test_group_sums_and_collectives_alike_on_every_rank(world, name):
    """Each layer's group sum over ``seq``: one all-reduce of the (G, 1, B,
    E, C/m, D) stack in the forward, one in the recompute and one in the
    backward; on ``1x1x2x2`` two all-to-alls a layer forward, two in the
    recompute and two in the backward over ``model``; every rank of the
    mesh the same collectives in the same order, serving too."""
    from repro_torch.models import moe

    ranks, _refs = world
    cfg = _cfg()
    s, shape = _cases()[name]
    m = shape[3]
    g = moe.group_length(s)
    c = moe.group_capacity(g, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    e_c = cfg.n_experts * c // m if m > 1 else cfg.n_experts * c
    group_sum = ("all-reduce", "seq", "float32", (s // g) * B * e_c * cfg.d_model * 4, shape[2], "")
    log = ranks[0][name]["log"]
    assert log.count(group_sum) == 3 * cfg.n_layers, [r for r in log if r[1] == "seq"]
    a2a = [r for r in log if r[0] == "all-to-all"]
    assert len(a2a) == (6 * cfg.n_layers if m > 1 else 0) and all(r[1] == "model" for r in a2a)
    for r in _mesh_ranks(name):
        assert ranks[r][name]["log"] == log
        if name != A2A:
            assert ranks[r][name]["serve_log"] == ranks[0][name]["serve_log"]


def test_dry_run_routes_a_group_across_seq_shards():
    """The dry run (torch's fake group, this process) of the reduced
    Granite's train step at 512 positions on ``1x1x2x2``, rank 0 of 4: one
    routing group across the two ``seq`` shards, ``--require-alltoall``
    holds; per step two all-to-alls a layer forward, two in the recompute
    and two in the backward over ``model``, each of the group's capacity
    block (B, E, C/2, D) fp32; the group sum three all-reduces a layer
    over ``seq`` of that block; every step the same collectives."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.launch import dryrun
    from repro_torch.models import moe

    cfg = _cfg()
    with CollectiveCounter() as every:      # the warm-up, the gates' step, the timed step
        rec = dryrun.main(["--arch", ARCH, "--reduced", "--shape", "train_4k", "--batch",
                           str(B), "--seq", "512", "--mesh-shape", "1x1x2x2", "--steps", "1",
                           "--require-alltoall"], device="cpu")
    assert not dist.is_initialized()
    c = moe.group_capacity(512, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    block = B * cfg.n_experts * (c // 2) * cfg.d_model * 4
    n = 6 * cfg.n_layers
    assert rec["alltoall_count"] == n and rec["collectives_same_each_step"]
    assert rec["collectives"]["model"]["all-to-all"] == {"count": n, "bytes": n * block}
    assert set(rec["collectives"]) == {"seq", "model"}
    sums = [r for r in every.log if (r.kind, r.axis, r.bytes) == ("all-reduce", "seq", block)]
    assert len(sums) == 3 * 3 * cfg.n_layers
