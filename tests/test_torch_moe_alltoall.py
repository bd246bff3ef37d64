"""The MoE's all-to-all route (``repro_torch.models.moe``: JAX's capacity ->
expert reshard) and ``dist.collectives.all_to_all`` on CPU ranks of a gloo
group, and the dry run's ``--require-alltoall`` against the JAX package's.

One spawned world per mesh, ``1x2`` and ``1x4`` (``data`` x ``model``),
both at once, each rank returning everything in one pickle. The reduced
Granite-3.0 1B-A400M (E 4, top-2, d_model 256):

  * the layer (B 2, S 1,024: two routing groups, C 320) under the default
    plan takes the all-to-all route; its dispatched (B, E/m, C, D) tensor
    and its expert outputs are bit-equal to the all-reduce route's (the
    same rank's experts under ``overrides={"moe_capacity": (None,)}``),
    and to ``LocalExchange(m)``'s emulation of the m ranks in one process;
    the outputs and aux values within rtol 1e-5 and 1e-5 of the largest
    magnitude of the unsharded layer's, and that of the JAX package's;
  * a train forward and backward (B 4, S 64, C 40, full remat) takes the
    route in every layer: the counter shows, a routing group of a layer, 2
    all-to-alls forward, 2 in the recompute and 2 in the backward, of B_loc
    E (C/m) D elements each, on ``model``; the all-reduce route shows none;
    the first layer's expert inputs and outputs bit-equal (the later
    layers' inputs carry the
    partials summed in another order: within the bound), the loss and
    every gradient within the row-parallel bound of the unsharded
    ``value_and_grad``;
  * the rule, where JAX takes no all-to-all, with results bit-equal to the
    override's: E not dividing ``model`` (``n_experts=2`` on ``1x4``);
    decode's C = top_k = 2 not dividing 4 (on ``1x2`` it divides: 2
    all-to-alls a layer); the override itself;
  * the collective: forward and backward against a hand-built permutation
    of the blocks on 2 and 4 ranks; under the fake group its buffer starts
    as zeros (the backend may copy the rank's own blocks in);
    a group of one is the identity and records nothing.

The dry run (torch's fake group, this process): ``--require-alltoall``
holds on Granite in every mode that takes gates (train on ``1x1x2x2`` at
1,024 positions, prefill and decode on ``1x2``, ``--fl-round`` on
``2x1x2``), its count the formula's; it fails (``ok: false``, exit 1) on
the reduced Llama-3-8B and on Granite under the override. One JAX
subprocess (4 forced host devices) lowers the two train cases with
``repro.launch.steps.lower_train_step``: its verdict (any ``all-to-all`` in
``hlo_analysis.weighted_collectives``) equals the port's on each.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite_moe_1b_a400m"
MESHES = {"1x2": 2, "1x4": 4}
OVERRIDE = {"moe_capacity": (None,)}
LAYER_B, LAYER_S = 2, 1024          # two 512-token routing groups, C = 320
B, S = 4, 64                        # the train step: one group, C = 40
CTX = 40                            # the decode context (C = 25 in the prefill)
A2A_TRAIN = dict(seq=1024, batch=2, mesh="1x1x2x2")   # the dry run's train case


def _cfg(**over):
    from repro_torch.configs import get_reduced

    return dataclasses.replace(get_reduced(ARCH), **over)


def _layer_inputs():
    """One MoE layer's weights and input (numpy, seeded): d 256, f 512, E 4."""
    cfg = _cfg()
    rng = np.random.default_rng(28)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": 0.02 * rng.standard_normal((d, e)), "wg": 0.02 * rng.standard_normal((e, d, f)),
         "wu": 0.02 * rng.standard_normal((e, d, f)), "wd": 0.02 * rng.standard_normal((e, f, d))}
    x = rng.standard_normal((LAYER_B, LAYER_S, d))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


def _batch(cfg):
    rng = np.random.default_rng(3)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))),
            "mask": torch.as_tensor((rng.random((B, S)) > 0.2).astype(np.float32))}


def _params(cfg):
    from repro_torch.models import model

    return model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)


def _block_input(rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s input of the collective's case: (3, 2n, 5) of distinct values."""
    return torch.arange(3 * 2 * n * 5, dtype=torch.float32).reshape(3, 2 * n, 5) + 1000 * rank


def _block_weight(rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s weight on its output (3, 2, 5n) in the backward's loss."""
    return torch.linspace(-1, 1, 3 * 2 * 5 * n).reshape(3, 2, 5 * n) * (rank + 1)


@contextlib.contextmanager
def _spied():
    """Each ``moe.moe_apply`` call's route (the all-to-all route's exchange
    given or not) and, a call, the input and output of each of its
    ``moe._experts`` calls (a routing group of one rank, in order)."""
    from repro_torch.models import moe

    rec = {"routes": [], "taps": []}
    apply, experts = moe.moe_apply, moe._experts

    def spy_apply(*args, **kw):
        rec["routes"].append(isinstance(kw.get("route"), moe.GroupExchange))
        rec["taps"].append([])
        return apply(*args, **kw)

    def spy_experts(params, xe):
        y = experts(params, xe)
        rec["taps"][-1].append((xe.detach(), y.detach()))
        return y

    moe.moe_apply, moe._experts = spy_apply, spy_experts
    try:
        yield rec
    finally:
        moe.moe_apply, moe._experts = apply, experts


def _collective(plan, n, rank):
    from repro_torch.dist import collectives
    from repro_torch.dist.activations import activation_mesh

    x = _block_input(rank, n).requires_grad_(True)
    with activation_mesh(plan), collectives.CollectiveCounter() as c:
        out = collectives.all_to_all(x, "model", split_dim=1, concat_dim=2)
        (out * _block_weight(rank, n)).sum().backward()
    return out.detach(), x.grad, c.signature()


def _layer(plans, n, rank):
    """The layer on the rank's experts by both routes."""
    from repro_torch.dist import collectives, parallel
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.models import moe

    cfg = _cfg()
    p, x = _layer_inputs()
    local = moe.expert_block({k: torch.from_numpy(v) for k, v in p.items()}, n, rank)
    x = torch.from_numpy(x)
    out = {}
    for name, plan in plans.items():
        with activation_mesh(plan):
            with parallel.holding(parallel.RankView(plan, {}, (), n, rank)):
                route = moe.expert_route(cfg.n_experts, cfg.n_experts // n, LAYER_S, cfg.top_k,
                                         cfg.capacity_factor)
            with collectives.CollectiveCounter() as c, _spied() as rec:
                y, aux = moe.moe_apply(local, x, top_k=cfg.top_k,
                                       capacity_factor=cfg.capacity_factor, route=route)
                y = collectives.reduce_from_model(y)
        out[name] = {"exchange": rec["routes"] == [True], "out": y, "aux": aux,
                     "taps": rec["taps"][0], "log": c.signature()}
    return out


def _train(plan, cfg, params):
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.launch.steps import value_and_grad

    placed = place_tree(plan, params)
    with activation_mesh(plan), CollectiveCounter() as c, _spied() as rec:
        loss, metrics, grads = value_and_grad(cfg, placed, _batch(cfg), remat=True)
    return {"loss": loss, "metrics": metrics, "grads": full_tree(grads), "log": c.signature(),
            **rec}


def _decode(plan, cfg, params):
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import place_tree
    from repro_torch.models import decode

    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, CTX)))
    placed = place_tree(plan, params)
    with activation_mesh(plan):
        logits, cache = decode.prefill(cfg, placed, {"tokens": tokens}, CTX + 1)
        with CollectiveCounter() as c, _spied() as rec:
            step, _ = decode.decode_step(cfg, placed, cache, torch.argmax(logits, -1))
    return {"logits": step, "log": c.signature(), **rec}


def _rank(rank, world, out_dir, mesh_shape):
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(shape=mesh_shape, device="cpu")
    train = {"alltoall": make_plan(mesh), "allreduce": make_plan(mesh, overrides=OVERRIDE)}
    serve = {"alltoall": make_plan(mesh, mode="serve"),
             "allreduce": make_plan(mesh, mode="serve", overrides=OVERRIDE)}
    cfg = _cfg()
    params = _params(cfg)
    res = {"collective": _collective(train["alltoall"], world, rank),
           "layer": _layer(train, world, rank)}
    for route in train:
        res["train", route] = _train(train[route], cfg, params)
        res["decode", route] = _decode(serve[route], cfg, params)
    if world == 4:                     # E 2 does not divide model 4
        e2 = _cfg(n_experts=2)
        res["e2"] = {route: _train(plan, e2, _params(e2)) for route, plan in train.items()}
    with open(os.path.join(out_dir, f"{mesh_shape}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


_JAX_VERDICTS = r"""
import json, sys
from repro.configs import get_reduced
from repro.dist.hlo_analysis import weighted_collectives
from repro.launch import steps
from repro.launch.mesh import make_production_mesh
from repro.models.config import InputShape
from repro.optim import adamw
b, s, mesh_shape = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = make_production_mesh(shape=mesh_shape)
out = {}
for arch in sys.argv[4:]:
    lowered = steps.lower_train_step(get_reduced(arch), mesh, InputShape("t", s, b, "train"),
                                     adamw(1e-3))
    out[arch] = weighted_collectives(lowered.compile().as_text())["counts"].get("all-to-all", 0)
print("JAX-A2A " + json.dumps(out))
"""
VERDICT_ARCHS = (ARCH, "llama3_8b")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from torch_replay import join_all

    out = tmp_path_factory.mktemp("a2a")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_VERDICTS, str(A2A_TRAIN["batch"]),
                             str(A2A_TRAIN["seq"]), A2A_TRAIN["mesh"], *VERDICT_ARCHS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        join_all(*[spawn_gloo(_rank, n, out, str(out), m, join=False) for m, n in MESHES.items()])
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    line = next(ln for ln in stdout.splitlines() if ln.startswith("JAX-A2A "))
    ranks = {}
    for m, n in MESHES.items():
        for r in range(n):
            with open(out / f"{m}_rank{r}.pkl", "rb") as f:
                ranks[m, r] = pickle.load(f)
    return ranks, json.loads(line[len("JAX-A2A "):])


def _close(got, want):
    """The row-parallel bound: rtol 1e-5 and 1e-5 of the largest magnitude."""
    got, want = (torch.as_tensor(np.array(t, dtype=np.float64)) for t in (got, want))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max())), \
        float((got - want).abs().max())


def _same_taps(a, b):
    """Two runs' expert inputs and outputs (calls x ``_experts`` calls),
    bit for bit."""
    assert len(a) == len(b) and a
    for call_a, call_b in zip(a, b):
        assert len(call_a) == len(call_b) and call_a
        for (xa, ya), (xb, yb) in zip(call_a, call_b):
            assert torch.equal(xa, xb) and torch.equal(ya, yb)


def _first_layer_same(a, b):
    """The first layer's expert inputs and outputs bit for bit (both routes
    feed it the same input); the later layers' within the bound (their
    inputs carry the previous layer's partials, summed in another order)."""
    _same_taps(a[:1], b[:1])
    assert len(a) == len(b) and len(a) > 1
    for call_a, call_b in zip(a[1:], b[1:]):
        assert len(call_a) == len(call_b)
        for pair_a, pair_b in zip(call_a, call_b):
            for t_a, t_b in zip(pair_a, pair_b):
                _close(t_a, t_b)


def _a2a(log):
    return [r for r in log if r[0] == "all-to-all"]


# ------------------------------------------------------------ the collective

@pytest.mark.parametrize("mesh", MESHES)
def test_all_to_all_is_the_block_permutation(worlds, mesh):
    ranks, _ = worlds
    n = MESHES[mesh]
    for r in range(n):
        out, grad, log = ranks[mesh, r]["collective"]
        want = torch.cat([torch.chunk(_block_input(i, n), n, dim=1)[r] for i in range(n)], dim=2)
        want_grad = torch.cat([torch.chunk(_block_weight(j, n), n, dim=2)[r] for j in range(n)],
                              dim=1)
        assert torch.equal(out, want) and torch.equal(grad, want_grad)
        nbytes = want.numel() * 4
        assert log == [("all-to-all", "model", "float32", nbytes, n, "")] * 2


def test_all_to_all_under_the_fake_group_reads_no_stale_memory():
    from repro_torch.dist import collectives
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.dryrun import _fake_world
    from repro_torch.launch.mesh import make_production_mesh

    x = torch.arange(48, dtype=torch.float32).reshape(2, 8, 3) + 1
    with _fake_world(4):
        mesh = make_production_mesh(shape="1x4", device="cpu")
        with activation_mesh(make_plan(mesh)), collectives.CollectiveCounter() as c:
            out = collectives.all_to_all(x, "model", split_dim=1, concat_dim=2)
    # the receive buffer starts as zeros; torch's fake backend may copy the
    # rank's own send buffer into it (torch 2.13 does, as for its all-gather):
    # either way no byte of it is left as the allocator handed it over
    own = torch.cat(torch.chunk(x, 4, dim=1), dim=2)
    assert out.shape == (2, 2, 12) and (not out.any() or torch.equal(out, own))
    assert c.signature() == [("all-to-all", "model", "float32", 2 * 2 * 12 * 4, 4, "")]


def test_all_to_all_over_a_group_of_one_is_the_identity():
    from repro_torch.dist import collectives
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.dryrun import _fake_world, wire_bytes
    from repro_torch.launch.mesh import make_production_mesh

    x = torch.randn(2, 4, 3)
    with _fake_world(2):
        mesh = make_production_mesh(shape="2x1", device="cpu")
        with activation_mesh(make_plan(mesh)), collectives.CollectiveCounter() as c:
            out = collectives.all_to_all(x, "model", split_dim=1, concat_dim=2)
    assert out is x and not c.log
    rec = collectives.Record("all-to-all", "model", "float32", 1000, 4)
    assert wire_bytes([rec]) == 750          # (n - 1) / n of the result bytes


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("mesh", MESHES)
def test_layer_dispatch_bit_equal_to_the_allreduce_route(worlds, mesh):
    ranks, _ = worlds
    for r in range(MESHES[mesh]):
        lay = ranks[mesh, r]["layer"]
        assert lay["alltoall"]["exchange"] and not lay["allreduce"]["exchange"]
        assert len(lay["alltoall"]["taps"]) == LAYER_S // 512
        _same_taps([lay["alltoall"]["taps"]], [lay["allreduce"]["taps"]])


@pytest.mark.parametrize("mesh", MESHES)
def test_layer_outputs_and_aux_within_the_bound(worlds, mesh):
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    from repro_torch.models import moe

    ranks, _ = worlds
    n = MESHES[mesh]
    cfg = _cfg()
    p, x = _layer_inputs()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, want_aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=cfg.top_k)
    jout, jaux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                top_k=cfg.top_k)
    _close(want, np.asarray(jout))
    with _spied() as rec:
        local, local_aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=cfg.top_k,
                                         route=moe.LocalExchange(n))
    emu = rec["taps"][0]                   # routing groups x the n ranks
    assert len(emu) == LAYER_S // 512 * n
    _close(local, want)
    for r in range(n):
        lay = ranks[mesh, r]["layer"]
        for route in ("alltoall", "allreduce"):
            _close(lay[route]["out"], want)
            for k, v in want_aux.items():
                _close(lay[route]["aux"][k], v)
                _close(lay[route]["aux"][k], np.asarray(jaux[k]))
        # the one-process emulation holds rank r's tensors bit for bit
        for g, (xe, y) in enumerate(lay["alltoall"]["taps"]):
            assert torch.equal(xe, emu[g * n + r][0]) and torch.equal(y, emu[g * n + r][1])
    assert all(torch.equal(local_aux[k], want_aux[k]) for k in want_aux)


# ------------------------------------------------------------ the train step

@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_takes_the_route_bit_equal(worlds, mesh):
    ranks, _ = worlds
    for r in range(MESHES[mesh]):
        a2a, ar = ranks[mesh, r]["train", "alltoall"], ranks[mesh, r]["train", "allreduce"]
        assert all(a2a["routes"]) and not any(ar["routes"])
        _first_layer_same(a2a["taps"], ar["taps"])


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_all_to_all_count(worlds, mesh):
    """2 forward, 2 in full remat's recompute and 2 backward, a routing
    group of a layer, each of B_loc E (C / m) D fp32 elements; none on the
    all-reduce route; both routes' model all-reduces alike."""
    ranks, _ = worlds
    n, cfg = MESHES[mesh], _cfg()
    c = int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts)
    nbytes = B * cfg.n_experts * (c // n) * cfg.d_model * 4
    for r in range(n):
        a2a, ar = ranks[mesh, r]["train", "alltoall"], ranks[mesh, r]["train", "allreduce"]
        assert _a2a(a2a["log"]) == [("all-to-all", "model", "float32", nbytes, n, "")] * (
            6 * cfg.n_layers)
        assert not _a2a(ar["log"])
        assert [x for x in a2a["log"] if x[0] != "all-to-all"] == ar["log"]


@pytest.mark.parametrize("mesh", MESHES)
def test_train_loss_and_gradients_within_the_bound(worlds, mesh):
    from repro_torch import tree as tree_util
    from repro_torch.launch.steps import value_and_grad

    ranks, _ = worlds
    cfg = _cfg()
    want_loss, want_met, want = value_and_grad(cfg, _params(cfg), _batch(cfg), remat=True)
    for r in range(MESHES[mesh]):
        for route in ("alltoall", "allreduce"):
            got = ranks[mesh, r]["train", route]
            np.testing.assert_allclose(got["loss"].item(), want_loss.item(), rtol=1e-5)
            for k, v in want_met.items():
                _close(got["metrics"][k], v)
            for path, g, w in zip(tree_util.paths(want), tree_util.leaves(got["grads"]),
                                  tree_util.leaves(want)):
                err = float((g - w).abs().max())
                assert err <= 1e-5 * float(w.abs().max()), (route, path, err)


# ------------------------------------------------------------ the rule

def test_rule_experts_not_dividing_model_take_no_all_to_all(worlds):
    """E 2 on model 4: every rank holds every expert, no expert collective,
    and the same numbers as under the override."""
    from repro_torch import tree as tree_util

    ranks, _ = worlds
    for r in range(4):
        a2a, ar = ranks["1x4", r]["e2"]["alltoall"], ranks["1x4", r]["e2"]["allreduce"]
        assert not _a2a(a2a["log"]) and not any(a2a["routes"])
        assert a2a["log"] == ar["log"] and torch.equal(a2a["loss"], ar["loss"])
        assert all(torch.equal(x, y) for x, y in zip(tree_util.leaves(a2a["grads"]),
                                                     tree_util.leaves(ar["grads"])))
        _same_taps(a2a["taps"], ar["taps"])


@pytest.mark.parametrize("mesh", MESHES)
def test_rule_decode_capacity(worlds, mesh):
    """Decode's C = top_k = 2: on model 2 the route takes 2 all-to-alls a
    layer, its first layer's expert inputs and outputs bit-equal to the
    override's; on model 4
    C does not divide, so no all-to-all and the override's numbers bit for
    bit."""
    ranks, _ = worlds
    n, cfg = MESHES[mesh], _cfg()
    for r in range(n):
        a2a, ar = ranks[mesh, r]["decode", "alltoall"], ranks[mesh, r]["decode", "allreduce"]
        assert not any(ar["routes"]) and not _a2a(ar["log"])
        if n == 2:
            _first_layer_same(a2a["taps"], ar["taps"])
            nbytes = B * cfg.n_experts * (cfg.top_k // n) * cfg.d_model * 4
            assert all(a2a["routes"])
            assert _a2a(a2a["log"]) == [("all-to-all", "model", "float32", nbytes, n, "")] * (
                2 * cfg.n_layers)
            _close(a2a["logits"], ar["logits"])
        else:
            assert not any(a2a["routes"]) and a2a["log"] == ar["log"]
            _same_taps(a2a["taps"], ar["taps"])
            assert torch.equal(a2a["logits"], ar["logits"])


# ------------------------------------------------------------ the dry run's gate

# mode -> (arguments, rank 0's rows, positions a rank, passes: 2 forward, 6
# with full remat's recompute and the backward, a routing group of a layer);
# decode routes one token with capacity factor E: C = top_k
GATE_MODES = {
    "train": (["--shape", "train_4k", "--batch", str(A2A_TRAIN["batch"]), "--seq",
               str(A2A_TRAIN["seq"]), "--mesh-shape", A2A_TRAIN["mesh"]], 2, 512, 6),
    "prefill": (["--shape", "prefill_32k", "--batch", "2", "--seq", "128", "--mesh-shape", "1x2"],
                2, 128, 2),
    "decode": (["--shape", "decode_32k", "--batch", "2", "--seq", "64", "--mesh-shape", "1x2"],
               2, 1, 2),
    "fl_round": (["--fl-round", "--shape", "train_512", "--batch", "4", "--seq", "64",
                  "--mesh-shape", "2x1x2"], 2, 64, 6),
}


def _dry(*argv, arch=ARCH):
    from repro_torch.launch import dryrun

    rec = dryrun.main(["--arch", arch, "--reduced", "--steps", "1", *argv], device="cpu")
    assert not dist.is_initialized()
    return rec


def _dry_cli(tmp_path, *argv, arch):
    from repro_torch.launch import dryrun

    out = tmp_path / f"{arch}.jsonl"
    code = dryrun.cli(["--arch", arch, "--reduced", "--steps", "1", "--require-alltoall",
                       "--out", str(out), *GATE_MODES["train"][0], *argv], device="cpu")
    assert not dist.is_initialized()
    return code, json.loads(out.read_text().splitlines()[-1])


@pytest.mark.parametrize("mode", GATE_MODES)
def test_gate_holds_in_every_mode(mode):
    """The gate's count is the step's all-to-alls on ``model``, each of
    rows x E x (C / 2) x D fp32 (model 2), as the formula says; the
    record's totals by kind carry them."""
    argv, rows, s_loc, passes = GATE_MODES[mode]
    cfg = _cfg()
    cf = cfg.n_experts if mode == "decode" else cfg.capacity_factor
    c = int(cf * s_loc * cfg.top_k / cfg.n_experts)
    n = passes * cfg.n_layers
    nbytes = n * rows * cfg.n_experts * (c // 2) * cfg.d_model * 4
    rec = _dry("--require-alltoall", *argv)
    assert rec["batch_local"] == rows and rec["alltoall_count"] == n
    assert rec["collectives"]["model"]["all-to-all"] == {"count": n, "bytes": nbytes}
    assert rec["collective_counts"]["all-to-all"] == n
    assert rec["collective_breakdown"]["all-to-all"] == nbytes
    assert rec["collectives_same_each_step"]


def test_all_to_alls_recorded_without_the_gate():
    rec = _dry(*GATE_MODES["train"][0])
    assert "alltoall_count" not in rec and rec["collective_counts"]["all-to-all"] > 0


@pytest.mark.parametrize("arch", VERDICT_ARCHS)
def test_gate_verdict_equals_jax(worlds, tmp_path, arch):
    """The train case on 1x1x2x2 at 1,024 positions: the port's gate holds
    exactly where JAX's lowered step holds an all-to-all (Granite), and
    fails with JAX's message, ``ok: false`` and exit 1 where it holds none
    (the reduced Llama)."""
    _, jax_counts = worlds
    code, rec = _dry_cli(tmp_path, arch=arch)
    assert (code == 0) == rec["ok"] == (jax_counts[arch] > 0)
    if arch == "llama3_8b":
        assert code == 1 and rec["error"] == (
            "AssertionError: no all-to-all in the step (expected expert-sharded MoE dispatch "
            "on mesh {'pod': 1, 'data': 1, 'seq': 2, 'model': 2})")


def test_gate_fails_on_granite_under_the_override(tmp_path, monkeypatch):
    from repro_torch.dist import plan as plan_mod

    rules = plan_mod.default_rules
    monkeypatch.setattr(plan_mod, "default_rules", lambda **kw: dict(rules(**kw), **OVERRIDE))
    code, rec = _dry_cli(tmp_path, arch=ARCH)
    assert code == 1 and rec["ok"] is False and "no all-to-all in the step" in rec["error"]
