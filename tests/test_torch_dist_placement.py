"""Parameter and optimizer-state placement as DTensors
(``repro_torch.dist.placement``) on 4 CPU ranks of a gloo group: every
config's reduced parameters and a filled adamw state on ``2x2``, ``4x1``,
``1x4`` and ``1x2x1x2`` meshes. Each rank's local shard must equal
``plan.local_slice`` of the whole leaf and carry ``dist.plan.placements``
of its spec; ``full_tree`` must give the whole tree back bit for bit;
``init_params_local`` must equal slicing ``init_params`` of the same seed;
0-d leaves stay plain tensors.
"""
import os
import pickle

import pytest
import torch

from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

MESHES = ("2x2", "4x1", "1x4", "1x2x1x2")
CHECKS = ("local_slices", "placements", "full_tree", "init_params_local", "opt_state")


def _filled_state(params):
    """An adamw state with every moment leaf filled from a seed."""
    from repro_torch import tree as tree_util
    from repro_torch.optim import adamw

    state = adamw(1e-3).init(params)
    gen = torch.Generator().manual_seed(7)
    for name in ("mu", "nu"):
        state[name] = tree_util.map(lambda t: torch.rand(t.shape, generator=gen), state[name])
    return state


def _placement_rank(rank, world, out_dir, mesh_shape):
    """Every check of this module for one mesh, on one rank: a dict of
    check -> list of failures (empty: passed), pickled by rank."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import ARCH_IDS, get_reduced
    from repro_torch.dist.placement import (full_tree, init_params_local, place_opt_state,
                                            place_tree)
    from repro_torch.dist.plan import make_plan, mesh_coord, placements
    from repro_torch.dist.sharding import param_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model

    mesh = make_production_mesh(shape=mesh_shape, device="cpu")
    plan = make_plan(mesh)
    coord = mesh_coord(mesh)
    fails = {c: [] for c in CHECKS}
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        params = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
        specs = param_specs(plan, params)
        placed = place_tree(plan, params)
        for path, whole, spec, dt in zip(tree_util.paths(params), tree_util.leaves(params),
                                         tree_util.leaves(specs), tree_util.leaves(placed)):
            if not torch.equal(dt.to_local(), whole[plan.local_slice(spec, whole.shape, coord)]):
                fails["local_slices"].append((arch, path))
            if tuple(dt.placements) != placements(spec, mesh) or dt.shape != whole.shape:
                fails["placements"].append((arch, path))
        back = full_tree(placed)
        if not all(torch.equal(a, b) for a, b in zip(tree_util.leaves(back),
                                                     tree_util.leaves(params))):
            fails["full_tree"].append(arch)
        local = init_params_local(cfg, plan, 0, device="cpu", param_dtype=torch.float32)
        for path, a, b in zip(tree_util.paths(local), tree_util.leaves(local),
                              tree_util.leaves(placed)):
            if not (torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements):
                fails["init_params_local"].append((arch, path))
        state = _filled_state(params)
        pstate = place_opt_state(plan, state, specs)
        if not (isinstance(pstate["step"], torch.Tensor) and pstate["step"].ndim == 0
                and type(pstate["step"]).__name__ == "Tensor"):
            fails["opt_state"].append((arch, "step"))
        for name in ("mu", "nu"):
            for path, whole, spec, dt in zip(tree_util.paths(state[name]),
                                             tree_util.leaves(state[name]),
                                             tree_util.leaves(specs),
                                             tree_util.leaves(pstate[name])):
                if not (torch.equal(dt.to_local(),
                                    whole[plan.local_slice(spec, whole.shape, coord)])
                        and tuple(dt.placements) == placements(spec, mesh)):
                    fails["opt_state"].append((arch, name, path))
    with open(os.path.join(out_dir, f"{mesh_shape}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(fails, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """One gloo world of 4 ranks per mesh, two worlds at a time."""
    from torch_replay import join_all

    out = tmp_path_factory.mktemp("placement")
    for pair in (MESHES[:2], MESHES[2:]):
        join_all(*[spawn_gloo(_placement_rank, 4, out, str(out), m, join=False) for m in pair])
    res = {}
    for m in MESHES:
        for r in range(4):
            with open(out / f"{m}_rank{r}.pkl", "rb") as f:
                res[m, r] = pickle.load(f)
    return res


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("check", CHECKS)
def test_placement(results, mesh, check):
    for r in range(4):
        assert results[mesh, r][check] == [], (mesh, r, results[mesh, r][check][:5])


def test_place_tree_without_a_mesh_raises():
    from repro_torch.configs import get_reduced
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.models import model

    params = model.init_params(get_reduced("llama3_8b"), 0, device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        place_tree(make_plan({"data": 2, "model": 2}), params)
