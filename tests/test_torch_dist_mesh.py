"""``repro_torch.launch.mesh`` against ``repro.launch.mesh``'s parsing and
labels, and the ``DeviceMesh`` it builds on 4 CPU ranks of a gloo group:
axis names, a world too small, a mesh of the leading ranks, the CUDA
default without CUDA; and ``plan.placements``/``MeshPlan.local_slice``
against the local shard ``distribute_tensor`` gives.
"""
import pickle

import pytest
import torch

from repro.launch import mesh as jmesh
from repro_torch.dist import plan as tplan
from repro_torch.launch import mesh as tmesh
from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

WORLD = 4


@pytest.mark.parametrize("text", ["16x16", "2x16x16", "1x4x2x16", "2X8x2x16", "1x1x4x1"])
def test_parse_mesh_shape_matches_jax(text):
    assert tmesh.parse_mesh_shape(text) == jmesh.parse_mesh_shape(text)
    assert tmesh.MESH_AXIS_NAMES == jmesh.MESH_AXIS_NAMES


@pytest.mark.parametrize("text", ["16", "1x2x3x4x5"])
def test_parse_mesh_shape_errors_match_jax(text):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_shape(text)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_shape(text)
    assert str(got.value) == str(want.value)


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_production_mesh(shape="1x1")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_production_mesh(shape="1x1", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()


def test_no_process_group_raises():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(shape="1x1", device="cpu")


# spec entries per case, on the 2x2 (data, model) and 1x1x4x1 meshes
PLACEMENT_CASES = {
    "2x2": [(8, 6), (4, 6, 2), (8, 4)],
    "1x1x4x1": [(2, 8, 3), (8, 8), (2, 16, 4, 4)],
}
PLACEMENT_SPECS = {
    "2x2": [("data", None), (None, "model", None), (("data", "model"), None)],
    "1x1x4x1": [(None, "seq", None), ("seq", None), (None, "seq", None, None)],
}


def _ranks(rank, world, out_dir):
    """Every check that needs a process group, on one rank; the results
    pickled to ``out_dir/rank<r>.pkl``."""
    from torch.distributed.tensor import distribute_tensor

    res = {}
    m4 = tmesh.make_production_mesh(shape="1x1x4x1", device="cpu")
    res["label4"] = tmesh.mesh_label(m4)
    res["names4"] = tuple(m4.mesh_dim_names)
    res["coord4"] = tplan.mesh_coord(m4)
    res["coord_matches"] = list(m4.get_coordinate()) == [res["coord4"][n]
                                                          for n in m4.mesh_dim_names]
    m2 = tmesh.make_production_mesh(shape=(2, 2), device="cpu")
    res["names2"] = tuple(m2.mesh_dim_names)
    m3 = tmesh.make_production_mesh(shape="1x2x2", device="cpu")
    res["names3"] = tuple(m3.mesh_dim_names)
    sub = tmesh.make_production_mesh(shape=(2, 1), device="cpu")
    res["sub"] = None if sub is None else (tmesh.mesh_label(sub), tplan.mesh_coord(sub))
    host = tmesh.make_host_mesh(device="cpu")
    res["host"] = None if host is None else (tmesh.mesh_label(host), tuple(host.mesh_dim_names))
    for what, call in (("too_small", lambda: tmesh.make_production_mesh(device="cpu")),
                       ("too_small_4d",
                        lambda: tmesh.make_production_mesh(shape="1x2x4x1", device="cpu"))):
        try:
            call()
            res[what] = None
        except ValueError as e:
            res[what] = str(e)
    gen = torch.Generator().manual_seed(0)
    for name, mesh in (("2x2", m2), ("1x1x4x1", m4)):
        plan = tplan.make_plan(mesh)
        for i, (shape, spec) in enumerate(zip(PLACEMENT_CASES[name], PLACEMENT_SPECS[name])):
            x = torch.randn(shape, generator=gen)
            spec = tplan.P(*spec)
            local = distribute_tensor(x, mesh, tplan.placements(spec, mesh)).to_local()
            mine = x[plan.local_slice(spec, x.shape, tplan.mesh_coord(mesh))]
            res[f"placement {name} {i}"] = torch.equal(local, mine)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    spawn_gloo(_ranks, WORLD, out, str(out))
    results = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def test_production_mesh_axis_names(ranks):
    for r, res in enumerate(ranks):
        assert res["label4"] == "1x1x4x1"
        assert res["names4"] == ("pod", "data", "seq", "model")
        assert res["names2"] == ("data", "model")
        assert res["names3"] == ("pod", "data", "model")
        assert res["coord4"] == {"pod": 0, "data": 0, "seq": r, "model": 0}
        assert res["coord_matches"]


def test_too_small_world_raises_like_jax(ranks):
    for res in ranks:
        assert res["too_small"] == "mesh shape (16, 16) needs 256 devices, have 4"
        assert res["too_small_4d"] == "mesh shape (1, 2, 4, 1) needs 8 devices, have 4"


def test_larger_world_takes_the_leading_ranks(ranks):
    assert [res["sub"] for res in ranks] == [
        ("2x1", {"data": 0, "model": 0}), ("2x1", {"data": 1, "model": 0}), None, None]
    assert ranks[0]["host"] == ("1x1", ("data", "model"))
    assert all(res["host"] is None for res in ranks[1:])


@pytest.mark.parametrize("key", [f"placement {m} {i}" for m in PLACEMENT_CASES
                                 for i in range(len(PLACEMENT_CASES[m]))])
def test_placements_give_distribute_tensors_shard(ranks, key):
    assert all(res[key] for res in ranks)


def test_placements_refuse_axes_out_of_mesh_order():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert [str(p) for p in tplan.placements(tplan.P(("pod", "data"), "model"), Mesh)] == [
        "S(0)", "S(0)", "S(1)"]
    with pytest.raises(ValueError, match="order"):
        tplan.placements(tplan.P(("data", "pod")), Mesh)
