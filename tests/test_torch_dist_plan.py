"""The port's logical-axis plan and partition specs against the JAX
package's, entry for entry (``repro_torch.dist.{plan,sharding}`` vs
``repro.dist.{plan,sharding}``), on synthetic axis-size meshes: rules,
resolution, specs of every config's parameters, optimizer state and caches,
client stacks; the validity properties of ``tests/test_mesh_plan.py``; and
``MeshPlan.local_slice`` against JAX's ``NamedSharding.devices_indices_map``
on 8 forced host devices (a subprocess: the device count is fixed at JAX's
first use, and ``tests/conftest.py`` forbids the flag in-process).
"""
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.dist import plan as jplan
from repro.dist import sharding as jshd
from repro.models import abstract_params as j_abstract_params
from repro.models import cache_spec as j_cache_spec
from repro.optim import adamw as j_adamw
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.dist import plan as tplan
from repro_torch.dist import sharding as tshd
from repro_torch.models import decode as tdecode
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as t_adamw
from torch_replay import one_torch_thread  # noqa: F401  (autouse)

from hypothesis import given, settings, strategies as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x4x2x16": {"pod": 1, "data": 4, "seq": 2, "model": 16},
    "2x8x2x16": {"pod": 2, "data": 8, "seq": 2, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "1x1x4x1": {"pod": 1, "data": 1, "seq": 4, "model": 1},
}
MODES = ("train", "serve")
DP_OVERRIDES = (None, ("data",), ())


def _entry(e):
    """A spec entry in a form both packages' entries map to."""
    if e is jplan.UNCONSTRAINED or e is tplan.UNCONSTRAINED:
        return "<unconstrained>"
    return e


def _jspec(p) -> tuple:
    return tuple(_entry(e) for e in tuple(p))


def _tspec(p) -> tuple:
    assert isinstance(p, tplan.PartitionSpec), type(p)
    return tuple(_entry(e) for e in p)


def _jleaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, JP)):
        out[tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = _jspec(leaf)
    return out


def _tleaves(tree) -> dict:
    return {tuple(str(k) for k in p): _tspec(s)
            for p, s in zip(tree_util.paths(tree), tree_util.leaves(tree))}


def _assert_same_specs(jtree, ttree, ctx):
    j, t = _jleaves(jtree), _tleaves(ttree)
    assert set(j) == set(t), f"{ctx}: leaves differ {set(j) ^ set(t)}"
    for path in j:
        assert j[path] == t[path], f"{ctx} {path}: JAX {j[path]} vs port {t[path]}"


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fsdp", [("pod", "data"), ("data",), ()])
@pytest.mark.parametrize("client_axis", [None, "pod", "data"])
def test_default_rules_equal(mode, fsdp, client_axis):
    j = jplan.default_rules(mode=mode, fsdp=fsdp, client_axis=client_axis)
    t = tplan.default_rules(mode=mode, fsdp=fsdp, client_axis=client_axis)
    assert tuple(tplan.LOGICAL_AXES) == tuple(jplan.LOGICAL_AXES)
    assert set(j) == set(t)
    for name in j:
        assert tuple(map(_entry, j[name])) == tuple(map(_entry, t[name])), name
    assert tplan.progressive(("pod", "data")) == jplan.progressive(("pod", "data"))


def test_default_rules_mode_error():
    with pytest.raises(ValueError, match="mode must be"):
        tplan.default_rules(mode="infer")


DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 4096, 49152, 256206)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_resolve_spec_stack_equal(mesh, mode):
    sizes = MESHES[mesh]
    jp = jplan.make_plan(sizes, mode=mode, dp_override=("data",), client_axis="pod")
    tp = tplan.make_plan(sizes, mode=mode, dp_override=("data",), client_axis="pod")
    assert dict(tp.axis_sizes) == dict(jp.axis_sizes)
    for name in tplan.LOGICAL_AXES:
        for d in DIMS:
            for used in (frozenset(), frozenset({"model"}), frozenset({"data", "pod"})):
                assert _entry(tp.resolve(d, name, used)) == _entry(jp.resolve(d, name, used)), \
                    (name, d, used)
    assert tp.resolve(8, None) is None and tp.axis_size(("pod", "data", "nope")) == \
        jp.axis_size(("pod", "data", "nope"))
    cases = [
        ((32, 4096, 4096), ("stacked_layers", "embed", "mlp"), "right", True),
        ((4096, 32, 128), ("embed", "heads", "head_dim"), "right", False),
        ((32, 1024, 512), ("expert", "embed", None), "right", False),
        ((8, 4096, 2048), ("act_batch", "seq", "mlp"), "left", False),
        ((8, 32, 160, 64), ("act_batch", None, "moe_capacity", None), "left", False),
        ((1024, 32, 8, 8, 1), ("clients",), "left", False),
        ((8, 8), ("expert", "heads"), "right", False),
        ((16, 48), (None, "embed"), "right", False),
        ((7,), ("embed", "mlp"), "right", False),
        ((), (), "right", False),
    ]
    for shape, dims, align, protect in cases:
        js = jp.spec(shape, dims, align=align, protect_leading=protect)
        ts = tp.spec(shape, dims, align=align, protect_leading=protect)
        assert _tspec(ts) == _jspec(js), (shape, dims, align)
        for d in (2, 3, 16):
            assert _tspec(tp.stack(ts, "clients", d)) == _jspec(jp.stack(js, "clients", d))
    with pytest.raises(KeyError):
        tp.spec((4, 4), ("embed", "definitely_not_an_axis"))
    with pytest.raises(ValueError, match="align"):
        tp.spec((4,), ("embed",), align="middle")


def test_partition_spec_normalizes_like_jax():
    assert tplan.P(("data",), None) == tplan.P("data", None)
    assert _jspec(JP(("data",), None)) == _tspec(tplan.P(("data",), None))
    assert tplan.P(("pod", "data")) == (("pod", "data"),)


# ---------------------------------------------------- every config's trees

@functools.lru_cache(maxsize=None)
def _trees(arch: str, reduced: bool):
    jcfg = jconfigs.get_reduced(arch) if reduced else jconfigs.get_config(arch)
    tcfg = tconfigs.get_reduced(arch) if reduced else tconfigs.get_config(arch)
    jparams = j_abstract_params(jcfg)
    tparams = tmodel.abstract_params(tcfg)
    jopt = jax.eval_shape(j_adamw(1e-3).init, jparams)
    topt = t_adamw(1e-3).init(tparams)
    jcache = j_cache_spec(jcfg, 32, 128)
    tcache = tdecode.cache_spec(tcfg, 32, 128)
    return jparams, tparams, jopt, topt, jcache, tcache


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_opt_cache_specs_equal(arch, reduced):
    jparams, tparams, jopt, topt, jcache, tcache = _trees(arch, reduced)
    for mesh in ("16x16", "2x16x16", "1x4x2x16", "2x8x2x16"):
        sizes = MESHES[mesh]
        for mode in MODES:
            for dpo in DP_OVERRIDES:
                ctx = f"{arch}/{mesh}/{mode}/dp={dpo}"
                jps = jshd.param_specs(jplan.make_plan(sizes, mode=mode, dp_override=dpo),
                                       jparams)
                tps = tshd.param_specs(tplan.make_plan(sizes, mode=mode, dp_override=dpo),
                                       tparams)
                _assert_same_specs(jps, tps, ctx)
                _assert_same_specs(jshd.make_opt_specs(sizes, jopt, jps),
                                   tshd.make_opt_specs(sizes, topt, tps), "opt " + ctx)
            _assert_same_specs(
                jshd.make_param_specs(sizes, jparams, mode=mode, dp_override=("data",)),
                tshd.make_param_specs(sizes, tparams, mode=mode, dp_override=("data",)),
                f"make_param_specs {arch}/{mesh}/{mode}")
        _assert_same_specs(jshd.cache_specs_plan(jplan.make_plan(sizes), jcache),
                           tshd.cache_specs_plan(tplan.make_plan(sizes), tcache),
                           f"cache {arch}/{mesh}")
        _assert_same_specs(jshd.cache_specs(sizes, jcache, dp_override=("data",)),
                           tshd.cache_specs(sizes, tcache, dp_override=("data",)),
                           f"cache_specs {arch}/{mesh}")


@pytest.mark.parametrize("u", [1024, 8, 6])
@pytest.mark.parametrize("mesh,axis", [("2x2", "data"), ("2x16x16", "pod"), ("2x16x16", "data"),
                                       ("1x4x2x16", "data"), ("1x1x4x1", "seq")])
def test_data_specs_clients_equal(u, mesh, axis):
    sizes = MESHES[mesh]
    shapes = {"x": (u, 1373, 28, 28, 1), "y": (u, 1373), "n": (u,), "scalar": ()}
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    tbatch = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    for leading in ("clients", "batch"):
        _assert_same_specs(
            jshd.data_specs(jplan.make_plan(sizes, client_axis=axis), jbatch, leading=leading),
            tshd.data_specs(tplan.make_plan(sizes, client_axis=axis), tbatch, leading=leading),
            f"{mesh}/{axis}/{leading}")
    _assert_same_specs(jshd.batch_specs(sizes, jbatch), tshd.batch_specs(sizes, tbatch),
                       f"batch_specs {mesh}")


# ------------------------------------------------ properties (and parity)

_PROP_LOGICALS = (
    None, "embed", "heads", "kv_heads", "head_dim", "mlp", "expert",
    "vocab", "batch", "clients", "seq", "act_batch", "moe_capacity",
)


def _spec_axes(entry):
    if entry is None or entry is tplan.UNCONSTRAINED:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@settings(max_examples=60, deadline=None)
@given(
    pod=st.integers(1, 4), data=st.integers(1, 16), seq=st.integers(1, 4),
    model=st.integers(1, 16),
    d0=st.integers(1, 96), d1=st.integers(1, 96), d2=st.integers(1, 96),
    l0=st.integers(0, len(_PROP_LOGICALS) - 1),
    l1=st.integers(0, len(_PROP_LOGICALS) - 1),
    l2=st.integers(0, len(_PROP_LOGICALS) - 1),
    mode_i=st.integers(0, 1),
)
def test_random_specs_always_divisibility_valid(
    pod, data, seq, model, d0, d1, d2, l0, l1, l2, mode_i,
):
    """Every resolved spec is divisibility-valid, uses no axis twice and no
    absent axis; and equals the JAX package's."""
    sizes = {"pod": pod, "data": data, "seq": seq, "model": model}
    mode = ("train", "serve")[mode_i]
    plan = tplan.make_plan(sizes, mode=mode, client_axis="pod")
    jp = jplan.make_plan(sizes, mode=mode, client_axis="pod")
    shape = (d0, d1, d2)
    dims = (_PROP_LOGICALS[l0], _PROP_LOGICALS[l1], _PROP_LOGICALS[l2])
    for align in ("right", "left"):
        spec = plan.spec(shape, dims, align=align)
        assert _tspec(spec) == _jspec(jp.spec(shape, dims, align=align))
        assert len(spec) == len(shape)
        used = []
        for dim, entry in zip(shape, spec):
            axes = _spec_axes(entry)
            for a in axes:
                assert a in sizes, f"absent axis {a} in {spec}"
                assert a not in used, f"axis {a} reused in {spec}"
                used.append(a)
            group = math.prod(sizes[a] for a in axes)
            assert dim % group == 0, f"{group} does not divide {dim} in {spec} for {dims}"


@settings(max_examples=30, deadline=None)
@given(
    seq=st.integers(1, 8), model=st.integers(1, 8),
    s_dim=st.integers(1, 64), h_dim=st.integers(1, 64),
)
def test_seq_rule_resolution(seq, model, s_dim, h_dim):
    """The seq logical name binds to the seq mesh axis exactly when the
    axis exists and divides; heads bind to model independently."""
    plan = tplan.make_plan({"data": 2, "seq": seq, "model": model})
    spec = plan.spec((8, s_dim, h_dim, 16),
                     ("act_batch", "seq", "heads", "head_dim"), align="left")
    assert spec[1] == ("seq" if s_dim % seq == 0 else None)
    assert spec[2] == ("model" if h_dim % model == 0 else None)
    assert spec[0] is tplan.UNCONSTRAINED
    assert spec[3] is None


# ------------------------------------------------------------ local slices

# mesh shape, axis names, tensor shape, spec entries (None / name / list)
SLICE_CASES = [
    ((2, 4), ("data", "model"), (8, 12), ["data", "model"]),
    ((2, 4), ("data", "model"), (8, 16), [None, ["data", "model"]]),
    ((2, 2, 2), ("pod", "data", "model"), (16, 4, 6), [["pod", "data"], None, "model"]),
    ((2, 2, 2), ("pod", "data", "model"), (16, 4), ["data", None]),
    ((1, 2, 2, 2), ("pod", "data", "seq", "model"), (4, 64, 8, 16),
     [["pod", "data"], "seq", "model", None]),
    ((1, 2, 2, 2), ("pod", "data", "seq", "model"), (8, 32), ["seq", ["data", "model"]]),
    ((8,), ("data",), (1024, 3), ["data", None]),
]

_SLICE_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
assert len(jax.devices()) == 8, jax.devices()
out = []
for mesh_shape, names, shape, entries in cases:
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))]).reshape(mesh_shape)
    mesh = Mesh(devs, tuple(names))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in entries])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    rows = []
    for d, sl in idx.items():
        coord = [int(c) for c in np.argwhere(devs == d)[0]]
        rows.append([coord, [[s.start or 0, s.stop if s.stop is not None else n]
                             for s, n in zip(sl, shape)]])
    out.append(rows)
print("SLICES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_slices():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _SLICE_SCRIPT, json.dumps(SLICE_CASES)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SLICES ")][0]
    return json.loads(line[len("SLICES "):])


@pytest.mark.parametrize("i", range(len(SLICE_CASES)))
def test_local_slice_equals_devices_indices_map(jax_slices, i):
    mesh_shape, names, shape, entries = SLICE_CASES[i]
    plan = tplan.make_plan(dict(zip(names, mesh_shape)))
    spec = tplan.P(*[tuple(e) if isinstance(e, list) else e for e in entries])
    assert len(jax_slices[i]) == math.prod(mesh_shape)
    for coord, want in jax_slices[i]:
        got = plan.local_slice(spec, shape, dict(zip(names, coord)))
        assert [[s.start, s.stop] for s in got] == want, (coord, spec)


def test_local_slice_refuses_a_ragged_dim():
    plan = tplan.make_plan({"data": 4})
    with pytest.raises(ValueError, match="does not divide"):
        plan.local_slice(tplan.P("data"), (6,), {"data": 1})


def test_shard_tree_and_gather_tree_round_trip():
    """Each coordinate's pieces are the slices ``local_slice`` names, and
    ``gather_tree`` of every coordinate's pieces rebuilds the tree."""
    sizes = {"pod": 1, "data": 2, "seq": 2, "model": 2}
    plan = tplan.make_plan(sizes, mode="train")
    params = tmodel.init_params(tconfigs.get_reduced("llama3_8b"), 0, device="cpu")
    specs = tshd.param_specs(plan, params)
    names = tuple(plan.axis_sizes)
    pieces = {}
    for c in [(0, d, s, m) for d in range(2) for s in range(2) for m in range(2)]:
        coord = dict(zip(names, c))
        pieces[c] = tshd.shard_tree(plan, params, specs, coord)
        for leaf, piece, spec in zip(tree_util.leaves(params), tree_util.leaves(pieces[c]),
                                     tree_util.leaves(specs)):
            assert torch.equal(piece, leaf[plan.local_slice(spec, leaf.shape, coord)])
    assert any(p.shape != l.shape for p, l in zip(tree_util.leaves(pieces[(0, 1, 0, 1)]),
                                                  tree_util.leaves(params)))
    back = tshd.gather_tree(plan, pieces, specs)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(back),
                                                 tree_util.leaves(params)))
