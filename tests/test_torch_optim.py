"""The port's optimizers (``repro_torch.optim``) against the JAX package's
(``repro.optim``) on the same seeded numpy parameters and gradients, and
the claims of ``tests/test_substrate.py`` on the port.

Each optimizer's state and parameters after three steps are held to 1 fp32
ulp (rtol 2e-7): the same operations in the same order on the same fp32
values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch import tree as tree_util
from repro_torch.optim import optimizers as topt
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

ULP = dict(rtol=2e-7, atol=0)
SHAPES = {"layers": {"w": (3, 7, 5), "scale": (5,)}, "embed": {"table": (11, 5)},
          "head": (5, 4)}


def _draw(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tree_util.map(torch.from_numpy, tree)


def _assert_trees(got, want, **tol):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = tree_util.leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int32"): torch.int32}[np.asarray(w).dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adam": lambda m: m.adam(1e-2),
    "adamw": lambda m: m.adamw(3e-3),
    "adamw-no-decay": lambda m: m.adamw(0.1, weight_decay=0.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(name):
    rng = np.random.default_rng(0)
    params = _draw(SHAPES, rng, 1.0)
    grads = [_draw(SHAPES, rng, 3.0) for _ in range(3)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    _assert_trees(ts, js, rtol=0, atol=0)
    for g in grads:
        ju, js = jo.update(_j(g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        _assert_trees(tu, ju, **ULP)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _assert_trees(ts, js, **ULP)
        _assert_trees(tp, jp, **ULP)
    assert int(ts["step"]) == 3


def test_moments_fp32_and_updates_cast_back_for_bf16_params():
    rng = np.random.default_rng(1)
    params = tree_util.map(lambda t: t.to(torch.bfloat16), _t(_draw(SHAPES, rng, 1.0)))
    grads = tree_util.map(lambda t: t.to(torch.bfloat16), _t(_draw(SHAPES, rng, 1.0)))
    for name in ("sgd-momentum", "adamw"):
        opt = OPTIMIZERS[name](topt)
        state = opt.init(params)
        ups, state = opt.update(grads, state, params)
        assert all(m.dtype == torch.float32 for m in tree_util.leaves(state["mu"]))
        assert all(u.dtype == torch.float32 for u in tree_util.leaves(ups))
        new = topt.apply_updates(params, ups)
        assert all(p.dtype == torch.bfloat16 for p in tree_util.leaves(new))
        want = tree_util.map(lambda p, u: (p.float() + u).to(torch.bfloat16), params, ups)
        assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(new),
                                                     tree_util.leaves(want)))


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    grads = _draw(SHAPES, rng, 3.0)
    np.testing.assert_allclose(topt.global_norm(_t(grads)).item(),
                               float(jopt.global_norm(_j(grads))), rtol=2e-7)
    for max_norm in (1.0, 1e3):
        (tc, tn), (jc, jn) = (topt.clip_by_global_norm(_t(grads), max_norm),
                              jopt.clip_by_global_norm(_j(grads), max_norm))
        np.testing.assert_allclose(tn.item(), float(jn), rtol=2e-7)
        _assert_trees(tc, jc, rtol=4e-7, atol=0)
    # above the limit nothing changes
    same, _ = topt.clip_by_global_norm(_t(grads), 1e3)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(same),
                                                 tree_util.leaves(_t(grads))))


@pytest.mark.parametrize("name", ["sgd", "sgd-momentum", "adam", "adamw-no-decay"])
def test_optimizers_converge_quadratic(name):
    # tests/test_substrate.py::test_optimizers_converge_quadratic on the port
    opt = {"sgd": topt.sgd(0.1), "sgd-momentum": topt.sgd(0.05, momentum=0.9),
           "adam": topt.adam(0.1), "adamw-no-decay": topt.adamw(0.1, weight_decay=0.0)}[name]
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(200):
        ups, state = opt.update({"w": 2.0 * (params["w"] - target)}, state, params)
        params = topt.apply_updates(params, ups)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_clip_by_global_norm():
    # tests/test_substrate.py::test_clip_by_global_norm on the port
    clipped, norm = topt.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert norm.item() == pytest.approx(20.0)
    assert torch.sqrt(torch.sum(clipped["a"] ** 2)).item() == pytest.approx(1.0, rel=1e-5)


def test_optimizer_steps_record_no_graph():
    params = {"w": torch.ones(3, requires_grad=True)}
    opt = topt.adamw(0.1)
    state = opt.init(params)
    ups, state = opt.update({"w": torch.ones(3)}, state, params)
    new = topt.apply_updates(params, ups)
    assert new["w"].grad_fn is None and not new["w"].requires_grad
