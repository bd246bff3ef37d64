"""The port's train step against the JAX package's, on the CPU: one
``make_train_step`` with ``adamw``, the claims of ``tests/test_arch_smoke.py``
and ``tests/test_models.py`` on the port's step, fp32 masters,
and ``abstract_params`` for all ten configs.

Shares the seeded inputs and the JAX weights of ``tests/test_torch_train.py``.
Tolerances: losses and the gradient norm within 1e-5 relative; a step's
parameters within 1e-5 of each leaf's largest magnitude, except where
Adam's first step is ill-conditioned (below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd as jsgd
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import sgd as tsgd
from test_torch_train import (GRAD_REL, LOSS_RTOL, _assert_leaf_close, _batch, _jax, _torch,
                              _weights)
from torch_replay import assert_adam_step_close, one_torch_thread  # noqa: F401 (autouse)

STEP_REL = 1e-5


# ------------------------------------------------------------ train step

def _jax_step(arch, opt, **kw):
    jcfg = jconfigs.get_reduced(arch)
    jstep, _ = jsteps.make_train_step(jcfg, make_host_mesh(), opt, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _weights(arch))
    return jax.jit(jstep)(jp, opt.init(jp), _jax(_batch(jcfg)))


def _port_step(arch, opt, **kw):
    tcfg = tconfigs.get_reduced(arch)
    tp = tmodel.params_from_numpy(_weights(arch), "cpu")
    return tsteps.make_train_step(tcfg, opt, **kw)(tp, opt.init(tp), _torch(_batch(tcfg)))


def test_make_train_step_sgd_matches_jax():
    jp, _, jmet = _jax_step("granite_moe_1b_a400m", jsgd(0.05))
    tp, state, tmet = _port_step("granite_moe_1b_a400m", tsgd(0.05))
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=1e-5)
    assert set(tmet) == set(jmet)
    for name in tmet:
        np.testing.assert_allclose(tmet[name].item(), float(jmet[name]), rtol=LOSS_RTOL)
    assert int(state["step"]) == 1
    for g, w in zip(tree_util.leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert g.dtype == torch.float32 and g.grad_fn is None
        _assert_leaf_close(g, w, STEP_REL)


def test_make_train_step_adamw_matches_jax():
    """Adam's first update is -lr * f(g) - lr * wd * p per coordinate, f(g)
    = g / (|g| + eps) of the clipped gradient (the bias corrections cancel):
    where |g| is within a few eps of zero, f turns the frameworks'
    last-digit gradient differences into updates that differ by up to 2 lr.
    So the port's step is held to JAX's clip + adamw applied to the port's
    own gradients (the composition: within 4e-7 relative or 1e-6 of the
    leaf's largest magnitude, the clip's norm summing in another order);
    its gradients to JAX's within 1e-4 of each leaf's largest magnitude
    (delta); and its parameters to JAX's step within 1e-5 of each leaf's
    largest magnitude plus what a gradient difference of delta can make of
    f: lr min(2, delta eps / (max(|g| - delta, 0) + eps)^2). At least 99 %
    of the coordinates must be within the 1e-5 alone
    (``torch_replay.assert_adam_step_close``)."""
    arch, lr, eps = "llama3_8b", 3e-3, 1e-8
    jp, _, jmet = _jax_step(arch, jadamw(lr))
    tp, state, tmet = _port_step(arch, tadamw(lr))
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]), rtol=LOSS_RTOL)
    assert int(state["step"]) == 1
    tcfg, jcfg = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    start = _weights(arch)
    _, _, grads = tsteps.value_and_grad(tcfg, tmodel.params_from_numpy(start, "cpu"),
                                        _torch(_batch(tcfg)))
    _, jgrads = jax.value_and_grad(lambda p: jmodel.forward_train(jcfg, p, _jax(_batch(jcfg)))[0])(
        jax.tree_util.tree_map(jnp.asarray, start))
    own, _ = jclip(jax.tree_util.tree_map(lambda g: jnp.asarray(g.numpy()), grads), 1.0)
    jclipped, _ = jclip(jgrads, 1.0)
    jstart = jax.tree_util.tree_map(jnp.asarray, start)
    opt = jadamw(lr)
    ups, _ = opt.update(own, opt.init(jstart), jstart)
    composed = jax.tree_util.tree_map(lambda p, u: p + u, jstart, ups)

    for g, same, tg, jg in zip(tree_util.leaves(tp), jax.tree_util.tree_leaves(composed),
                               tree_util.leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        assert g.dtype == torch.float32 and g.grad_fn is None
        np.testing.assert_allclose(g.numpy(), np.asarray(same), rtol=4e-7,
                                   atol=1e-6 * float(np.abs(np.asarray(same)).max()))
        _assert_leaf_close(tg, jg, GRAD_REL)
    assert_adam_step_close([g.numpy() for g in tree_util.leaves(tp)],
                           jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jclipped), lr,
                           grad_rel=GRAD_REL, step_rel=STEP_REL, eps=eps, share=0.99)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_smoke_train_step(arch):
    # tests/test_arch_smoke.py::test_smoke_forward_and_train_step on the port
    cfg = tconfigs.get_reduced(arch)
    params = tmodel.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    batch = _batch(cfg)
    batch["labels"] = batch["tokens"]
    batch["mask"] = np.ones_like(batch["mask"])
    batch = _torch(batch)
    step = tsteps.make_train_step(cfg, tsgd(0.05), clip_norm=1e9)
    new, _, metrics = step(params, tsgd(0.05).init(params), batch)
    assert metrics["loss"].shape == () and torch.isfinite(metrics["loss"])
    l1, _ = tmodel.forward_train(cfg, new, batch)
    assert torch.isfinite(l1)
    assert max((a - b).abs().max().item() for a, b in zip(tree_util.leaves(params),
                                                          tree_util.leaves(new))) > 0


def test_train_step_reduces_loss_dense():
    # tests/test_models.py::test_train_step_reduces_loss_dense on the port
    cfg = tconfig.ModelConfig(name="tiny_dense", family="dense", n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, chunk_size=32,
                              dtype="float32")
    params = tmodel.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((2, 64))}
    step = tsteps.make_train_step(cfg, tsgd(0.1), clip_norm=1e9)
    state = tsgd(0.1).init(params)
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] - 0.3, losses


def test_fp32_masters_hold_the_serving_draws():
    cfg = dataclasses.replace(tconfigs.get_reduced("granite_moe_1b_a400m"), dtype="bfloat16")
    served = tmodel.init_params(cfg, 5, device="cpu")
    masters = tmodel.init_params(cfg, 5, device="cpu", param_dtype=torch.float32)
    for s, m in zip(tree_util.leaves(served), tree_util.leaves(masters)):
        assert m.dtype == torch.float32
        assert torch.equal(s, m.to(s.dtype))


# ------------------------------------------------------------ abstract_params

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_params_match_jax_eval_shape(arch):
    want = jmodel.abstract_params(jconfigs.get_config(arch))
    got = tmodel.abstract_params(tconfigs.get_config(arch))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert tree_util.paths(got) == [tuple(k.key for k in p) for p, _ in want_leaves]
    for t, (_, w) in zip(tree_util.leaves(got), want_leaves):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape) and w.dtype == jnp.float32
        assert t.dtype == torch.float32
