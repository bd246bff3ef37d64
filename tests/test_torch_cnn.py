"""The torch CNN against ``repro.models.cnn`` from the same weights:
forward logits within rtol 1e-5 / atol 1e-6 (atol 1e-5 for FEMNIST, whose
62 logits are 3136-term fp32 dot products summed in another order than
XLA's), loss and gradients within rtol 1e-4, and the flat parameter vector
equal to ``ravel_pytree``'s coordinate for coordinate."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.models import cnn as jcnn
from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.models import cnn as tcnn

CONFIGS = [("tiny", jcnn.TINY_CNN, tcnn.TINY_CNN), ("femnist", jcnn.FEMNIST_CNN, tcnn.FEMNIST_CNN)]
LOGIT_ATOL = {"tiny": 1e-6, "femnist": 1e-5}


def _setup(jcfg, tcfg, batch=8, seed=0):
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    # random nonzero biases so the bias path is exercised too
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for layer in jp.values():
        layer["b"] = rng.normal(0.0, 0.05, layer["b"].shape).astype(np.float32)
    x = rng.normal(0.0, 1.0, (batch, jcfg.in_hw, jcfg.in_hw, jcfg.in_ch)).astype(np.float32)
    y = rng.integers(0, jcfg.n_classes, batch).astype(np.int32)
    return jp, tcnn.params_from_numpy(jp, "cpu"), x, y


@pytest.mark.parametrize("name,jcfg,tcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_forward_matches(name, jcfg, tcfg):
    jp, tp, x, _y = _setup(jcfg, tcfg)
    fwd = jax.jit(functools.partial(jcnn.forward, jcfg))
    want = np.asarray(fwd(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x)))
    got = tcnn.forward(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=LOGIT_ATOL[name])


@pytest.mark.parametrize("name,jcfg,tcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_loss_and_grads_match(name, jcfg, tcfg):
    jp, tp, x, y = _setup(jcfg, tcfg)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jl, jg = jax.jit(jax.value_and_grad(functools.partial(jcnn.loss_fn, jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, jp), jbatch)
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y.astype(np.int64))}
    tg, tl = torch.func.grad_and_value(functools.partial(tcnn.loss_fn, tcfg))(tp, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in jp:
        for n in ("w", "b"):
            g_j = np.asarray(jg[k][n])
            # atol: a tiny floor for gradient entries that cancel to ~0
            np.testing.assert_allclose(tg[k][n].numpy(), g_j, rtol=1e-4,
                                       atol=1e-6 * np.abs(g_j).max(), err_msg=f"{k}/{n}")


@pytest.mark.parametrize("name,jcfg,tcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_flat_vector_is_ravel_pytree(name, jcfg, tcfg):
    jp, tp, _x, _y = _setup(jcfg, tcfg)
    want = np.asarray(ravel_pytree(jax.tree_util.tree_map(jnp.asarray, jp))[0])
    flat, meta = ops.flatten_pytree(tp)
    np.testing.assert_array_equal(flat.numpy(), want)
    back = ops.unflatten_pytree(flat, meta)
    for a, b in zip(tree_util.leaves(back), tree_util.leaves(tp)):
        assert torch.equal(a, b)
    assert tree_util.paths(tp)[:2] == [("conv0", "b"), ("conv0", "w")]


@pytest.mark.parametrize("name,jcfg,tcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_eval_metrics_and_param_count(name, jcfg, tcfg):
    jp, tp, x, y = _setup(jcfg, tcfg, batch=16)
    ja, jl = jax.jit(functools.partial(jcnn.eval_metrics, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(y))
    ta, tl = tcnn.eval_metrics(tcfg, tp, torch.from_numpy(x), torch.from_numpy(y))
    assert float(ta) == float(ja)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert tcnn.param_count(tcfg) == jcnn.param_count(jcfg)
    own = tcnn.init_params(tcfg, 0, device="cpu")
    assert [tuple(t.shape) for t in tree_util.leaves(own)] == \
        [tuple(t.shape) for t in tree_util.leaves(tp)]
    w = own["conv0"]["w"]
    assert float(w.abs().max()) <= 0.2 and float(w.std()) > 0.0
