"""Chunked attention's gradients on the port against ``jax.grad`` of the
JAX package's (causal, windowed, non-causal, with and without
``causal_skip``), and ``forward_train`` with ``causal_skip`` at a length
that takes the chunked path, on the CPU. Losses within 1e-5 relative,
gradients within 1e-4 of each leaf's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import tree as tree_util
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from test_torch_train import GRAD_REL, LOSS_RTOL, _assert_leaf_close, _jax, _torch
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)


# ------------------------------------------------------------ chunked attention

@pytest.mark.parametrize("causal,window,causal_skip", [
    (True, 0, False), (True, 0, True), (True, 96, False), (True, 96, True), (False, 0, False),
], ids=["causal", "causal-skip", "window", "window-skip", "non-causal"])
def test_chunked_attention_grads_match_jax(causal, window, causal_skip):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 256, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((1, 256, 2, 16), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((1, 256, 4, 16), dtype=np.float32)
    kw = dict(chunk=64, causal=causal, window=window, causal_skip=causal_skip)

    def jloss(q, k, v):
        return jnp.sum(jlayers.chunked_attention(q, k, v, **kw) * w)

    want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = torch.sum(tlayers.chunked_attention(tq, tk, tv, **kw) * torch.from_numpy(w))
    grads = torch.autograd.grad(got, (tq, tk, tv))
    np.testing.assert_allclose(got.item(), float(want[0]), rtol=LOSS_RTOL)
    for name, g, jg in zip("qkv", grads, want[1]):
        _assert_leaf_close(g, jg, GRAD_REL, f"d/d{name}")


# ------------------------------------------------------------ causal_skip

def test_causal_skip_matches_jax_at_chunked_length():
    # S = 2560 > DENSE_ATTN_MAX_SEQ and a multiple of the chunk: the
    # chunked path, visiting only each query chunk's causal KV prefix
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=64, chunk_size=512, dtype="float32")
    jcfg, tcfg = jconfig.ModelConfig(**base), tconfig.ModelConfig(**base)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (1, 2560)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks, "mask": np.ones((1, 2560), np.float32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.forward_train(jcfg, p, _jax(batch), causal_skip=True), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    loss, _, grads = tsteps.value_and_grad(tcfg, tmodel.params_from_numpy(params, "cpu"),
                                           _torch(batch), causal_skip=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for g, jg in zip(tree_util.leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        _assert_leaf_close(g, jg, GRAD_REL)
