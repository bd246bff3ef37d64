"""The wire entry point (``repro_torch.kernels.ops``) against
``repro.kernels.ops``: with the reference's own uint32 entropy injected,
``quantize_pytree_kernel``'s round trip is bit-equal; the server-side
aggregate agrees within rtol 1e-6 / atol 1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch import tree as tree_util
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stochastic_quant as tsq
from repro_torch.models import cnn as tcnn


@pytest.mark.parametrize("cfg_name,q_bits", [("tiny", 1), ("tiny", 4), ("tiny", 8),
                                             ("femnist", 4)])
def test_quantize_pytree_kernel_matches_reference(cfg_name, q_bits):
    jcfg = {"tiny": jcnn.TINY_CNN, "femnist": jcnn.FEMNIST_CNN}[cfg_name]
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(11 + q_bits)
    want_tree, want_scale = jops.quantize_pytree_kernel(key, jp, q_bits, interpret=True)

    tp = tcnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    flat, _meta = tops.flatten_pytree(tp)
    tiled, n = tops.pad_to_tiles(flat)
    assert n == flat.shape[0] and tiled.shape[1] == 128 and tiled.shape[0] % 256 == 0
    rbits = np.array(jax.random.bits(key, tuple(tiled.shape), jnp.uint32))
    tsq.reset_launches()
    got_tree, got_scale = tops.quantize_pytree_kernel(tp, q_bits, rbits=torch.from_numpy(rbits))
    assert float(got_scale) == float(want_scale)
    for (k, n_), got in zip(tree_util.paths(got_tree), tree_util.leaves(got_tree)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_tree[k][n_]),
                                      err_msg=f"{k}/{n_}")
    assert tsq.launches == {"aggregate": 0, "quantize": 0, "dequantize": 0}


def test_quantize_flat_needs_entropy_and_uses_generator():
    flat = torch.linspace(-1.0, 1.0, 1000)
    with pytest.raises(ValueError, match="rbits or a torch.Generator"):
        tops.quantize_flat(flat, 4)
    a = tops.quantize_flat(flat, 4, generator=torch.Generator().manual_seed(0))
    b = tops.quantize_flat(flat, 4, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    deq = tops.dequantize_flat(a[0], a[1], a[2], 4, 1000)
    assert deq.shape == (1000,)
    assert float((deq - flat).abs().max()) <= float(a[2]) / 15 * (1 + 1e-6)


@pytest.mark.parametrize("k,m,q_bits", [(3, 256, 4), (9, 40, 8)])
def test_aggregate_uploads_matches_reference(k, m, q_bits):
    rng = np.random.default_rng(k)
    idx = rng.integers(0, 2**q_bits, (k, m, 128)).astype(np.uint8)
    signs = rng.integers(0, 2, (k, m, 128)).astype(np.uint8)
    scales = rng.uniform(0.1, 1.0, k).astype(np.float32)
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    want = np.asarray(jops.aggregate_uploads(jnp.asarray(idx), jnp.asarray(signs),
                                             jnp.asarray(scales), jnp.asarray(w), q_bits,
                                             interpret=True))
    got = tops.aggregate_uploads(torch.from_numpy(idx), torch.from_numpy(signs),
                                 torch.from_numpy(scales), torch.from_numpy(w), q_bits)
    assert got.shape == (m * 128,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
