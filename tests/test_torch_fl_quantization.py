"""The object runtime's quantizers and energy model in the port
(``repro_torch.core.quantization``, ``repro_torch.wireless.energy``)
against ``repro.core.quantization`` and ``repro.wireless.energy``.

  * ``quantize_indices``, ``dequantize_indices``, ``quantize_pytree`` and
    ``quantize_upload`` are bit-equal to the JAX functions when handed the
    uniforms JAX draws from the same key (``torch_replay.jax_upload_uniforms``
    for a tree), at q in {1, 4, 8, 12, 16} (u8 and u16 planes) and, for the
    trees, q = 32 (NoQuant's level), on a mixed-sign tree and the all-zero
    tree; ``pytree_size`` equals JAX's;
  * q > 16 raises in ``quantize_indices``;
  * eq. 14-17 are the same Python arithmetic in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jquant
from repro.wireless import energy as jenergy
from repro_torch import tree as tree_util
from repro_torch.core import quantization as tquant
from repro_torch.wireless import energy as tenergy
from torch_replay import jax_upload_uniforms, one_torch_thread  # noqa: F401 (autouse fixture)

WIRE_Q = (1, 4, 8, 12, 16)
TREE_Q = WIRE_Q + (32,)


def _tree(kind: str) -> dict:
    """A nested dict in the CNN's shape family: mixed signs with exact
    zeros, repeated extremes (+max and -max) and tiny values; or all
    zeros."""
    rng = np.random.default_rng(7)
    shapes = {"conv0": {"b": (8,), "w": (3, 3, 1, 8)}, "fc0": {"b": (32,), "w": (128, 32)},
              "out": {"b": (10,), "w": (32, 10)}}
    tree = {}
    for k, leaves in shapes.items():
        tree[k] = {}
        for n, shape in leaves.items():
            x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
            if kind == "zero":
                x = np.zeros(shape, np.float32)
            else:
                flat = x.reshape(-1)
                flat[:: 7] = 0.0
                flat[1:: 11] *= 1e-6
            tree[k][n] = x
    if kind == "mixed":
        tree["fc0"]["w"][0, 0] = 0.3
        tree["fc0"]["w"][0, 1] = -0.3
    return tree


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _t(tree):
    return tree_util.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("kind", ["mixed", "zero"])
@pytest.mark.parametrize("q", WIRE_Q)
def test_quantize_indices_bit_equal(q, kind):
    x = _tree(kind)["fc0"]["w"]
    key = jax.random.PRNGKey(q)
    j_idx, j_sgn, j_max = jquant.quantize_indices(key, jnp.asarray(x), q)
    u01 = torch.from_numpy(np.array(jax.random.uniform(key, x.shape, jnp.float32)))
    t_idx, t_sgn, t_max = tquant.quantize_indices(u01, torch.from_numpy(x), q)
    assert t_idx.dtype == (torch.uint8 if q <= 8 else torch.uint16)
    assert np.asarray(j_idx).dtype == t_idx.numpy().dtype
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_sgn.numpy(), np.asarray(j_sgn))
    assert _bits(t_max.numpy()) == _bits(np.asarray(j_max))
    if kind == "mixed":
        assert int(t_idx.to(torch.int32).max()) == 2**q - 1     # the extremes hit the top level
        assert int(t_sgn.sum()) > 0


@pytest.mark.parametrize("q", WIRE_Q)
def test_dequantize_indices_bit_equal(q):
    x = _tree("mixed")["conv0"]["w"]
    key = jax.random.PRNGKey(100 + q)
    j_idx, j_sgn, j_max = jquant.quantize_indices(key, jnp.asarray(x), q)
    want = jquant.dequantize_indices(j_idx, j_sgn, j_max, q)
    got = tquant.dequantize_indices(torch.from_numpy(np.array(j_idx)),
                                    torch.from_numpy(np.array(j_sgn)),
                                    torch.from_numpy(np.array(j_max)), q)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("q_bits", [17, 32])
def test_quantize_indices_rejects_q_above_16(q_bits):
    x = torch.ones((4,))
    with pytest.raises(ValueError, match="uint16"):
        tquant.quantize_indices(torch.zeros((4,)), x, q_bits)


@pytest.mark.parametrize("kind", ["mixed", "zero"])
@pytest.mark.parametrize("q", TREE_Q)
def test_quantize_pytree_bit_equal(q, kind):
    tree = _tree(kind)
    key = jax.random.PRNGKey(200 + q)
    j_tree, j_max = jquant.quantize_pytree(key, jax.tree_util.tree_map(jnp.asarray, tree), q)
    shapes = [leaf.shape for leaf in tree_util.leaves(tree)]
    t_tree, t_max = tquant.quantize_pytree(jax_upload_uniforms(key, shapes), _t(tree), q)
    assert tree_util.paths(t_tree) == tree_util.paths(tree)
    for a, b in zip(jax.tree_util.tree_leaves(j_tree), tree_util.leaves(t_tree)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
    assert _bits(t_max.numpy()) == _bits(np.asarray(j_max))
    if kind == "zero":
        assert float(t_max) == 0.0
    else:
        assert float(t_max) == pytest.approx(0.3)


def test_quantize_pytree_wants_one_uniform_per_leaf():
    tree = _t(_tree("mixed"))
    with pytest.raises(ValueError, match="uniform tensors"):
        tquant.quantize_pytree([torch.zeros((8,))], tree, 4)


@pytest.mark.parametrize("q", [1, 8, 32])
def test_quantize_upload_and_pytree_size(q):
    tree = _tree("mixed")
    key = jax.random.PRNGKey(300 + q)
    j_up = jquant.quantize_upload(key, jax.tree_util.tree_map(jnp.asarray, tree), q)
    shapes = [leaf.shape for leaf in tree_util.leaves(tree)]
    t_up = tquant.quantize_upload(jax_upload_uniforms(key, shapes), _t(tree), q)
    assert tquant.pytree_size(_t(tree)) == jquant.pytree_size(tree) == t_up.z == j_up.z
    assert t_up.q_bits == j_up.q_bits == q
    assert t_up.bits == j_up.bits == tquant.payload_bits(t_up.z, q)
    assert _bits(t_up.theta_max.numpy()) == _bits(np.asarray(j_up.theta_max))
    for a, b in zip(jax.tree_util.tree_leaves(j_up.tree), tree_util.leaves(t_up.tree)):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


ENERGY_CASES = [
    ("comm_latency", (8.1e6, 3.3e6)),
    ("comm_energy", (0.1, 8.1e6, 3.3e6)),
    ("comp_latency", (6, 20.0, 1187.0, 1.7e9)),
    ("comp_energy", (6, 2e-28, 20.0, 1187.0, 1.7e9)),
]


@pytest.mark.parametrize("name,args", ENERGY_CASES, ids=[c[0] for c in ENERGY_CASES])
def test_energy_model_equal(name, args):
    got = getattr(tenergy, name)(*args)
    assert isinstance(got, float)
    assert got == getattr(jenergy, name)(*args)
