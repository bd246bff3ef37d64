"""The port's MoE layer (``repro_torch.models.moe``) against ``repro.models.moe``.

The JAX package's own expert weights (``moe_params`` carried over as numpy)
and the same numpy activations through both. Tolerances are those of
``tests/test_torch_transformer.py``: fp32 within rtol = atol = 1e-5 (the
expert products sum in another order); bf16 within rtol 2^-6 and an atol
of 2^-6 of the output's largest magnitude. Top-k picks, the dropped
fraction and the routing (exact integer counts in fp32) must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-6, atol=2**-6 * np.abs(want).max())


def _layer(d=64, f=96, e=8, seed=0):
    """JAX expert weights (fp32 masters) and their torch copies."""
    p = jax.tree_util.tree_map(np.asarray,
                               jmoe.moe_params(jax.random.PRNGKey(seed), d, f, e, n_layers=2))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _x(shape, dtype, seed=1, scale=1.0):
    a = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _ties(shape, seed):
    """Router probabilities with planted ties: values from a small set, so
    every row repeats some, and rows with all values equal."""
    rng = np.random.default_rng(seed)
    p = rng.choice(np.array([0.05, 0.1, 0.1, 0.2, 0.3], np.float32), size=shape)
    p[0, 0] = 0.125
    p[-1, -1, ::2] = p[-1, -1, 1::2] = 0.3
    return p


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (32, 8)])
def test_local_top_k_matches_with_ties(e, k):
    probs = _ties((3, 7, e), seed=e + k)
    want_v, want_i = jmoe._local_top_k(jnp.asarray(probs), k)
    got_v, got_i = tmoe._local_top_k(torch.from_numpy(probs), k)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    # ties surface in index order, as lax.top_k orders them
    lax_v, lax_i = jax.lax.top_k(jnp.asarray(probs), k)
    assert np.array_equal(got_i.numpy(), np.asarray(lax_i))
    assert np.array_equal(got_v.numpy(), np.asarray(lax_v))
    tied = probs[0, 0] == probs[0, 0].max()
    assert tied.sum() >= 1 and got_i[0, 0, 0].item() == int(np.argmax(tied))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_logits_are_fp32_products(dtype):
    # bf16 operands widen to fp32 exactly: the logits equal JAX's
    # preferred_element_type=float32 product up to the order of the sum,
    # and the top-k picks are identical
    jp, tp = _layer(e=32)
    jx, tx = _x((2, 40, 64), dtype, scale=2.0)
    want = jnp.einsum("bsd,de->bse", jx, jp["router"].astype(jx.dtype),
                      preferred_element_type=jnp.float32)
    logits, probs = tmoe._router(tp, tx)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    _, want_i = jmoe._local_top_k(jax.nn.softmax(want, axis=-1), 8)
    assert np.array_equal(tmoe._local_top_k(probs, 8)[1].numpy(), np.asarray(want_i))


# ------------------------------------------------------------ dispatch

def _check_apply(got, want, dtype, chunked=False):
    """Output within the dtype's tolerance, lb and z losses within fp32's;
    the dropped fraction identical (exact counts), or for a chunked routing
    (a mean of per-chunk fractions, summed in another order) within an
    ulp of fp32."""
    (out, aux), (want_out, want_aux) = got, want
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == want_out.shape
    _close(out, want_out, dtype)
    assert set(aux) == set(want_aux) == {"lb_loss", "z_loss", "dropped_frac"}
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(aux[name].item(), float(want_aux[name]), **F32)
    if chunked:
        np.testing.assert_allclose(aux["dropped_frac"].item(), float(want_aux["dropped_frac"]),
                                   rtol=2**-23, atol=0)
    else:
        assert aux["dropped_frac"].item() == float(want_aux["dropped_frac"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (32, 8)])
def test_moe_apply_dense_matches(dtype, e, k):
    jp, tp = _layer(e=e, seed=e)
    jx, tx = _x((2, 24, 64), dtype, seed=k)
    _check_apply(tmoe._moe_apply_dense(tp, tx, top_k=k),
                 jmoe._moe_apply_dense(jp, jx, top_k=k), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_routing_matches(dtype):
    # S = 96 in chunks of 16: six routings, each with its own capacity,
    # aux values averaged over the chunks
    jp, tp = _layer(e=8)
    jx, tx = _x((2, 96, 64), dtype, seed=3)
    got = tmoe.moe_apply(tp, tx, top_k=2, capacity_factor=1.0, route_chunk=16)
    want = jmoe.moe_apply(jp, jx, top_k=2, capacity_factor=1.0, route_chunk=16)
    _check_apply(got, want, dtype, chunked=True)
    # and not the unchunked routing: per-chunk capacity drops other slots
    whole = tmoe._moe_apply_dense(tp, tx, top_k=2, capacity_factor=1.0)
    assert whole[1]["dropped_frac"].item() != got[1]["dropped_frac"].item()


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 1.0])
def test_capacity_drops_accounted(capacity_factor):
    # as tests/test_models.py::test_moe_capacity_drops_accounted, against
    # JAX's numbers: positions run past capacity, the overflow is dropped
    # (zero one-hot rows in JAX, clamped and masked here)
    jp, tp = _layer(e=4)
    jx, tx = _x((2, 32, 64), "float32", seed=4)
    got = tmoe.moe_apply(tp, tx, top_k=2, capacity_factor=capacity_factor)
    want = jmoe.moe_apply(jp, jx, top_k=2, capacity_factor=capacity_factor)
    _check_apply(got, want, "float32")
    dropped = got[1]["dropped_frac"].item()
    assert 0.0 < dropped <= 1.0
    # an expert's queue holds at most capacity slots: with the overflow
    # dropped, some tokens lose a routed expert's output altogether
    cap = max(int(capacity_factor * 32 * 2 / 4), 1)
    assert dropped >= 1.0 - 4 * cap / (32 * 2) - 1e-7


def test_fallback_equals_dispatch_at_unbounded_capacity():
    jp, tp = _layer(e=8)
    jx, tx = _x((2, 20, 64), "float32", seed=5)
    out, aux = tmoe._moe_apply_dense(tp, tx, top_k=2, capacity_factor=8.0)
    assert aux["dropped_frac"].item() == 0.0
    oracle = tmoe.moe_apply_dense_fallback(tp, tx, top_k=2)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), **F32)
    np.testing.assert_allclose(oracle.numpy(),
                               np.asarray(jmoe.moe_apply_dense_fallback(jp, jx, top_k=2)), **F32)


def test_fallback_top_k_orders_ties_by_index():
    # the oracle's stable sort against lax.top_k on planted ties: every
    # expert's gate lands where JAX's scatter puts it
    probs = _ties((2, 5, 8), seed=9)
    vals, idx = torch.sort(torch.from_numpy(probs), dim=-1, descending=True, stable=True)
    lax_v, lax_i = jax.lax.top_k(jnp.asarray(probs), 3)
    assert np.array_equal(idx[..., :3].numpy(), np.asarray(lax_i))
    assert np.array_equal(vals[..., :3].numpy(), np.asarray(lax_v))


def test_moe_params_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_params(gen, 64, 96, 8, n_layers=8, dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: jmoe.moe_params(jax.random.PRNGKey(0), 64, 96, 8, 8))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    # truncated normal at 0.02 (std 0.02 * 0.8796), the down projection / 4
    assert abs(p["wg"].float().std().item() - 0.02 * 0.8796) < 1e-3
    assert abs(p["wd"].float().std().item() - 0.005 * 0.8796) < 3e-4
    # truncated at 2 sigma: 0.04, which bf16 may round up by half an ulp
    assert p["router"].float().abs().max().item() <= 0.04 * (1 + 2**-8)
