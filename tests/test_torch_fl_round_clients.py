"""``repro_torch.launch.steps.make_fl_round`` against the JAX package, on
the CPU, on JAX's own draws: the screen (a clean round is an exact no-op,
a NaN client is blocked), K = 2 and 3 clients with heterogeneous levels and
weights against JAX's pieces composed on the same draws (one local SGD step
per client, ``quantize_pytree`` on ``split(key, K)[k]``, the eq.-2 einsum,
as ``tests/test_fl_round_step.py`` composes them), the generator's draw
order, and the packed sign bitmap bit for bit.

Parameters follow the one-level rule of ``tests/test_torch_fl_round.py``;
``theta_max`` and ``n_screened`` are identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quantization import quantize_pytree as jquantize_pytree
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from test_torch_fl_round import ARCH, LR, _jax_round, _one_level, _port, _setup
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)


# ------------------------------------------------------------ the screen at K = 1

@pytest.mark.parametrize("wire_packed", [False, True], ids=["fp32-wire", "packed-wire"])
def test_screen_on_a_clean_round_is_an_exact_noop(wire_packed):
    stacked, batch = _setup(1)
    key = jax.random.PRNGKey(2)
    args = (stacked, batch, [8], [1.0], key)
    plain = _port(*args, wire_packed=wire_packed)
    screened = _port(*args, wire_packed=wire_packed, screen=True)
    want = _jax_round(*args, wire_packed=wire_packed, screen=True)
    assert screened[3].item() == float(want[3]) == 0.0
    assert torch.equal(screened[2], plain[2])
    assert torch.equal(screened[2], torch.tensor(np.asarray(want[2])))
    assert torch.equal(screened[1], plain[1])
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(screened[0]),
                                                 tree_util.leaves(plain[0])))
    _one_level(screened[0], want[0], screened[2], [8], [1.0])


@pytest.mark.parametrize("wire_packed", [False, True], ids=["fp32-wire", "packed-wire"])
def test_screen_blocks_a_nan_client(wire_packed):
    stacked, batch = _setup(1)
    batch = dict(batch, mask=batch["mask"] * np.float32(np.nan))
    args = (stacked, batch, [8], [1.0], jax.random.PRNGKey(1))
    want = _jax_round(*args, wire_packed=wire_packed, screen=True)
    got = _port(*args, wire_packed=wire_packed, screen=True)
    assert got[3].item() == float(want[3]) == 1.0
    assert not torch.isfinite(got[2]).any() and not np.isfinite(np.asarray(want[2])).any()
    # every client screened: a no-op, the start params carried forward
    for g, c in zip(tree_util.leaves(got[0]), jax.tree_util.tree_leaves(stacked)):
        assert torch.equal(g, torch.from_numpy(c))
    # unscreened, the NaN step destroys the model in both packages
    plain = _port(*args, wire_packed=wire_packed)
    assert any(not torch.equal(g, torch.from_numpy(c)) or not torch.isfinite(g).all()
               for g, c in zip(tree_util.leaves(plain[0]), jax.tree_util.tree_leaves(stacked)))



# ------------------------------------------------------------ K > 1: JAX's pieces

@functools.lru_cache(maxsize=None)
def _jax_local_step():
    """JAX's round's local step, one client: (new params, loss)."""
    cfg = jconfigs.get_reduced(ARCH)

    def step(p, b):
        loss, g = jax.value_and_grad(lambda pp: jmodel.forward_train(cfg, pp, b)[0])(p)
        return jax.tree_util.tree_map(lambda x, gg: (x - LR * gg).astype(x.dtype), p, g), loss

    return jax.jit(step)


def _jax_composed(stacked, batch, q, w, key):
    """JAX's round by its pieces: one local SGD step per client, then
    ``quantize_pytree`` on split(key, K)[k], then the eq.-2 einsum."""
    n = len(q)
    news, losses = [], []
    for k in range(n):
        p = jax.tree_util.tree_map(lambda x: jnp.asarray(x[k]), stacked)
        b = {name: jnp.asarray(v[k]) for name, v in batch.items()}
        new, loss = _jax_local_step()(p, b)
        news.append(new)
        losses.append(float(loss))
    keys = jax.random.split(key, n)
    quantized, tmax = [], []
    for k in range(n):
        tq, t = jquantize_pytree(keys[k], news[k], int(q[k]))
        quantized.append(tq)
        tmax.append(float(t))
    agg = jax.tree_util.tree_map(
        lambda *leaves: jnp.einsum("k...,k->...", jnp.stack(leaves), jnp.asarray(w, jnp.float32)),
        *quantized)
    return agg, np.float32(np.mean(losses)), np.array(tmax, np.float32)


@pytest.mark.parametrize("n_clients,q,w", [
    (2, [6, 8], [0.3, 0.7]),
    (3, [3, 8, 5], [0.5, 0.2, 0.3]),
], ids=["K2", "K3"])
@pytest.mark.parametrize("wire_packed", [False, True], ids=["fp32-wire", "packed-wire"])
def test_several_clients_match_jaxs_pieces(n_clients, q, w, wire_packed):
    stacked, batch = _setup(n_clients)
    key = jax.random.PRNGKey(5)
    agg, loss, tmax = _jax_composed(stacked, batch, q, w, key)
    got = _port(stacked, batch, q, w, key, wire_packed=wire_packed)
    assert torch.equal(got[2], torch.from_numpy(tmax))
    np.testing.assert_allclose(got[1].item(), float(loss), rtol=1e-5)
    want = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.asarray(a)[None],
                                                            (n_clients,) + a.shape), agg)
    _one_level(got[0], want, got[2], q, w)
    # every client leaves with the one broadcast aggregate
    for leaf in tree_util.leaves(got[0]):
        assert all(torch.equal(leaf[k], leaf[0]) for k in range(n_clients))


def test_several_clients_screen_one_nan_client():
    """One of three clients goes NaN: it is screened, the survivors'
    weights are renormalized to the round's total, and the aggregate is
    JAX's pieces composed over the survivors with those weights."""
    stacked, batch = _setup(3)
    mask = batch["mask"].copy()
    mask[1] = np.nan
    batch = dict(batch, mask=mask)
    q, w, key = [4, 8, 6], [0.5, 0.2, 0.3], jax.random.PRNGKey(3)
    for wire_packed in (False, True):
        got = _port(stacked, batch, q, w, key, wire_packed=wire_packed, screen=True)
        assert got[3].item() == 1.0
        assert bool(torch.isfinite(got[2][[0, 2]]).all()) and not torch.isfinite(got[2][1])
        w_use = np.float32(np.array([0.5, 0.0, 0.3], np.float32) * np.float32(1.0 / 0.8))
        agg, _, tmax = _jax_composed(stacked, batch, q, list(w_use), key)
        np.testing.assert_array_equal(got[2][[0, 2]].numpy(), tmax[[0, 2]])
        want = jax.tree_util.tree_map(lambda a: np.broadcast_to(np.asarray(a)[None],
                                                                (3,) + a.shape), agg)
        _one_level(got[0], want, got[2].nan_to_num(0.0), q, w_use)


# ------------------------------------------------------------ draws and the wire

def test_generator_draws_uplink_then_downlink():
    stacked, batch = _setup(2)
    cfg = tconfigs.get_reduced(ARCH)
    fl_round = tsteps.make_fl_round(cfg, lr=LR, downlink="delta", wire_packed=True)
    params = tmodel.params_from_numpy(stacked, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    q, w = torch.tensor([5, 7]), torch.tensor([0.4, 0.6])
    drawn = fl_round(params, tb, q, w, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    shapes = [tuple(leaf.shape[1:]) for leaf in tree_util.leaves(params)]
    up = [[torch.rand(s, generator=g) for s in shapes] for _ in range(2)]
    down = [torch.rand(s, generator=g) for s in shapes]
    given = fl_round(params, tb, q, w, uniforms=up, downlink_uniforms=down)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(drawn[0]),
                                                 tree_util.leaves(given[0])))
    with pytest.raises(ValueError, match="generator"):
        fl_round(params, tb, q, w)


@pytest.mark.parametrize("shape", [(5,), (3, 128), (2, 3, 200), (7, 1), (1, 7288)])
def test_pack_signs_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    bits = rng.integers(0, 2, shape).astype(np.uint8)
    packed = tsteps.pack_signs(torch.from_numpy(bits))
    d = shape[-1]
    pad = (-d) % 128
    assert packed.dtype == torch.uint8 and packed.shape == shape[:-1] + ((d + pad) // 8,)
    want = np.packbits(np.pad(bits, [(0, 0)] * (len(shape) - 1) + [(0, pad)]), axis=-1,
                       bitorder="little")
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(tsteps.unpack_signs(packed, d).numpy(), bits)
