"""``repro_torch.launch.steps.make_fl_round`` against the JAX package's
round, on the CPU, on JAX's own draws (``torch_replay.jax_fl_round_uniforms``
and ``jax_fl_downlink_uniforms``).

On one device JAX's round runs at K = 1 only (the host mesh is 1 x 1): the
port's round is held against JAX's whole round there, both wires and the
three downlink modes (this file). The screen, K = 2 and 3 against JAX's
pieces composed on the same draws, the generator's draw order and the
sign bitmap are in ``tests/test_torch_fl_round_clients.py``.
Parameters follow the one-level rule of ``tests/test_torch_fl_runtime.py``
(every coordinate within the largest w_k theta_k / (2^q_k - 1), plus one
downlink level theta_d / 255 when the broadcast is quantized, plus 1e-5;
99 % of them within 1e-5): torch's local step differs from XLA's in the
last bits, and a coordinate whose uniform sits at its rounding boundary
moves a whole level. ``theta_max`` and ``n_screened`` are identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from torch_replay import jax_fl_downlink_uniforms, jax_fl_round_uniforms
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

ARCH, LR, B, S = "yi_6b", 1e-2, 2, 32
PARAM_ATOL, WITHIN_SHARE = 1e-5, 0.99


@functools.lru_cache(maxsize=None)
def _setup(n_clients):
    """JAX weights, one copy per client (perturbed per client so the copies
    differ), and a batch per client."""
    cfg = jconfigs.get_reduced(ARCH)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    stacked = jax.tree_util.tree_map(
        lambda p: np.stack([p + (0.01 * k) * rng.standard_normal(p.shape).astype(np.float32)
                            for k in range(n_clients)]), params)
    toks = rng.integers(0, cfg.vocab, (n_clients, B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks, "mask": np.ones((n_clients, B, S), np.float32)}
    return stacked, batch


def _shapes(stacked):
    return [leaf.shape[1:] for leaf in jax.tree_util.tree_leaves(stacked)]


def _port(stacked, batch, q, w, key, **mode):
    fl_round = tsteps.make_fl_round(tconfigs.get_reduced(ARCH), lr=LR, **mode)
    shapes = _shapes(stacked)
    return fl_round(tmodel.params_from_numpy(stacked, "cpu"),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    torch.tensor(q), torch.tensor(w, dtype=torch.float32),
                    uniforms=jax_fl_round_uniforms(key, shapes, len(q)),
                    downlink_uniforms=jax_fl_downlink_uniforms(key, shapes))


def _jax_round(stacked, batch, q, w, key, **mode):
    fl_round = jsteps.make_fl_round(jconfigs.get_reduced(ARCH), make_host_mesh(), lr=LR,
                                    client_axis="data", **mode)
    return jax.jit(fl_round)(jax.tree_util.tree_map(jnp.asarray, stacked),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(q, jnp.int32), jnp.asarray(w, jnp.float32), key)


def _one_level(got, want, theta_max, q, w, downlink_level=0.0):
    level = max(float(w[k]) * float(theta_max[k]) / (2.0 ** min(int(q[k]), 16) - 1.0)
                for k in range(len(q))) + downlink_level
    diffs = np.concatenate([np.abs(g.numpy() - np.asarray(x)).reshape(-1) for g, x in
                            zip(tree_util.leaves(got), jax.tree_util.tree_leaves(want))])
    assert np.isfinite(diffs).all()
    assert diffs.max() <= level + PARAM_ATOL, (diffs.max(), level)
    assert np.mean(diffs <= PARAM_ATOL) >= WITHIN_SHARE, np.mean(diffs <= PARAM_ATOL)


def _downlink_level(stacked, downlink, agg_leaves):
    if downlink == "off":
        return 0.0
    if downlink == "quant":
        theta_d = max(float(np.abs(np.asarray(a)).max()) for a in agg_leaves)
    else:
        theta_d = max(float(np.abs(np.asarray(a)[None] - c).max())
                      for a, c in zip(agg_leaves, jax.tree_util.tree_leaves(stacked)))
    return theta_d / 255.0


# ------------------------------------------------------------ K = 1: JAX's round

@pytest.mark.parametrize("wire_packed", [False, True], ids=["fp32-wire", "packed-wire"])
@pytest.mark.parametrize("downlink", ["off", "quant", "delta"])
def test_one_client_round_matches_jax(wire_packed, downlink):
    stacked, batch = _setup(1)
    key = jax.random.PRNGKey(1)
    q, w = [6], [1.0]
    want = _jax_round(stacked, batch, q, w, key, wire_packed=wire_packed, downlink=downlink)
    got = _port(stacked, batch, q, w, key, wire_packed=wire_packed, downlink=downlink)
    assert torch.equal(got[2], torch.tensor(np.asarray(want[2])))
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-5)
    # the downlink's level: its range over the port's fp32 broadcast
    agg = [leaf[0].numpy() for leaf in tree_util.leaves(
        _port(stacked, batch, q, w, key, wire_packed=wire_packed)[0])]
    _one_level(got[0], want[0], got[2], q, w, _downlink_level(stacked, downlink, agg))
    for g, c in zip(tree_util.leaves(got[0]), jax.tree_util.tree_leaves(stacked)):
        assert tuple(g.shape) == c.shape and g.dtype == torch.float32


def test_bad_downlink_mode_raises():
    with pytest.raises(ValueError, match="downlink"):
        tsteps.make_fl_round(tconfigs.get_reduced(ARCH), downlink="fp8")
    with pytest.raises(ValueError, match="downlink"):
        jsteps.make_fl_round(jconfigs.get_reduced(ARCH), make_host_mesh(), downlink="fp8")
