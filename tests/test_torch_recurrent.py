"""The port's recurrent blocks (``models/rwkv6.py``, ``models/mamba2.py``)
against ``src/repro/``.

The same numpy inputs, drawn from a seed, through the JAX function and its
port. Tolerances:

* fp32 outputs and states within rtol = atol = 1e-5: the two packages sum
  the same products in other orders;
* the chunked scans (``wkv_chunked``, ``ssd_chunked``) on unit-normal
  inputs within rtol 1e-5 and an atol of 1e-5 x the largest magnitude of
  the JAX result (``SCALED``): each output sums up to a chunk (32-64) of
  products as large as that magnitude (|y| reaches 40-150 here), through
  exp(+-cumsum) factors, in another order than JAX's cumsum and einsums,
  so an element's error follows the largest term, not the element (seen:
  <= 4e-6 x the largest magnitude at chunk 64);
* the chunked forms against the sequential oracle, inside the port, within
  the JAX package's own bounds for that comparison (``tests/test_models.py``:
  atol 2e-4 / 2e-5 for the WKV, 3e-4 / 3e-5 for the SSD).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv6 as trwkv
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = dict(rtol=1e-5, atol=1e-5)
SCALED = 1e-5       # atol of the chunked scans, relative to the largest |JAX result|


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(*arrays):
    """(JAX arrays, torch tensors) of the same numpy arrays."""
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or F32))


def _close_scaled(got, want):
    want = np.asarray(want)
    _close(got, want, rtol=1e-5, atol=SCALED * np.abs(want).max())


def _params(jtree):
    """A JAX parameter dict as numpy and as the port's fp32 tensors."""
    npt = jax.tree_util.tree_map(np.asarray, jtree)
    return jax.tree_util.tree_map(jnp.asarray, npt), tmodel.params_from_numpy(npt, "cpu")


def _wkv_inputs(seed, b=2, t=128, h=4, n=16, decay=(0.5, 1.0)):
    rng = _rng(seed)
    r, k, v = (_normal(rng, (b, t, h, n)) for _ in range(3))
    w = rng.uniform(*decay, (b, t, h, n)).astype(np.float32)
    u = _normal(rng, (h, n), 0.1)
    s0 = _normal(rng, (b, h, n, n), 0.1)
    return r, k, v, w, u, s0


# ------------------------------------------------------------ RWKV6

def test_wkv_sequential_matches():
    j, t = _both(*_wkv_inputs(0, t=40))
    y_j, s_j = jrwkv.wkv_sequential(*j)
    y_t, s_t = trwkv.wkv_sequential(*t)
    _close(y_t, y_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("chunk", [32, 64])
def test_wkv_chunked_matches(chunk):
    j, t = _both(*_wkv_inputs(chunk))
    y_j, s_j = jrwkv.wkv_chunked(*j, chunk=chunk)
    y_t, s_t = trwkv.wkv_chunked(*t, chunk=chunk)
    _close_scaled(y_t, y_j)
    _close_scaled(s_t, s_j)


def test_wkv_step_matches():
    r, k, v, w, u, s0 = _wkv_inputs(3, t=1)
    j, t = _both(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    y_j, s_j = jrwkv.wkv_step(*j)
    y_t, s_t = trwkv.wkv_step(*t)
    _close(y_t, y_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("chunk", [32, 64])
def test_wkv_chunked_vs_sequential(chunk):
    # the port's two paths, as tests/test_models.py holds JAX's
    _, t = _both(*_wkv_inputs(10 + chunk))
    y1, s1 = trwkv.wkv_sequential(*t)
    y2, s2 = trwkv.wkv_chunked(*t, chunk=chunk)
    _close(y2, y1, atol=2e-4)
    _close(s2, s1, atol=2e-5)


def test_wkv_chunked_clamps_strong_decays():
    # log w down to -6 < -80/32 = -2.5: the chunked form clamps the per-step
    # log-decay (its exp(-cum) stays finite), so it equals the recurrence on
    # the clamped decays, and the JAX package's chunked form
    chunk = 32
    r, k, v, _, u, s0 = _wkv_inputs(4, t=64)
    w = np.exp(_rng(40).uniform(-6.0, -1.0, r.shape)).astype(np.float32)
    assert (np.log(w) < -80.0 / chunk).mean() > 0.5
    j, t = _both(r, k, v, w, u, s0)
    y_j, s_j = jrwkv.wkv_chunked(*j, chunk=chunk)
    y_t, s_t = trwkv.wkv_chunked(*t, chunk=chunk)
    assert torch.isfinite(y_t).all() and torch.isfinite(s_t).all()
    _close_scaled(y_t, y_j)
    _close_scaled(s_t, s_j)
    w_clamped = torch.clamp_min(t[3], float(np.exp(np.float32(-80.0 / chunk))))
    y_c, s_c = trwkv.wkv_sequential(t[0], t[1], t[2], w_clamped, t[4], t[5])
    _close(y_t, y_c, atol=2e-4)
    _close(s_t, s_c, atol=2e-5)
    y_s, _ = trwkv.wkv_sequential(*t)
    assert (y_t - y_s).abs().max() > 1e-2      # the clamp changed the result


def test_groupnorm_heads_matches():
    rng = _rng(5)
    y = _normal(rng, (2, 7, 4, 16), 3.0) + 1.0
    p = {"scale": _normal(rng, (64,)) + 1.0, "bias": _normal(rng, (64,))}
    want = jrwkv.groupnorm_heads(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(y))
    got = trwkv.groupnorm_heads(tree_util.map(torch.from_numpy, p), torch.from_numpy(y))
    _close(got, want)


def _tm_case(seed, t):
    d, h = 64, 4
    jp, tp = _params(jrwkv.time_mix_params(jax.random.PRNGKey(seed), d, h, n_layers=2))
    rng = _rng(seed)
    x, x_prev = _normal(rng, (2, t, d)), _normal(rng, (2, d))
    s0 = _normal(rng, (2, h, d // h, d // h), 0.1)
    return jp, tp, _both(x, x_prev, s0), h


@pytest.mark.parametrize("t,chunked", [(128, True), (40, False), (1, False)],
                         ids=["chunked", "sequential", "step"])
def test_time_mix_apply_matches(t, chunked):
    jp, tp, (j, tt), h = _tm_case(6, t)
    want = jrwkv.time_mix_apply(jp, *j, h, chunked=chunked)
    got = trwkv.time_mix_apply(tp, *tt, h, chunked=chunked)
    for g, w in zip(got, want):
        _close(g, w)


def test_time_mix_step_matches():
    jp, tp, (j, tt), h = _tm_case(7, 1)
    want = jrwkv.time_mix_step(jp, j[0][:, 0], j[1], j[2], h)
    got = trwkv.time_mix_step(tp, tt[0][:, 0], tt[1], tt[2], h)
    for g, w in zip(got, want):
        _close(g, w)


def test_time_mix_chunked_vs_sequential_in_the_port():
    _, tp, (_, tt), h = _tm_case(8, 128)
    y1, c1, s1 = trwkv.time_mix_apply(tp, *tt, h, chunked=False)
    y2, c2, s2 = trwkv.time_mix_apply(tp, *tt, h, chunked=True)
    _close(y2, y1, atol=2e-4)
    _close(s2, s1, atol=2e-5)
    assert torch.equal(c1, c2)


def test_channel_mix_apply_matches():
    jp, tp = _params(jrwkv.channel_mix_params(jax.random.PRNGKey(9), 64, 128, n_layers=2))
    rng = _rng(9)
    j, t = _both(_normal(rng, (2, 24, 64)), _normal(rng, (2, 64)))
    for g, w in zip(trwkv.channel_mix_apply(tp, *t), jrwkv.channel_mix_apply(jp, *j)):
        _close(g, w)


# ------------------------------------------------------------ Mamba2

@pytest.mark.parametrize("with_carry", [False, True], ids=["no-carry", "carry"])
def test_causal_conv_matches(with_carry):
    rng = _rng(11)
    x, ker = _normal(rng, (2, 20, 48)), _normal(rng, (tmamba.CONV_K, 48), 0.5)
    carry = _normal(rng, (2, tmamba.CONV_K - 1, 48)) if with_carry else None
    j, t = _both(x, ker, *([carry] if with_carry else []))
    want = jmamba.causal_conv(*j)
    got = tmamba.causal_conv(*t)
    for g, w in zip(got, want):
        _close(g, w)


def test_causal_conv_bf16_sums_in_the_jax_order():
    # bf16: the K products and partial sums round in bf16 in the JAX code's
    # order, so the carry and the pre-SiLU sum are bit-equal to JAX's; the
    # SiLU then differs by at most two bf16 ulps (<= 2^-6 relative): XLA's
    # CPU backend expands the bf16 logistic as 1 / (1 + exp(-x)) rounding
    # each op to bf16, torch's F.silu rounds once
    rng = _rng(12)
    x, ker = _normal(rng, (2, 50, 96)), _normal(rng, (tmamba.CONV_K, 96), 0.5)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    want, want_carry = jmamba.causal_conv(xj, jnp.asarray(ker))
    with mock.patch.object(jax.nn, "silu", lambda y: y):
        want_sum, _ = jmamba.causal_conv(xj, jnp.asarray(ker))
    with mock.patch.object(tmamba.F, "silu", lambda y: y):
        got_sum, _ = tmamba.causal_conv(xt, torch.from_numpy(ker))
    got, got_carry = tmamba.causal_conv(xt, torch.from_numpy(ker))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    assert got.dtype == got_sum.dtype == torch.bfloat16
    assert np.array_equal(got_sum.float().numpy(), f32(want_sum))
    assert np.array_equal(got_carry.float().numpy(), f32(want_carry))
    np.testing.assert_allclose(got.float().numpy(), f32(want), rtol=2**-6, atol=1e-6)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-30, 30, 2001), [-1e-7, 0.0, 1e-7, 80.0, -80.0]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tmamba.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def _ssd_inputs(seed, b=2, t=128, h=4, p=8, n=16):
    rng = _rng(seed)
    x = _normal(rng, (b, t, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, t, h)))).astype(np.float32)
    a_log = np.log(np.linspace(0.5, 4.0, h)).astype(np.float32)
    b_in, c_in = _normal(rng, (b, t, n)), _normal(rng, (b, t, n))
    s0 = _normal(rng, (b, h, n, p), 0.1)
    return x, dt, a_log, b_in, c_in, s0


def test_ssd_sequential_matches():
    j, t = _both(*_ssd_inputs(12, t=40))
    for g, w in zip(tmamba.ssd_sequential(*t), jmamba.ssd_sequential(*j)):
        _close(g, w)


@pytest.mark.parametrize("chunk", [32, 64])
def test_ssd_chunked_matches(chunk):
    j, t = _both(*_ssd_inputs(13 + chunk))
    for g, w in zip(tmamba.ssd_chunked(*t, chunk=chunk), jmamba.ssd_chunked(*j, chunk=chunk)):
        _close_scaled(g, w)


def test_ssd_chunked_vs_sequential():
    _, t = _both(*_ssd_inputs(14))
    y1, s1 = tmamba.ssd_sequential(*t)
    y2, s2 = tmamba.ssd_chunked(*t, chunk=32)
    _close(y2, y1, atol=3e-4)
    _close(s2, s1, atol=3e-5)


def _mamba_case(seed, t, with_state):
    d, d_inner, d_state, hd = 64, 128, 16, 32
    jp, tp = _params(jmamba.mamba2_params(jax.random.PRNGKey(seed), d, d_inner, d_state, hd,
                                          n_layers=2))
    rng = _rng(seed)
    arrays = [_normal(rng, (2, t, d))]
    if with_state:
        arrays += [_normal(rng, (2, d_inner // hd, d_state, hd), 0.1),
                   _normal(rng, (2, tmamba.CONV_K - 1, d_inner + 2 * d_state))]
    j, tt = _both(*arrays)
    kw = dict(d_inner=d_inner, d_state=d_state, head_dim=hd)
    js = {"ssm": j[1], "conv": j[2]} if with_state else None
    ts = {"ssm": tt[1], "conv": tt[2]} if with_state else None
    return jp, tp, j[0], tt[0], js, ts, kw


@pytest.mark.parametrize("t,with_state", [(128, False), (128, True), (40, True)],
                         ids=["chunked", "chunked-state", "sequential-state"])
def test_mamba2_apply_matches(t, with_state):
    jp, tp, jx, tx, js, ts, kw = _mamba_case(15, t, with_state)
    out_j, st_j = jmamba.mamba2_apply(jp, jx, state=js, chunk=64, **kw)
    out_t, st_t = tmamba.mamba2_apply(tp, tx, state=ts, chunk=64, **kw)
    _close(out_t, out_j)
    _close(st_t["ssm"], st_j["ssm"])
    _close(st_t["conv"], st_j["conv"])


def test_mamba2_step_matches():
    jp, tp, jx, tx, js, ts, kw = _mamba_case(16, 1, True)
    out_j, st_j = jmamba.mamba2_step(jp, jx[:, 0], js, **kw)
    out_t, st_t = tmamba.mamba2_step(tp, tx[:, 0], ts, **kw)
    _close(out_t, out_j)
    _close(st_t["ssm"], st_j["ssm"])
    _close(st_t["conv"], st_j["conv"])


def test_mamba2_chunked_vs_sequential_in_the_port():
    _, tp, _, tx, _, ts, kw = _mamba_case(17, 128, True)
    out1, st1 = tmamba.mamba2_apply(tp, tx, state=ts, chunked=False, **kw)
    out2, st2 = tmamba.mamba2_apply(tp, tx, state=ts, chunk=32, **kw)
    _close(out2, out1, atol=3e-4)
    _close(st2["ssm"], st1["ssm"], atol=3e-5)
    assert torch.equal(st1["conv"], st2["conv"])


# ------------------------------------------------------------ parameters

# what the JAX code reads in fp32 whatever the activation dtype
FP32_NAMES = {"ssm": {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "wa", "wb", "u", "scale",
                      "bias"},
              "hybrid": {"a_log", "d_skip", "dt_bias", "scale"}}


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_7b"])
def test_bf16_init_keeps_the_fp32_vectors(arch):
    cfg = tconfigs.get_reduced(arch)
    p32 = tmodel.init_params(cfg, 3, device="cpu")
    p16 = tmodel.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3, device="cpu")
    seen = set()
    for path, a, b in zip(tree_util.paths(p32), tree_util.leaves(p32), tree_util.leaves(p16)):
        if path[-1] in FP32_NAMES[cfg.family]:
            seen.add(path[-1])
            assert b.dtype == torch.float32 and torch.equal(a, b), path
        else:
            assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), path
    assert seen == FP32_NAMES[cfg.family]
