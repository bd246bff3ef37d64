"""The ring (sequence-parallel) flash attention of ``repro_torch.dist.ring``
against the JAX package's ``ring_flash_attention`` and ``merge_partials``,
the plain flash version's position offsets against ``flash_attention_xla``
(and, non-causal without a window, bit-identical to no offsets), a
non-causal ring (the encdec encoder's) against one pass, and the two
transports against each other: ``GroupRing`` on 4 gloo ranks bit-equal
to ``LocalRing``. The JAX ring runs in a subprocess on forced
host devices (``tests/conftest.py`` forbids the flag in-process).
"""
import os
import pickle
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.dist import ring as ring_mod
from repro_torch.kernels import flash_attention as fa
from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _qkv(seed, b, s, t, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(shape)).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


def _dense_oracle(q, k, v, causal, window, q_offset, k_offset):
    """numpy attention over global positions (float64): (out, lse); rows
    with no visible key give 0 and -inf."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kk, vv = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    sc = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) * hd ** -0.5
    qp = q_offset + np.arange(s)[:, None]
    kp = k_offset + np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    sc = np.where(mask, sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    p = np.where(mask, np.exp(sc - np.where(np.isfinite(m), m, 0)), 0.0)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhst,bthd->bshd", p / np.where(l > 0, l, 1), vv)
    lse = np.where(l[..., 0] > 0, (m + np.log(np.where(l > 0, l, 1)))[..., 0], -np.inf)
    return out, lse.transpose(0, 2, 1)


# ------------------------------------------------------------ merge

def test_merge_partials_matches_jax():
    rng = np.random.default_rng(0)
    shape = (2, 64, 4)

    def part(scale):
        acc = rng.standard_normal(shape + (16,)).astype(np.float32)
        m = (scale * rng.standard_normal(shape)).astype(np.float32)
        l = rng.uniform(0.5, 40.0, shape).astype(np.float32)
        return acc, m, l

    a, b = part(3.0), part(10.0)
    b[1][0, :5] = -1e30            # rows with no visible key in b
    b[0][0, :5] = 0.0
    b[2][0, :5] = 0.0
    want = jfa.merge_partials(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = ring_mod.merge_partials(tuple(map(_t, a)), tuple(map(_t, b)))
    for w, g in zip(want, got):     # torch's and XLA's exp differ in the last bit
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    ident = (torch.zeros(shape + (16,)), torch.full(shape, -1e30), torch.zeros(shape))
    for w, g in zip(map(_t, a), ring_mod.merge_partials(tuple(map(_t, a)), ident)):
        assert torch.equal(w, g)


# ------------------------------------------------ offsets of the plain version

# B, S, T, H, KV, hd, causal, window, q_offset, k_offset (S, T multiples of 64)
JAX_OFFSET_CASES = [
    (1, 256, 256, 4, 2, 32, True, 0, 256, 0),       # a past shard: all visible
    (1, 256, 256, 4, 2, 32, True, 0, 0, 256),       # a future shard: nothing visible
    (2, 192, 128, 4, 1, 32, True, 0, 300, 200),     # partial diagonal, GQA 4
    (1, 256, 256, 4, 4, 32, True, 100, 256, 0),     # window: rows with no visible key
    (1, 128, 256, 2, 2, 32, False, 0, 17, 900),     # non-causal, offsets ignored
    (1, 256, 192, 4, 2, 32, False, 150, 40, 64),    # non-causal window
]


@pytest.mark.parametrize("case", JAX_OFFSET_CASES, ids=[f"c{i}" for i in range(6)])
def test_plain_offsets_match_flash_attention_xla(case):
    b, s, t, h, kv, hd, causal, window, qo, ko = case
    q, k, v = _qkv(sum(case), b, s, t, h, kv, hd)
    want, want_lse = jfa.flash_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64,
        causal=causal, window=window, q_offset=qo, k_offset=ko, with_lse=True)
    for block in (64, 512):
        got, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), block_q=block, block_k=block,
                                            causal=causal, window=window, q_offset=qo,
                                            k_offset=ko, with_lse=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    # the wrapper on CPU tensors is the plain version; out_fp32 keeps fp32
    w, wl = fa.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(),
                               causal=causal, window=window, q_offset=qo, k_offset=ko,
                               with_lse=True, out_fp32=True)
    assert w.dtype == torch.float32 and wl.dtype == torch.float32
    # not rounded to bf16 (a step with no visible key writes only zeros)
    assert not w.any() or bool((w != w.bfloat16().float()).any())


RAGGED_CASES = [
    (2, 100, 77, 6, 2, 16, True, 0, 60, 0),
    (1, 130, 61, 4, 4, 16, True, 40, 90, 10),
    (1, 50, 300, 2, 1, 16, False, 70, 100, 0),
    (1, 65, 65, 2, 2, 8, True, 0, 0, 65),           # all rows empty
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=[f"r{i}" for i in range(4)])
def test_plain_offsets_ragged_match_dense_oracle(case):
    b, s, t, h, kv, hd, causal, window, qo, ko = case
    q, k, v = _qkv(sum(case), b, s, t, h, kv, hd)
    want, want_lse = _dense_oracle(q, k, v, causal, window, qo, ko)
    got, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), block_q=64, block_k=32,
                                        causal=causal, window=window, q_offset=qo,
                                        k_offset=ko, with_lse=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    empty = ~np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[~empty], want_lse[~empty], **TOL)
    assert np.all(lse.numpy()[empty] <= -1e29) and np.all(got.numpy()[empty] == 0)


def test_offsets_are_checked():
    q, k, v = (_t(x) for x in _qkv(0, 1, 8, 8, 2, 2, 8))
    with pytest.raises(TypeError, match="Python int"):
        fa.flash_attention(q, k, v, q_offset=torch.tensor(3))
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention(q, k, v, q_offset=2**31)


# ------------------------------------------------------------ the ring

_JAX_RING = r"""
import sys
import jax, numpy as np
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.kernels.flash_attention import ring_flash_attention
key = jax.random.PRNGKey(0)
kq, kk, kv = jax.random.split(key, 3)
q = 0.3 * jax.random.normal(kq, (1, 1024, 4, 32))
k = 0.3 * jax.random.normal(kk, (1, 1024, 2, 32))
v = 0.3 * jax.random.normal(kv, (1, 1024, 2, 32))
out = {"q": np.asarray(q), "k": np.asarray(k), "v": np.asarray(v)}
spec = P(None, "seq", None, None)
for n in (4, 8):
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("seq",))
    for window in (0, 200):
        fn = partial(ring_flash_attention, axis_name="seq", axis_size=n,
                     block_q=64, block_k=64, causal=True, window=window)
        ring = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                                 out_specs=spec, check_rep=False))(q, k, v)
        out[f"ring_{n}_{window}"] = np.asarray(ring)
np.savez(sys.argv[1], **out)
print("JAX-RING-OK")
"""


# ------------------------------------------------- GroupRing over gloo

GROUP_CASES = [("fp32", True, 0), ("fp32", True, 200), ("fp32", False, 300), ("bf16", True, 0)]


def _group_ring(rank, world, inputs, out_dir):
    """Each rank's GroupRing output on its shard of every case."""
    from repro_torch.dist import ring as r

    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    res = {}
    for name, (q, k, v, causal, window) in cases.items():
        s_loc = q.shape[1] // world
        sl = slice(rank * s_loc, (rank + 1) * s_loc)
        res[name] = r.ring_flash_attention(q[:, sl].contiguous(), k[:, sl].contiguous(),
                                           v[:, sl].contiguous(), ring=r.GroupRing(),
                                           causal=causal, window=window)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """JAX's ring on 8 forced devices (a subprocess) and ``GroupRing`` on 4
    gloo ranks, run side by side."""
    out = tmp_path_factory.mktemp("ring")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RING, str(out / "ring.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        cases = {}
        for i, (dtype, causal, window) in enumerate(GROUP_CASES):
            q, k, v = (_t(x) for x in _qkv(10 + i, 2, 1024, 1024, 8, 2, 16))
            if dtype == "bf16":
                q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
            cases[f"{dtype}-{causal}-{window}"] = (q, k, v, causal, window)
        with open(out / "inputs.pkl", "wb") as f:
            pickle.dump(cases, f)
        spawn_gloo(_group_ring, 4, out, str(out / "inputs.pkl"), str(out))
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-RING-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    got = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return dict(np.load(out / "ring.npz")), cases, got


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("window", [0, 200])
def test_local_ring_matches_jax_ring(rings, n, window):
    jax_ring = rings[0]
    q, k, v = (_t(jax_ring[x]) for x in "qkv")
    got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(n), causal=True,
                                        window=window)
    np.testing.assert_allclose(got.numpy(), jax_ring[f"ring_{n}_{window}"], rtol=0, atol=2e-5)
    single = fa.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=2e-5)


def _counted(fn):
    calls = []

    def wrapper(*a, **kw):
        calls.append((kw["q_offset"], kw["k_offset"]))
        return fn(*a, **kw)

    return wrapper, calls


@pytest.mark.parametrize("n,window,want", [(4, 0, 10), (8, 0, 36), (4, 256, 7), (4, 257, 7),
                                           (4, 258, 9), (4, 300, 9)])
def test_dead_steps_are_skipped(n, window, want):
    """A causal ring launches idx + 1 steps on rank idx; a window skips the
    shards wholly outside it. At S_loc = 256 the first query of shard idx
    (position 256 idx) sees keys above 256 idx - window: shard idx - 2's
    last key, 256 idx - 257, only from window 258 on."""
    q, k, v = (_t(x) for x in _qkv(1, 1, 1024, 1024, 4, 2, 16))
    wrapper, calls = _counted(fa.flash_attention)
    with mock.patch.object(ring_mod.fa, "flash_attention", wrapper):
        ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(n), window=window)
    assert len(calls) == want
    s_loc = 1024 // n
    if not window:
        per_rank = [sum(1 for qo, _ in calls if qo == i * s_loc) for i in range(n)]
        assert per_rank == [i + 1 for i in range(n)]


def _every_step(q, k, v, n, causal, window):
    """Each rank's schedule with every step launched (dead ones give the
    identity partial through the kernel's empty rows), merged in the ring's
    order."""
    s_loc = q.shape[1] // n
    outs = []
    for idx in range(n):
        sl = slice(idx * s_loc, (idx + 1) * s_loc)
        state = None
        for t in range(n):
            src = (idx - t) % n
            ks = slice(src * s_loc, (src + 1) * s_loc)
            out, lse = fa.flash_attention(q[:, sl], k[:, ks], v[:, ks], causal=causal,
                                          window=window, q_offset=idx * s_loc,
                                          k_offset=src * s_loc, with_lse=True, out_fp32=True)
            part = (out, lse, torch.ones_like(lse))
            state = part if state is None else ring_mod.merge_partials(state, part)
        acc, _m, l = state
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 200), (False, 200)])
def test_skipped_steps_equal_launched_ones(causal, window):
    q, k, v = (_t(x) for x in _qkv(2, 2, 1024, 1024, 4, 2, 16))
    got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(4), causal=causal,
                                        window=window)
    assert torch.equal(got, _every_step(q, k, v, 4, causal, window))


def test_non_causal_ring_equals_one_pass():
    """The encdec encoder's ring: non-causal, no window, every step visible
    and launched (n x n), at n = 4 against one pass of the plain version."""
    q, k, v = (_t(x) for x in _qkv(4, 2, 1024, 1024, 4, 4, 16))
    wrapper, calls = _counted(fa.flash_attention)
    with mock.patch.object(ring_mod.fa, "flash_attention", wrapper):
        got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(4), causal=False)
    assert len(calls) == 4 * 4
    want = fa.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("q_offset,k_offset", [(8192, 0), (0, 8192), (17, 900)])
def test_plain_non_causal_ignores_offsets(q_offset, k_offset):
    """A non-causal, windowless mask reads no position: the plain version
    with offsets is bit-identical to it without (the kernels are passed
    none for such a call)."""
    q, k, v = (_t(x) for x in _qkv(5, 1, 192, 320, 4, 2, 16))
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=False, with_lse=True)
    got, lse = fa.flash_attention_plain(q, k, v, causal=False, with_lse=True,
                                        q_offset=q_offset, k_offset=k_offset)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)


def test_ring_refuses_grad_and_ragged_shards():
    q, k, v = (_t(x) for x in _qkv(3, 1, 256, 256, 2, 2, 8))
    with pytest.raises(ValueError, match="no backward"):
        ring_mod.ring_flash_attention(q.requires_grad_(True), k, v, ring=ring_mod.LocalRing(2))
    with torch.no_grad():
        ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(2))
    with pytest.raises(ValueError, match="divide"):
        ring_mod.ring_flash_attention(q.detach(), k, v, ring=ring_mod.LocalRing(3))
    with pytest.raises(ValueError, match="n >= 1"):
        ring_mod.LocalRing(0)


@pytest.mark.parametrize("name", [f"{d}-{c}-{w}" for d, c, w in GROUP_CASES])
def test_group_ring_bit_equal_to_local_ring(rings, name):
    _, cases, got = rings
    q, k, v, causal, window = cases[name]
    want = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(4), causal=causal,
                                         window=window)
    assert torch.equal(torch.cat([g[name] for g in got], dim=1), want)
