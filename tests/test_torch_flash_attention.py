"""The port's plain flash attention against the JAX package's three
implementations of ``repro.kernels.flash_attention``: the Pallas kernel in
interpret mode, the XLA twin and the dense oracle ``flash_attention_ref``,
on the grid of ``tests/test_flash_attention.py`` with its tolerance (fp32
accumulation everywhere: rtol = atol = 2e-5), from the same numpy inputs.
The block-range geometry must equal JAX's exactly. The CUDA kernel itself
is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, s, h, kv, hd, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return tuple((0.3 * rng.standard_normal(shape)).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96), (False, 0), (False, 40)])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
def test_plain_matches_pallas_xla_and_ref(causal, window, h, kv):
    q, k, v = _qkv(h * 10 + kv + window, 2, 256, h, kv, 32)
    got = tfa.flash_attention_plain(*_torch(q, k, v), block_q=128, block_k=128,
                                    causal=causal, window=window).numpy()
    jq, jk, jv = _jax(q, k, v)
    wants = {
        "ref": flash_attention_ref(jq, jk, jv, causal=causal, window=window),
        "xla": jfa.flash_attention_xla(jq, jk, jv, block_q=128, block_k=128,
                                       causal=causal, window=window),
        "pallas": jfa.flash_attention_pallas(jq, jk, jv, block_q=128, block_k=128,
                                             causal=causal, window=window, interpret=True),
    }
    for name, want in wants.items():
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)


def test_uneven_blocks_and_lse():
    # block_q != block_k, diagonal straddles block boundaries
    q, k, v = _qkv(7, 1, 384, 4, 2, 16)
    got, got_lse = tfa.flash_attention_plain(*_torch(q, k, v), block_q=128, block_k=64,
                                             causal=True, with_lse=True)
    jq, jk, jv = _jax(q, k, v)
    wants = {
        "ref": flash_attention_ref(jq, jk, jv, causal=True, with_lse=True),
        "xla": jfa.flash_attention_xla(jq, jk, jv, block_q=128, block_k=64, causal=True,
                                       with_lse=True),
        "pallas": jfa.flash_attention_pallas(jq, jk, jv, block_q=128, block_k=64, causal=True,
                                             interpret=True, with_lse=True),
    }
    for name, (want, want_lse) in wants.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=name, **TOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), err_msg=name, **TOL)


def test_window_skips_blocks_and_matches():
    # window 64 over 512 tokens in 128-blocks: whole KV blocks are skipped,
    # boundary rows inside visited blocks are partly masked
    q, k, v = _qkv(11, 1, 512, 4, 2, 32)
    got = tfa.flash_attention_plain(*_torch(q, k, v), block_q=128, block_k=128,
                                    causal=True, window=64).numpy()
    jq, jk, jv = _jax(q, k, v)
    np.testing.assert_allclose(
        got, np.asarray(flash_attention_ref(jq, jk, jv, causal=True, window=64)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jfa.flash_attention_xla(jq, jk, jv, block_q=128, block_k=128,
                                                causal=True, window=64)), **TOL)


def test_bf16_inputs_match_the_xla_twin():
    # the same fp32 draws rounded to bf16 on both sides (round to nearest
    # even), fp32 accumulation; the bf16 outputs may differ by one bf16 ulp
    # (<= 2^-7 relative) where the fp32 results round differently
    q, k, v = _qkv(13, 1, 256, 4, 2, 32)
    got = tfa.flash_attention_plain(*[x.to(torch.bfloat16) for x in _torch(q, k, v)],
                                    block_q=128, block_k=128, causal=True)
    want = jfa.flash_attention_xla(*[x.astype(jnp.bfloat16) for x in _jax(q, k, v)],
                                   block_q=128, block_k=128, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 50), (False, 70)])
def test_ragged_shapes_match_ref(causal, window):
    # S and T divide no block: the plain version masks the padded keys
    q, k, v = _qkv(17 + window, 2, 200, 4, 2, 32, t=333)
    got, got_lse = tfa.flash_attention_plain(*_torch(q, k, v), block_q=64, block_k=128,
                                             causal=causal, window=window, with_lse=True)
    want, want_lse = flash_attention_ref(*_jax(q, k, v), causal=causal, window=window,
                                         with_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_block_ranges_equal_jax():
    for bq, bk, nk, causal, window, q_off, k_off in itertools.product(
            (32, 64, 128), (32, 64, 128), (1, 4, 9), (True, False), (0, 1, 40, 64, 300),
            (0, 96), (0, 64)):
        for qi in range(6):
            kw = dict(block_q=bq, block_k=bk, nk=nk, causal=causal, window=window,
                      q_offset=q_off, k_offset=k_off)
            assert tfa.kv_block_range(qi, **kw) == jfa.kv_block_range(qi, **kw), (qi, kw)
        kw = dict(block_q=bq, block_k=bk, nk=nk, causal=causal, window=window)
        assert tfa.visited_block_counts(6, **kw) == jfa.visited_block_counts(6, **kw), kw


def test_wrapper_runs_the_plain_version_on_the_cpu():
    # any dtype and head dim on the CPU: the kernel's limits bind the card only
    q, k, v = _torch(*_qkv(19, 1, 64, 2, 1, 160))
    tfa.reset_launches()
    out, lse = tfa.flash_attention(q, k, v, with_lse=True)
    want, want_lse = tfa.flash_attention_plain(q, k, v, with_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    half = tfa.flash_attention(q.half(), k.half(), v.half())
    assert half.dtype == torch.float16
    assert tfa.launches["flash_attention"] == 0


def test_wrapper_rejects_bad_shapes():
    q, k, v = _torch(*_qkv(23, 1, 64, 3, 2, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention(q, k, v)
    q, k, v = _torch(*_qkv(23, 1, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k[..., :8], v[..., :8])
