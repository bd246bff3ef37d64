"""The flash kernels' position offsets and fp32 partials, and the ring
emulation (causal, and the encdec encoder's non-causal ring), on the card
against the plain version; a non-causal, windowless step passes the
kernels no offset, bit-identical to the ``OFFSET`` instantiation.

Needs a CUDA device and nvcc (the libraries are built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_dist.py``.
No JAX: the card's machine does not have it.
"""
import pytest
import torch

from repro_torch.dist import ring as ring_mod
from repro_torch.kernels import flash_attention as fa

# (rtol, atol) of an output of this type; an fp32 partial of bf16 inputs is
# held at the fp32 limit
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0**-7, 1e-6)}


def _unrounded(out32):
    """True when an fp32 partial holds values bf16 cannot (it was not
    rounded to bf16 before its fp32 store) or only the zeros of a step
    with no visible key."""
    return not out32.any() or bool((out32 != out32.to(torch.bfloat16).float()).any())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _qkv(b, s, t, h, kv, hd, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.3 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))]


# (B, S, T, H, KV, hd, causal, window, q_offset, k_offset): past and future
# shards, offsets whose tile bounds are negative (floor division), windows
# that leave rows with no visible key, ragged S and T, hd 64 / 112 / 128
OFFSET_CASES = [
    (1, 256, 256, 4, 2, 64, True, 0, 256, 0),
    (1, 256, 256, 4, 2, 64, True, 0, 0, 256),
    (2, 300, 250, 8, 2, 128, True, 0, 700, 450),
    (1, 320, 320, 6, 2, 112, True, 200, 320, 0),
    (1, 512, 512, 4, 4, 64, True, 100, 512, 0),
    (1, 384, 384, 4, 1, 128, False, 130, 100, 300),
    (2, 200, 333, 4, 2, 64, False, 0, 5, 77),
    (1, 256, 256, 4, 2, 64, True, 64, 100, 37),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", OFFSET_CASES, ids=[f"case{i}" for i in range(len(OFFSET_CASES))])
def test_offset_kernels_match_plain(cuda, dtype, case):
    """Each route with offsets and the fp32 partial against the plain
    version at the fp32 limit, not bf16-rounded; rows with no visible key
    write 0 and lse -1e30."""
    b, s, t, h, kv, hd, causal, window, qo, ko = case
    q, k, v = _qkv(b, s, t, h, kv, hd, dtype, sum(case), cuda)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko, with_lse=True,
              out_fp32=True)
    fa.reset_launches()
    out, lse = fa.flash_attention(q, k, v, **kw)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.launches[f"flash_attention_{route}"] == 1
    assert out.dtype == torch.float32
    want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    rtol, atol = TOL[out.dtype]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    assert _unrounded(out)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    empty = want_lse <= -1e29
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    assert bool((lse[empty] <= -1e29).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(2, 1000, 1537, 16, 2, 112, False, 0),
                                   (1, 2048, 2048, 8, 2, 128, True, 512),
                                   (2, 1024, 1024, 8, 8, 64, True, 0)],
                         ids=["ragged", "window", "hd64"])
def test_offset_zero_and_fp32_partial_bit_identical(cuda, dtype, shape):
    """Offsets that cancel and the fp32 output leave the numbers as the
    default entry's: out rounds to the same bits, lse is the same."""
    b, s, t, h, kv, hd, causal, window = shape
    q, k, v = _qkv(b, s, t, h, kv, hd, dtype, s, cuda)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window, with_lse=True)
    out32, lse32 = fa.flash_attention(q, k, v, causal=causal, window=window, with_lse=True,
                                      q_offset=3 * s, k_offset=3 * s, out_fp32=True)
    assert torch.equal(out32.to(dtype), out)
    assert torch.equal(lse32, lse)
    assert _unrounded(out32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,window", [(4, 0), (4, 300), (8, 0)], ids=["n4", "n4-window", "n8"])
def test_local_ring_matches_single_pass(cuda, dtype, n, window):
    """LocalRing on the card against one kernel pass over the whole
    sequence, and its launches: idx + 1 per rank for a causal ring."""
    q, k, v = _qkv(2, 2048, 2048, 8, 2, 128, dtype, n + window, cuda)
    want = fa.flash_attention(q, k, v, causal=True, window=window)
    fa.reset_launches()
    got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(n), causal=True,
                                        window=window)
    if not window:
        assert fa.launches["flash_attention"] == n * (n + 1) // 2
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_local_ring_on_views_equals_contiguous_shards(cuda):
    """A shard that is a view of the whole tensor (its batch stride the
    whole sequence's) takes the wgmma route and gives the same bits."""
    q, k, v = _qkv(2, 2048, 2048, 8, 2, 128, torch.bfloat16, 5, cuda)
    shards = [ring_mod.LocalRing(4).split(x)[1] for x in (q, k, v)]
    assert not shards[0].is_contiguous() and fa._kernel_route(*shards) == "wgmma"
    got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(4))

    class Contiguous(ring_mod.LocalRing):
        def split(self, x):
            return [p.contiguous() for p in super().split(x)]

    assert torch.equal(got, ring_mod.ring_flash_attention(q, k, v, ring=Contiguous(4)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 1024, 1024, 16, 16, 64, 1024, 0),
                                   (2, 300, 517, 8, 2, 112, 17, 900)],
                         ids=["seamless-step", "ragged"])
def test_non_causal_offset_passes_none_bit_identical(cuda, dtype, shape):
    """A non-causal, windowless step's offsets change no mask: the wrapper
    passes the kernels no offset, and its result is bit-identical to the
    same step through the ``OFFSET`` instantiation (``_launch`` with the
    offset), both through the route of the dtype."""
    b, s, t, h, kv, hd, qo, ko = shape
    q, k, v = _qkv(b, s, t, h, kv, hd, dtype, s + t, cuda)
    fa.reset_launches()
    out, lse = fa.flash_attention(q, k, v, causal=False, q_offset=qo, k_offset=ko,
                                  with_lse=True, out_fp32=True)
    out_o, lse_o = fa._launch(q, k, v, causal=False, window=0, off=qo - ko, with_lse=True,
                              out_fp32=True)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.launches[f"flash_attention_{route}"] == 2
    assert torch.equal(out, out_o) and torch.equal(lse, lse_o)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=False, with_lse=True,
                                              out_fp32=True)
    rtol, atol = TOL[torch.float32]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [2, 4])
def test_non_causal_local_ring_matches_single_pass(cuda, n):
    """The encoder's ring: non-causal, every step visible and launched
    (n x n), against one wgmma pass."""
    q, k, v = _qkv(1, 4096, 4096, 16, 16, 64, torch.bfloat16, n, cuda)
    want = fa.flash_attention(q, k, v, causal=False)
    fa.reset_launches()
    got = ring_mod.ring_flash_attention(q, k, v, ring=ring_mod.LocalRing(n), causal=False)
    assert fa.launches["flash_attention_wgmma"] == n * n
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
