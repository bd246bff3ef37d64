"""The CUDA wire kernels against their plain torch versions on the card.

Needs a CUDA device and nvcc (the library is built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py``.
No JAX: the card's machine does not have it.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import stochastic_quant as sq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _planes(k, m, q_max, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(1, q_max + 1, (k,), generator=gen, device=dev)
    hi = ((torch.ones_like(q) << q) - 1)[:, None, None]
    idx = torch.minimum((torch.rand((k, m, 128), generator=gen, device=dev) * (hi + 1)).long(),
                        hi).to(dtype)
    signs = (torch.rand((k, m, 128), generator=gen, device=dev) < 0.5).to(torch.uint8)
    scales = torch.rand((k,), generator=gen, device=dev) + 0.1
    w = torch.rand((k,), generator=gen, device=dev)
    return idx, signs, scales, w / w.sum(), q


@pytest.mark.parametrize("k,m,q_max,dtype", [
    (8, 1984, 8, torch.uint8), (8, 1984, 16, torch.uint16), (1024, 37, 8, torch.uint8),
    (1, 1, 8, torch.uint8),
], ids=["main-path", "u16", "k1024-ragged", "k1-m1"])
def test_aggregate_kernel_matches_plain(cuda, k, m, q_max, dtype):
    idx, signs, scales, w, q = _planes(k, m, q_max, dtype, k + m, cuda)
    sq.reset_launches()
    got = sq.aggregate(idx, signs, scales, w, q)
    assert sq.launches["aggregate"] == 1
    want = sq.aggregate_plain(idx, signs, scales, w, q)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("q_bits", [1, 2, 4, 8])
def test_quantize_dequantize_kernels_bit_equal(cuda, q_bits):
    gen = torch.Generator(device=cuda).manual_seed(q_bits)
    x = torch.randn((2048, 128), generator=gen, device=cuda) * 0.05
    rbits = ops.random_bits(x.shape, gen)
    scale = x.abs().amax().reshape(1)
    sq.reset_launches()
    idx, signs = sq.quantize(x, rbits, scale, q_bits)
    assert torch.equal(idx, sq.quantize_plain(x, rbits, scale, q_bits)[0])
    assert torch.equal(signs, sq.quantize_plain(x, rbits, scale, q_bits)[1])
    corrupt = torch.randint(0, 256, x.shape, generator=gen, device=cuda).to(torch.uint8)
    for planes in (idx, corrupt):
        assert torch.equal(sq.dequantize(planes, signs, scale, q_bits),
                           sq.dequantize_plain(planes, signs, scale, q_bits))
    assert sq.launches == {"aggregate": 0, "quantize": 1, "dequantize": 2}


def test_cuda_wrappers_reject_mixed_devices(cuda):
    x = torch.zeros((256, 128), device=cuda)
    rbits = torch.zeros((256, 128), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="several devices"):
        sq.quantize(x, rbits, torch.ones(1, device=cuda), 4)
