"""The grouped expert kernels (``moe_rows_gemm_kernel``,
``moe_wgrad_gemm_kernel``, ``csrc/moe_grouped.cu``) against per-expert
torch products on the card, and the dropless MoE on the card against its
plain twin on the CPU.

Tolerance: the kernels sum each output's K products in index order with
fp32 FMAs, cuBLAS in its own order, so they agree to fp32 rounding over K
= 256 terms: 1e-5 of the largest entry. Routing is drawn so that an
expert owns no row and another owns one ragged tile.

Needs a CUDA device and nvcc (the library is built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_moe_grouped.py``.
No JAX: the card's machine does not have it.
"""
import pytest
import torch

from repro_torch.kernels import moe_grouped
from repro_torch.models import moe

D, F, N_EXP = 256, 96, 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _segments(dev):
    """Rows by expert: 70, 0 (an empty expert), 130, 1, 64; and a row
    index into a 300-row operand."""
    counts = torch.tensor([70, 0, 130, 1, 64])
    seg = torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0)).to(dev)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 300, (int(counts.sum()) + 40,), generator=gen).to(dev)
    return seg, rows, counts.tolist()


def _close(a, b):
    assert (a - b).abs().max() <= 1e-5 * b.abs().max(), (a - b).abs().max()


@pytest.mark.parametrize("transpose", [False, True], ids=["b", "b_transposed"])
def test_rows_gemm_matches_per_expert_products(cuda, transpose):
    seg, rows, counts = _segments(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(300, D, device=cuda, generator=gen)
    b = torch.randn((N_EXP, F, D) if transpose else (N_EXP, D, F), device=cuda, generator=gen)
    out = torch.zeros(rows.shape[0], F, device=cuda)
    moe_grouped.rows_gemm(a, rows, b, seg, out, transpose_b=transpose)
    moe_grouped.rows_gemm(a, rows, b, seg, out, transpose_b=transpose, accumulate=True)
    bounds = seg.tolist()
    for e in range(N_EXP):
        lo, hi = bounds[e], bounds[e + 1]
        want = a[rows[lo:hi]] @ (b[e].T if transpose else b[e])
        if hi > lo:
            _close(out[lo:hi], 2 * want)
    assert torch.all(out[bounds[-1]:] == 0)       # rows past the last expert's are left alone


def test_wgrad_gemm_matches_per_expert_products(cuda):
    seg, rows, _ = _segments(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(300, D, device=cuda, generator=gen)
    g = torch.randn(rows.shape[0], F, device=cuda, generator=gen)
    got = moe_grouped.wgrad_gemm(a, rows, g, seg)
    bounds = seg.tolist()
    for e in range(N_EXP):
        lo, hi = bounds[e], bounds[e + 1]
        want = a[rows[lo:hi]].T @ g[lo:hi]
        if hi > lo:
            _close(got[e], want)
        else:
            assert torch.all(got[e] == 0)


def test_dropless_moe_on_the_card_matches_the_cpu(cuda):
    """The MoE's output and every gradient, card (kernels) against CPU
    (plain twins), on the same weights and input: 9 of 72 experts, top-10."""
    gen = torch.Generator().manual_seed(3)
    p = moe.share_params(gen, D, F, 72, (0, 9))
    x = torch.randn(2, 512, D, generator=gen)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        out, loads = moe.dropless_apply(leaves, xd, top_k=10, held=(0, 9))
        w = torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)
        grads = torch.autograd.grad((out * w).sum(), [xd] + list(leaves.values()))
        outs[str(dev)] = [out, loads] + list(grads)
    for c, g in zip(outs["cpu"], outs[str(cuda)]):
        _close(g.cpu(), c)
