"""The moe, vlm, encdec, ssm and hybrid serving paths' kernels and routing
on the card.

The wgmma flash kernel's hd 64 build, causal (Granite-3.0 1B-A400M's
heads) and non-causal (SeamlessM4T's encoder), against the plain version
on the card; ``moe._local_top_k`` with planted ties on the card against
the CPU; and a reduced Granite prefill (fp32, flash, its routing in
512-token chunks) and greedy decode on the card against the CPU from the
same weights. The reduced RWKV6-7B (chunked WKV, no attention) and
Zamba2-7B (chunked SSD, the shared attention at window 64 through the SIMT
kernel) in fp32 at 2,560 positions, card against CPU.

Needs a CUDA device and nvcc (the flash libraries are built at first
use); every test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_families.py``.
No JAX: the card's machine does not have it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import model, moe

# bf16 (wgmma kernel): fp32 scores and accumulator, p as two bf16 halves
# (2^-16 relative): only order and rounding differ from the plain version,
# and a bf16 output may round to a neighbouring value, one ulp <= 2^-7
BF16_TOL = dict(rtol=2**-7, atol=1e-6)
# fp32 logits of the reduced model, card against CPU: sums in other orders
# (|logit| < 3); far below any routing flip, which moves a logit by ~1e-2
LOGIT_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kv,causal", [(8, True), (16, False)], ids=["granite", "seamless-enc"])
def test_flash_wgmma_hd64_matches_plain(cuda, kv, causal):
    gen = torch.Generator(device=cuda).manual_seed(kv)
    q, k, v = ((0.3 * torch.randn(shape, generator=gen, device=cuda)).bfloat16()
               for shape in ((2, 1024, 16, 64), (2, 1024, kv, 64), (2, 1024, kv, 64)))
    fa.reset_launches()
    out, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
    assert fa.launches["flash_attention_wgmma"] == 1 and fa.launches["flash_attention_simt"] == 0
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


def test_local_top_k_ties_on_the_card(cuda):
    rng = np.random.default_rng(0)
    probs = rng.choice(np.array([0.05, 0.1, 0.2, 0.3], np.float32), size=(4, 64, 32))
    probs[0, 0] = 0.25
    vals, idx = moe._local_top_k(torch.from_numpy(probs).to(cuda), 8)
    want_vals, want_idx = moe._local_top_k(torch.from_numpy(probs), 8)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(vals.cpu(), want_vals)
    assert idx[0, 0].tolist() == list(range(8))


def test_reduced_moe_prefill_card_vs_cpu(cuda):
    cfg = dataclasses.replace(get_reduced("granite_moe_1b_a400m"), attn_impl="flash")
    params_cpu = model.init_params(cfg, 0, device="cpu")
    params_gpu = tree_util.map(lambda t: t.to(cuda), params_cpu)
    ctx = np.random.default_rng(1).integers(0, cfg.vocab, (2, 2560))
    fa.reset_launches()
    g = serve.generate(cfg, params_gpu, ctx, 4)
    assert fa.launches["flash_attention_simt"] == cfg.n_layers
    c = serve.generate(cfg, params_cpu, ctx, 4, device="cpu")
    assert torch.equal(g.tokens.cpu(), c.tokens)
    torch.testing.assert_close(g.logits.cpu(), c.logits, rtol=0, atol=LOGIT_ATOL)
    # layer 0's routing of the embedded context (five 512-token chunks; the
    # fractions are multiples of 2^-11, so both sum them exactly): the same drops
    drops = [moe.moe_apply(model.layer_params(p, 0)["moe"],
                           model.embed_inputs(cfg, p, {"tokens": torch.as_tensor(ctx, device=dev)}),
                           top_k=cfg.top_k)[1]["dropped_frac"].item()
             for dev, p in ((cuda, params_gpu), ("cpu", params_cpu))]
    assert drops[0] == drops[1]


@pytest.mark.parametrize("arch,n_simt", [("rwkv6_7b", 0), ("zamba2_7b", 2)])
def test_reduced_recurrent_serve_card_vs_cpu(cuda, arch, n_simt):
    # fp32 at 2,560 positions: the chunked scans (a multiple of 64) on both
    # devices; the reduced Zamba2's two shared-attention applications
    # through the SIMT kernel, RWKV6 without a flash launch
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="flash")
    params_cpu = model.init_params(cfg, 0, device="cpu")
    params_gpu = tree_util.map(lambda t: t.to(cuda), params_cpu)
    ctx = np.random.default_rng(1).integers(0, cfg.vocab, (2, 2560))
    fa.reset_launches()
    g = serve.generate(cfg, params_gpu, ctx, 4)
    assert fa.launches == {"flash_attention": n_simt, "flash_attention_wgmma": 0,
                           "flash_attention_simt": n_simt}
    c = serve.generate(cfg, params_cpu, ctx, 4, device="cpu")
    assert torch.equal(g.tokens.cpu(), c.tokens)
    torch.testing.assert_close(g.logits.cpu(), c.logits, rtol=0, atol=LOGIT_ATOL)
