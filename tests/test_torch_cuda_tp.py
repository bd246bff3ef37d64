"""Model parallelism's card paths: the wgmma flash kernel on a TP rank's
local heads against the plain version, the ring with heads on ``model``
emulated as head blocks through ``LocalRing``, and the world of one (an
NCCL group of one rank, a 1x1 mesh) bit-equal to the unplaced train step
and serve.

Needs a CUDA device and nvcc (the libraries are built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_tp.py``.
No JAX: the card's machine does not have it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.dist.ring import LocalRing, ring_flash_attention
from repro_torch.kernels import flash_attention as fa

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0**-7, 1e-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _qkv(b, s, h, kv, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.3 * torch.randn((b, s, n, 128), generator=gen, device=dev)).to(torch.bfloat16)
            for n in (h, kv, kv)]


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), err.max().item()


@pytest.mark.parametrize("h,kv", [(16, 4), (8, 2), (10, 10)])
def test_local_heads_kernel_vs_plain(cuda, h, kv):
    """Llama's heads split over model 2 and 4, and Phi-3's expanded
    layout (g = 1) at model 4."""
    q, k, v = _qkv(2, 2048, h, kv, 1, cuda)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.launches["flash_attention_wgmma"] == 1 and fa.launches["flash_attention_simt"] == 0
    _close(out, fa.flash_attention_plain(q, k, v, causal=True), torch.bfloat16)


def test_ring_with_heads_on_model_emulated(cuda):
    q, k, v = _qkv(1, 8192, 32, 8, 2, cuda)
    single = fa.flash_attention(q, k, v, causal=True)
    blocks = [tuple(x[:, :, i * x.shape[2] // 2:(i + 1) * x.shape[2] // 2].contiguous()
                    for x in (q, k, v)) for i in range(2)]
    fa.reset_launches()
    got = torch.cat([ring_flash_attention(*blk, ring=LocalRing(4), causal=True)
                     for blk in blocks], dim=2)
    assert fa.launches["flash_attention_wgmma"] == 20 and fa.launches["flash_attention_simt"] == 0
    _close(got, single, torch.bfloat16)


@pytest.fixture
def world_of_one(cuda, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    yield
    dist.destroy_process_group()


def test_world_of_one_train_step_bit_equal(world_of_one):
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model
    from repro_torch.optim import adamw

    cfg = get_reduced("granite_moe_1b_a400m")
    params = model.init_params(cfg, 0, param_dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)),
                           device="cuda")
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((2, 64), device="cuda")}
    opt = adamw(3e-3)
    want, want_state, want_m = make_train_step(cfg, opt)(params, opt.init(params), batch)
    mesh = make_production_mesh(shape="1x1")
    placed = place_tree(make_plan(mesh), params)
    with CollectiveCounter() as counter:
        got, got_state, got_m = make_train_step(cfg, opt, mesh=mesh)(placed, opt.init(placed),
                                                                     batch)
    assert not counter.log
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(full_tree(got)),
                                                 tree_util.leaves(want)))
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(full_tree(got_state)),
                                                 tree_util.leaves(want_state)))
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m)


def test_world_of_one_serve_bit_equal(world_of_one):
    from repro_torch.configs import get_reduced
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model

    cfg = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash")
    params = model.init_params(cfg, 0)
    ctx = np.random.default_rng(2).integers(0, cfg.vocab, (2, 2560))
    want = serve.generate(cfg, params, ctx, 4)
    plan = make_plan(make_production_mesh(shape="1x1"), mode="serve")
    with activation_mesh(plan):
        got = serve.generate(cfg, place_tree(plan, params), ctx, 4)
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.logits, want.logits)
