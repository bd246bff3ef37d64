"""Model parallelism's card paths: the wgmma flash kernel on a TP rank's
local heads against the plain version (Llama's heads at ``model`` 2 and 4,
Phi-3's expanded layout, and the ssm/hybrid/encdec/vlm families' shapes:
Zamba2's shared attention at hd 112 with its window, InternVL2's g = 6,
Seamless's encoder at hd 64, non-causal), the ring with heads on
``model`` emulated as head blocks through ``LocalRing``, and the world of
one (an NCCL group of one rank, a 1x1 mesh) bit-equal to the unplaced
train step and serve, for Granite and Llama and for the reduced RWKV6-7B,
Zamba2-7B, SeamlessM4T-large-v2 and InternVL2-26B (value and gradients,
prefill and 8 decode steps).

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


def _qkv(b, s, h, kv, seed, dev, hd=128):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(0.3 * torch.randn((b, s, n, hd), generator=gen, device=dev)).to(torch.bfloat16)
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


@pytest.mark.parametrize("h,kv,hd,causal,window", [
    (16, 16, 112, True, 4096),      # Zamba2-7B's shared attention at model 2
    (24, 4, 128, True, 0),          # InternVL2-26B at model 2 (g = 6)
    (8, 8, 64, False, 0),           # SeamlessM4T's encoder at model 2
])
def test_family_local_heads_kernel_vs_plain(cuda, h, kv, hd, causal, window):
    q, k, v = _qkv(1, 4096, h, kv, 3, cuda, hd)
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launches["flash_attention_wgmma"] == 1 and fa.launches["flash_attention_simt"] == 0
    _close(out, fa.flash_attention_plain(q, k, v, causal=causal, window=window), torch.bfloat16)


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


FAMILIES = ("rwkv6_7b", "zamba2_7b", "seamless_m4t_large_v2", "internvl2_26b")


def _family_batch(cfg, dev):
    rng = np.random.default_rng(4)
    b, s = 4, 64
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device=dev)
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((b, s), device=dev)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn((b, 24, cfg.d_model), device=dev)
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.randn((b, cfg.n_vis_tokens, cfg.d_model), device=dev)
    return batch


def _greedy(cfg, params, batch, new=8):
    from repro_torch.models import decode

    inputs = {k: v for k, v in batch.items() if k not in ("labels", "mask")}
    if cfg.family == "encdec":
        inputs.pop("tokens")
    ctx = batch["tokens"].shape[1] + cfg.n_vis_tokens * (cfg.family == "vlm")
    logits, cache = decode.prefill(cfg, params, inputs, ctx + new)
    out = [logits]
    for _ in range(new):
        logits, cache = decode.decode_step(cfg, params, cache, torch.argmax(out[-1], -1))
        out.append(logits)
    return torch.stack(out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_world_of_one_family_bit_equal(world_of_one, arch):
    """The reduced family placed on a 1x1 mesh: loss and every gradient
    (train plan), prefill and 8 decode steps' logits (serve plan) bit-equal
    to the unplaced runs, no collective counted."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import full_tree, place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model

    cfg = get_reduced(arch)
    params = model.init_params(cfg, 0, param_dtype=torch.float32)
    batch = _family_batch(cfg, "cuda")
    loss, _, grads = value_and_grad(cfg, params, batch)
    logits = _greedy(cfg, params, batch)
    mesh = make_production_mesh(shape="1x1")
    train, serve = make_plan(mesh), make_plan(mesh, mode="serve")
    with CollectiveCounter() as counter:
        with activation_mesh(train):
            got_loss, _, got_grads = value_and_grad(cfg, place_tree(train, params), batch)
        with activation_mesh(serve):
            got_logits = _greedy(cfg, place_tree(serve, params), batch)
    assert not counter.log
    assert torch.equal(got_loss, loss) and torch.equal(got_logits, logits)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(full_tree(got_grads)),
                                                 tree_util.leaves(grads)))
