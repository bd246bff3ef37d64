"""Training on the card against the CPU, and the kernel wrappers' refusal
under grad with real CUDA tensors.

The reduced six families' ``make_train_step`` (``adamw``) on the card and
on the CPU from the same weights and batches, inside
``device.exact_fp32()``: three steps, each started on both devices from the
CPU's parameters and optimizer state, so every step's loss and gradient
norm are held to 1e-5 relative (a chained run would let Adam's first step
amplify last-bit gradient differences, see ``tests/test_torch_train_step.py``).
The four wrappers refuse a call under grad before any launch; under
``no_grad`` serving's flash call and a fleet round launch as before.

Needs a CUDA device and nvcc (the libraries are built at first use); every
test here skips without a card. Run on the GPU machine with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_train.py``.
No JAX: the card's machine does not have it.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_reduced
from repro_torch.device import exact_fp32
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stochastic_quant as sq
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.optim import adamw

ARCHS = ["llama3_8b", "granite_moe_1b_a400m", "internvl2_26b", "seamless_m4t_large_v2",
         "rwkv6_7b", "zamba2_7b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test compares the card's run with the CPU's")
    return torch.device("cuda")


def _batches(cfg, n, seed=1, b=2, s=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
        batch = {"tokens": toks, "labels": toks, "mask": torch.ones((b, s))}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.as_tensor(rng.standard_normal((b, 48, cfg.d_model)),
                                                  dtype=torch.float32)
        if cfg.family == "vlm":
            batch["vis_embeds"] = torch.as_tensor(
                rng.standard_normal((b, cfg.n_vis_tokens, cfg.d_model)), dtype=torch.float32)
        out.append(batch)
    return out


def _to(tree, dev):
    return tree_util.map(lambda t: t.to(dev), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_card_equal_cpu(cuda, arch):
    cfg = get_reduced(arch)
    opt = adamw(3e-3)
    step = steps.make_train_step(cfg, opt)
    params = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    state = opt.init(params)
    fa.reset_launches()
    sq.reset_launches()
    with exact_fp32():
        for batch in _batches(cfg, 3):
            g_params, g_state, g_met = step(_to(params, cuda), _to(state, cuda), _to(batch, cuda))
            params, state, c_met = step(params, state, batch)
            assert set(g_met) == set(c_met)
            for name in c_met:
                np.testing.assert_allclose(g_met[name].item(), c_met[name].item(), rtol=1e-5,
                                           err_msg=name)
            for g, c in zip(tree_util.leaves(g_params), tree_util.leaves(params)):
                assert g.device.type == "cuda" and g.dtype == torch.float32
                assert torch.isfinite(g).all()
    assert not any(fa.launches.values()) and not any(sq.launches.values())


def _calls(dev, grad):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 128, 4, 64), generator=g, device=dev).requires_grad_(grad)
    k = torch.randn((1, 128, 2, 64), generator=g, device=dev)
    x = torch.randn((2, 128), generator=g, device=dev).requires_grad_(grad)
    rbits = torch.randint(0, 2**31, (2, 128), generator=g, device=dev,
                          dtype=torch.int64).to(torch.uint32)
    scale = torch.ones(1, device=dev).requires_grad_(grad)
    idx = torch.randint(0, 16, (3, 2, 128), generator=g, device=dev, dtype=torch.uint8)
    signs = torch.randint(0, 2, (3, 2, 128), generator=g, device=dev, dtype=torch.uint8)
    weights = torch.full((3,), 1 / 3, device=dev).requires_grad_(grad)
    return {
        "flash_attention": lambda: fa.flash_attention(q, k, k),
        "quantize": lambda: sq.quantize(x, rbits, scale, 4),
        "dequantize": lambda: sq.dequantize(idx[0], signs[0], scale, 4),
        "aggregate": lambda: sq.aggregate(idx, signs, torch.ones(3, device=dev), weights, 4),
    }


@pytest.mark.parametrize("wrapper", ["flash_attention", "quantize", "dequantize", "aggregate"])
def test_refusal_under_grad_on_the_card(cuda, wrapper):
    fa.reset_launches()
    sq.reset_launches()
    with pytest.raises(ValueError, match=f"{wrapper}: its kernel has no backward"):
        _calls(cuda, grad=True)[wrapper]()
    torch.cuda.synchronize()
    assert not any(fa.launches.values()) and not any(sq.launches.values())
    # the same inputs under no_grad launch the kernel, as before
    with torch.no_grad():
        out = _calls(cuda, grad=True)[wrapper]()
    torch.cuda.synchronize()
    counts = {**fa.launches, **sq.launches}
    assert counts[wrapper] == 1
    assert not any(t.requires_grad for t in (out if isinstance(out, tuple) else (out,)))


def test_flash_attention_without_grad_is_unchanged(cuda):
    # serving: inputs that do not require grad, grad mode on
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (0.3 * torch.randn(s, generator=g, device=cuda)
               for s in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64)))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_simt"] == 1
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v), rtol=2e-5, atol=2e-5)


def test_fleet_round_launches_aggregate_under_grad_mode(cuda):
    from repro_torch.sim import build_sim

    sim = build_sim("tiny", n_clients=8, seed=3)
    sq.reset_launches()
    assert torch.is_grad_enabled()
    res = sim.run_compiled(2)
    assert sq.launches["aggregate"] == 2
    assert torch.isfinite(sim.final_flat).all() and res.q_levels.shape == (2, 8)


def test_fl_round_card_equals_cpu(cuda):
    cfg = get_reduced("granite_moe_1b_a400m")
    params = model.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    stacked = tree_util.map(lambda t: torch.stack([t, 1.01 * t]), params)
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 64)))
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((2, 2, 64))}
    gen = torch.Generator().manual_seed(4)
    shapes = [tuple(t.shape[1:]) for t in tree_util.leaves(stacked)]
    ups = [[torch.rand(s, generator=gen) for s in shapes] for _ in range(2)]
    q, w = torch.tensor([6, 8]), torch.tensor([0.4, 0.6])
    fl_round = steps.make_fl_round(cfg, lr=1e-2, wire_packed=True, screen=True)
    with exact_fp32():
        got = fl_round(_to(stacked, cuda), _to(batch, cuda), q.to(cuda), w.to(cuda),
                       uniforms=[[u.to(cuda) for u in client] for client in ups])
        want = fl_round(stacked, batch, q, w, uniforms=ups)
    assert torch.equal(got[3].cpu(), want[3]) and got[3].item() == 0.0
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(), rtol=1e-6)
    level = float((w * want[2] / (2.0 ** q - 1)).max())
    diffs = torch.cat([(a.cpu() - b).abs().reshape(-1)
                       for a, b in zip(tree_util.leaves(got[0]), tree_util.leaves(want[0]))])
    assert diffs.max().item() <= level + 1e-5
    assert (diffs <= 1e-5).double().mean().item() >= 0.99
