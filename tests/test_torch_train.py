"""Training on the port against the JAX package, on the CPU: the chunked
cross-entropy, ``forward_train``'s loss and gradients for the six
families, remat, and the refusal of every kernel wrapper under grad (the
kernels have no backward). The train step, fp32 masters and
``abstract_params`` are in ``tests/test_torch_train_step.py``, chunked
attention's gradients and ``causal_skip`` in
``tests/test_torch_train_attention.py``.

Same seeded numpy inputs, JAX weights carried over with
``params_from_numpy``. Tolerances: losses within 1e-5 relative; each
gradient leaf within 1e-4 of that leaf's largest magnitude: the two
frameworks sum in other orders.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stochastic_quant as sq
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
FAMILY_ARCHS = ["llama3_8b", "granite_moe_1b_a400m", "internvl2_26b", "seamless_m4t_large_v2",
                "rwkv6_7b", "zamba2_7b"]
B, S, SRC = 2, 64, 48


def _batch(cfg, seed=1, s=S):
    """A masked training batch (about a fifth of the positions masked out),
    with the family's patch embeddings or source frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32),
             "mask": (rng.random((B, s)) > 0.2).astype(np.float32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((B, SRC, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        batch["vis_embeds"] = rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_leaf_close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel:g} x {scale:.3e}"


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = jconfigs.get_reduced(arch)
    return jax.tree_util.tree_map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0)))


# ------------------------------------------------------------ cross-entropy

CE_CASES = {
    # name: (S, ce_chunk, mask)
    "masked, 3 chunks": (48, 16, "random"),
    "S not a multiple of the chunk: one chunk": (40, 16, "random"),
    "all-zero mask": (32, 16, "zeros"),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_chunked_ce_matches_jax(case):
    s, ce_chunk, mask_kind = CE_CASES[case]
    jcfg, tcfg = jconfigs.get_reduced("llama3_8b"), tconfigs.get_reduced("llama3_8b")
    params = _weights("llama3_8b")
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, s, jcfg.d_model), dtype=np.float32)
    labels = rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32)
    mask = ((rng.random((B, s)) > 0.3) if mask_kind == "random" else np.zeros((B, s))
            ).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, want_dh = jax.value_and_grad(
        lambda hh: jmodel._chunked_ce(jcfg, jp, hh, jnp.asarray(labels), jnp.asarray(mask),
                                      ce_chunk))(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tmodel._chunked_ce(tcfg, tmodel.params_from_numpy(params, "cpu"), th,
                             torch.from_numpy(labels), torch.from_numpy(mask), ce_chunk)
    (dh,) = torch.autograd.grad(got, th)
    if mask_kind == "zeros":
        assert got.item() == float(want) == 0.0
        assert not dh.any() and not np.asarray(want_dh).any()
        return
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _assert_leaf_close(dh, want_dh, GRAD_REL, "d loss / d h")


# ------------------------------------------------------------ forward_train

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    params = _weights(arch)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.forward_train(jcfg, p, b), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), _jax(batch))
    loss, metrics, grads = tsteps.value_and_grad(tcfg, tmodel.params_from_numpy(params, "cpu"),
                                                 _torch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert set(metrics) == set(jmet)
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmet[name]), rtol=LOSS_RTOL)
    assert tree_util.paths(grads) == [
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_leaves_with_path(jgrads)]
    for path, g, jg in zip(tree_util.paths(grads), tree_util.leaves(grads),
                           jax.tree_util.tree_leaves(jgrads)):
        assert g.shape == jg.shape and g.dtype == torch.float32
        _assert_leaf_close(g, jg, GRAD_REL, "/".join(path))


def _loss_and_grads(cfg, params, batch, **kw):
    loss, _, grads = tsteps.value_and_grad(cfg, params, batch, **kw)
    return loss, tree_util.leaves(grads)


def test_remat_on_off_and_save_moe_out_are_bit_equal():
    cfg = tconfigs.get_reduced("granite_moe_1b_a400m")
    params = tmodel.params_from_numpy(_weights("granite_moe_1b_a400m"), "cpu")
    batch = _torch(_batch(cfg))
    ref_loss, ref = _loss_and_grads(cfg, params, batch, remat=True)
    for kw in (dict(remat=False), dict(remat=True, remat_policy="save_moe_out")):
        loss, grads = _loss_and_grads(cfg, params, batch, **kw)
        assert torch.equal(loss, ref_loss), kw
        assert all(torch.equal(a, b) for a, b in zip(grads, ref)), kw


@pytest.mark.parametrize("arch", ["zamba2_7b", "seamless_m4t_large_v2", "rwkv6_7b"])
def test_remat_off_is_bit_equal_per_family(arch):
    cfg = tconfigs.get_reduced(arch)
    params = tmodel.params_from_numpy(_weights(arch), "cpu")
    batch = _torch(_batch(cfg))
    on = _loss_and_grads(cfg, params, batch, remat=True)
    off = _loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


# ------------------------------------------------------------ the refusals

@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors take the kernel route; building or loading a library
    fails the test, so a refusal must come before any CUDA call."""
    def no_library(name):
        raise AssertionError(f"the library {name!r} was asked for")

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", no_library)
    fa.reset_launches()
    sq.reset_launches()
    yield
    assert not any(fa.launches.values()) and not any(sq.launches.values())


def _wrapper_calls(grad: bool):
    """Each kernel wrapper's call on small valid inputs; the float inputs
    require grad when ``grad``."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 64, 4, 16), generator=g).requires_grad_(grad)
    k = torch.randn((1, 64, 2, 16), generator=g)
    x = torch.randn((2, 128), generator=g).requires_grad_(grad)
    rbits = torch.randint(0, 2**31, (2, 128), generator=g, dtype=torch.int64).to(torch.uint32)
    scale = torch.ones(1).requires_grad_(grad)
    idx = torch.randint(0, 16, (2, 128), generator=g, dtype=torch.uint8)
    signs = torch.randint(0, 2, (2, 128), generator=g, dtype=torch.uint8)
    weights = torch.full((3,), 1 / 3).requires_grad_(grad)
    return {
        "flash_attention": (lambda: fa.flash_attention(q, k, k), "chunked"),
        "quantize": (lambda: sq.quantize(x, rbits, scale, 4), "core.quantization"),
        "dequantize": (lambda: sq.dequantize(idx, signs, scale, 4), "core.quantization"),
        "aggregate": (lambda: sq.aggregate(idx[None].expand(3, 2, 128).contiguous(),
                                           signs[None].expand(3, 2, 128).contiguous(),
                                           torch.ones(3), weights, 4), "core.quantization"),
    }


@pytest.mark.parametrize("wrapper", ["flash_attention", "quantize", "dequantize", "aggregate"])
def test_wrappers_refuse_grad_before_any_library(as_if_on_the_card, wrapper):
    call, route = _wrapper_calls(grad=True)[wrapper]
    with pytest.raises(ValueError, match=rf"{wrapper}: its kernel has no backward.*{route}"):
        call()


@pytest.mark.parametrize("wrapper", ["flash_attention", "quantize", "dequantize", "aggregate"])
def test_wrappers_refuse_grad_on_the_cpu_too(wrapper):
    call, _ = _wrapper_calls(grad=True)[wrapper]
    with pytest.raises(ValueError, match="no backward"):
        call()


@pytest.mark.parametrize("wrapper", ["flash_attention", "quantize", "dequantize", "aggregate"])
def test_no_refusal_without_grad(wrapper, monkeypatch):
    # under no_grad, and for inputs that do not require grad, the wrapper
    # runs: on the CPU its plain version; as if on the card, up to the library
    for grad in (True, False):
        call, _ = _wrapper_calls(grad=grad)[wrapper]
        ctx = torch.no_grad() if grad else torch.enable_grad()
        with ctx:
            out = call()
        assert isinstance(out, (torch.Tensor, tuple))
    asked = []

    def library(name):
        asked.append(name)
        raise RuntimeError("stop before the launch")

    monkeypatch.setattr(build, "route", lambda name, *tensors: True)
    monkeypatch.setattr(build, "library", library)
    call, _ = _wrapper_calls(grad=True)[wrapper]
    with torch.no_grad(), pytest.raises(RuntimeError, match="stop before the launch"):
        call()
    assert asked


def test_forward_train_with_flash_at_its_dispatch_length_raises():
    # S = 2560 takes the flash dispatch under attn_impl="flash": no backward
    cfg = tconfig.ModelConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                              n_kv_heads=2, d_ff=128, vocab=64, chunk_size=128,
                              attn_impl="flash", dtype="float32")
    params = tmodel.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 2560), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks, "mask": torch.ones((1, 2560))}
    with pytest.raises(ValueError, match=r'flash_attention: its kernel has no backward.*'
                                         r'attn_impl="chunked"'):
        tsteps.value_and_grad(cfg, params, batch)
    # the same config trains through chunked attention, and serves through flash
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    loss, _, _ = tsteps.value_and_grad(chunked, params, batch)
    with torch.no_grad():
        served, _ = tmodel.forward_train(cfg, params, batch)
    np.testing.assert_allclose(served.item(), loss.item(), rtol=1e-5)
