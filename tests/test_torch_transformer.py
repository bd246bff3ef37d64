"""The port's dense transformer serving slice against ``src/repro/``.

Same numpy inputs and the JAX package's own weights (``params_from_numpy``
of its ``init_params``) through both. Tolerances:

* fp32: layers within rtol = atol = 1e-5; logits of the reduced configs
  (2 layers, |logit| < 3) within atol 2e-5 (sums of 256-512 fp32 products
  taken in another order), greedy tokens equal;
* bf16: each layer's result within rtol 2^-6 and an atol of 2^-6 of the
  output's largest magnitude (a few bf16 ulps at that scale). torch rounds
  every op's result to bf16, while XLA on the CPU keeps excess precision
  across fused bf16 ops, so the two round in different places; a sum that
  cancels (SwiGLU's down projection) turns those ulps into large relative
  errors on its small outputs, hence the scale-relative atol.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jconfig
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve
from repro_torch.models import config as tconfig
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=2e-5)
DENSE_ARCHS = ["llama3_8b", "yi_6b", "starcoder2_7b", "phi3_medium_14b"]


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _close(got, want, dtype, f32=F32):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **f32)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-6, atol=2**-6 * np.abs(want).max())


def _pair(rng, shape, dtype="float32", scale=1.0):
    """The same draws as a JAX and a torch array of ``dtype``."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_registry_matches(arch):
    for get in ("get_config", "get_reduced"):
        jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        for prop in ("hd", "d_inner", "n_ssm_heads"):
            assert getattr(jc, prop) == getattr(tc, prop)
        assert jc.param_count() == tc.param_count()
        assert jc.active_param_count() == tc.active_param_count()
        assert jc.effective_cache_len(100_000) == tc.effective_cache_len(100_000)
        assert jc.activation_dtype.name == str(tc.activation_dtype).removeprefix("torch.")
    assert (dataclasses.asdict(jconfigs.long_context_variant(jconfigs.get_config(arch)))
            == dataclasses.asdict(tconfigs.long_context_variant(tconfigs.get_config(arch))))


def test_registry_lists_and_input_shapes_match():
    assert jconfigs.ARCH_IDS == tconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in jconfig.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in tconfig.INPUT_SHAPES.items()}


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 64), dtype)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-5),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5), dtype)
    _close(tlayers.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                             tx),
           jlayers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0, 5000000.0])
def test_rope_matches(dtype, theta):
    # positions past 4096 make the angles large: a last-ulp difference in
    # theta ** (2i / hd) (fp32 pow in both) shows up here first
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 7, 4, 64), dtype)
    pos = np.array([0, 1, 2, 511, 2048, 4095, 8191], np.int32)
    np.testing.assert_allclose(
        _np(tlayers.rope_freqs(64, theta)), np.asarray(jlayers.rope_freqs(64, theta)),
        rtol=1e-6, atol=0)
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), theta),
           jlayers.apply_rope(jx, jnp.asarray(pos), theta), dtype, dict(rtol=1e-5, atol=1e-4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_dense_attention_matches(dtype, causal, window):
    rng = np.random.default_rng(2)
    jq, tq = _pair(rng, (2, 12, 4, 16), dtype, 0.5)
    jk, tk = _pair(rng, (2, 12, 2, 16), dtype, 0.5)
    jv, tv = _pair(rng, (2, 12, 2, 16), dtype, 0.5)
    _close(tlayers.dense_attention(tq, tk, tv, causal=causal, window=window),
           jlayers.dense_attention(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal_skip,window", [(False, 0), (True, 0), (True, 100), (False, 100)])
def test_chunked_attention_matches(dtype, causal_skip, window):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (1, 256, 4, 16), dtype, 0.5)
    jk, tk = _pair(rng, (1, 256, 2, 16), dtype, 0.5)
    jv, tv = _pair(rng, (1, 256, 2, 16), dtype, 0.5)
    kw = dict(chunk=64, causal=True, window=window, causal_skip=causal_skip)
    _close(tlayers.chunked_attention(tq, tk, tv, **kw),
           jlayers.chunked_attention(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches(dtype):
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 1, 4, 16), dtype, 0.5)
    jk, tk = _pair(rng, (2, 9, 2, 16), dtype, 0.5)
    jv, tv = _pair(rng, (2, 9, 2, 16), dtype, 0.5)
    slots = np.array([3, 4, 5, -1, -1, 0, 1, 2, -1], np.int32)   # a ring with empty slots
    _close(tlayers.decode_attention(tq, tk, tv, torch.from_numpy(slots)),
           jlayers.decode_attention(jq, jk, jv, jnp.asarray(slots)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_and_embedding_match(dtype):
    rng = np.random.default_rng(5)
    w = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wg", (32, 48)), ("wu", (32, 48)), ("wd", (48, 32)))}
    table = (0.1 * rng.standard_normal((40, 32))).astype(np.float32)
    jx, tx = _pair(rng, (2, 3, 32), dtype)
    _close(tlayers.swiglu({n: torch.from_numpy(a) for n, a in w.items()}, tx),
           jlayers.swiglu({n: jnp.asarray(a) for n, a in w.items()}, jx), dtype)
    tokens = rng.integers(0, 40, (2, 3))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert np.array_equal(
        _np(tlayers.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tokens), tdt)),
        _np(jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens), jdt)))
    _close(tlayers.unembed({"table": torch.from_numpy(table)}, tx),
           jlayers.unembed({"table": jnp.asarray(table)}, jx), "float32")
    k = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    assert np.array_equal(_np(tlayers._expand_kv(torch.from_numpy(k), 6)),
                          np.asarray(jlayers._expand_kv(jnp.asarray(k), 6)))


# ------------------------------------------------------------ parameters

def test_init_params_shapes_and_serving_dtype():
    cfg = tconfigs.get_reduced("llama3_8b")
    want = jax.eval_shape(lambda: jmodel.init_params(jconfigs.get_reduced("llama3_8b"),
                                                     jax.random.PRNGKey(0)))
    p32 = tmodel.init_params(cfg, 3, device="cpu")
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), p32)
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    wq = p32["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - 0.02 * 0.8796) < 1e-3 and wq.abs().max().item() <= 0.04
    # a bf16 config holds the same draws cast once; norm scales stay fp32
    p16 = tmodel.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3, device="cpu")
    flat32 = dict(jax.tree_util.tree_flatten_with_path(p32)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(p16)[0]:
        if "scale" in jax.tree_util.keystr(path):
            assert leaf.dtype == torch.float32 and torch.equal(leaf, flat32[path])
        else:
            assert leaf.dtype == torch.bfloat16
            assert torch.equal(leaf, flat32[path].to(torch.bfloat16))


def test_every_family_is_served_and_an_unknown_one_raises():
    # the port's families are the JAX package's (every config's family,
    # tests/test_torch_families.py serves each); an unknown one raises in
    # init_params, as in the JAX package
    assert set(tmodel.FAMILIES) == {c.family for c in jconfigs.all_configs().values()}
    bogus = dataclasses.replace(tconfigs.get_reduced("llama3_8b"), family="bogus")
    with pytest.raises(ValueError, match="unknown family bogus"):
        tmodel.init_params(bogus, device="cpu")
    with pytest.raises(ValueError, match="unknown family bogus"):
        jmodel.init_params(dataclasses.replace(jconfigs.get_reduced("llama3_8b"),
                                               family="bogus"), jax.random.PRNGKey(0))


# ------------------------------------------------------------ serving

@functools.lru_cache(maxsize=None)
def _reference(arch: str, context: int = 80, steps: int = 4):
    """The JAX package's weights, a context, and its prefill + greedy
    decode: last logits and cache after each step, and the tokens."""
    cfg = jconfigs.get_reduced(arch)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    ctx = np.random.default_rng(1).integers(0, cfg.vocab, (2, context)).astype(np.int32)
    fwd = np.asarray(jmodel.forward_logits(cfg, params, {"tokens": jnp.asarray(ctx)}))
    logits, cache = jdecode.prefill(cfg, params, {"tokens": jnp.asarray(ctx)}, context + steps)
    trace = [(np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache))]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    tokens = [np.asarray(tok)]
    for _ in range(steps):
        logits, cache = jdecode.decode_step(cfg, params, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        trace.append((np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache)))
        tokens.append(np.asarray(tok))
    return (jax.tree_util.tree_map(np.asarray, params), ctx, fwd, trace,
            np.stack(tokens, axis=1))


def _check_cache(got: dict, want: dict):
    np.testing.assert_allclose(got["k"].numpy(), want["k"], **F32)
    np.testing.assert_allclose(got["v"].numpy(), want["v"], **F32)
    assert np.array_equal(got["slot_pos"].numpy(), want["slot_pos"])
    assert got["pos"] == int(want["pos"])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match(arch):
    params, ctx, fwd, _trace, _tokens = _reference(arch)
    cfg = tconfigs.get_reduced(arch)
    got = tmodel.forward_logits(cfg, tmodel.params_from_numpy(params, "cpu"),
                                {"tokens": torch.from_numpy(ctx).long()})
    np.testing.assert_allclose(got.numpy(), fwd, **LOGITS)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_steps_match(arch):
    # context 80 + 4 steps; starcoder2's reduced window (64) makes the
    # prefill's ring write wrap and the decode steps overwrite old slots
    params, ctx, _fwd, trace, tokens = _reference(arch)
    cfg = tconfigs.get_reduced(arch)
    tp = tmodel.params_from_numpy(params, "cpu")
    logits, cache = tdecode.prefill(cfg, tp, {"tokens": torch.from_numpy(ctx).long()},
                                    ctx.shape[1] + 4)
    np.testing.assert_allclose(logits.numpy(), trace[0][0], **LOGITS)
    _check_cache(cache, trace[0][1])
    for step, (want_logits, want_cache) in enumerate(trace[1:]):
        tok = torch.from_numpy(tokens[:, step]).long()
        logits, cache = tdecode.decode_step(cfg, tp, cache, tok)
        np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
        _check_cache(cache, want_cache)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_generate_matches_greedy_decode(arch):
    params, ctx, _fwd, trace, tokens = _reference(arch)
    cfg = tconfigs.get_reduced(arch)
    gen = serve.generate(cfg, tmodel.params_from_numpy(params, "cpu"), ctx, 4, device="cpu")
    assert np.array_equal(gen.tokens.numpy(), tokens)
    np.testing.assert_allclose(gen.logits.numpy(), trace[-1][0], **LOGITS)
    assert gen.prefill_seconds > 0 and gen.decode_seconds > 0


def test_bf16_forward_logits_match():
    # the reduced llama in bf16: activations round at every layer in both
    # frameworks; the fp32 logits stay within a few bf16 ulps of |logit|
    jcfg = dataclasses.replace(jconfigs.get_reduced("llama3_8b"), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced("llama3_8b"), dtype="bfloat16")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    ctx = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 24))
    want = np.asarray(jmodel.forward_logits(jcfg, params, {"tokens": jnp.asarray(ctx)}))
    got = tmodel.forward_logits(
        tcfg, tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(ctx)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2**-8 * np.abs(want).max())


@pytest.mark.parametrize("window", [0, 384])
def test_flash_dispatch_matches(window):
    # S = 2560 > DENSE_ATTN_MAX_SEQ and a multiple of chunk_size: the flash
    # path (JAX: its XLA twin; here: the wrapper, on the CPU its plain version)
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=64, chunk_size=128, attn_impl="flash", sliding_window=window)
    jcfg, tcfg = jconfig.ModelConfig(**base), tconfig.ModelConfig(**base)
    lp = jax.tree_util.tree_map(
        lambda a: np.asarray(a[0]), jmodel.init_params(jcfg, jax.random.PRNGKey(0))["layers"])
    x = (0.1 * np.random.default_rng(1).standard_normal((1, 2560, 64))).astype(np.float32)
    want, _, _ = jmodel._self_attention(
        jcfg, jax.tree_util.tree_map(jnp.asarray, lp["attn"]), jnp.asarray(x),
        causal=True, positions=jnp.arange(2560))
    with mock.patch.object(tfa, "flash_attention", wraps=tfa.flash_attention) as spy:
        got, _, _ = tmodel._self_attention(
            tcfg, tmodel.params_from_numpy(lp["attn"], "cpu"), torch.from_numpy(x),
            causal=True, positions=torch.arange(2560))
    assert spy.call_count == 1
    assert spy.call_args.kwargs == dict(causal=True, window=window, q_offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_serve_main_runs_on_the_cpu(capsys, tmp_path):
    gen = serve.main(["--arch", "yi_6b", "--batch", "2", "--context", "12",
                      "--new-tokens", "3"], device="cpu")
    assert tuple(gen.tokens.shape) == (2, 4)
    assert bool(torch.isfinite(gen.logits).all())
    assert "tokens x 2 requests" in capsys.readouterr().out
    # --ckpt-dir is served (tests/test_torch_serve_ckpt.py); an empty
    # directory has no checkpoint to restore, as in the JAX launcher
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        serve.main(["--ckpt-dir", str(tmp_path)], device="cpu")
