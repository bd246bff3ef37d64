"""The port's moe, vlm, encdec, ssm and hybrid serving paths against
``src/repro/``.

The reduced Granite-3.0 1B-A400M and Grok-1 (moe), InternVL2-26B (vlm),
SeamlessM4T-large-v2 (encdec), RWKV6-7B (ssm) and Zamba2-7B (hybrid)
configs: the JAX package's own weights (``params_from_numpy`` of its
``init_params``), the same numpy context, patch embeddings and source
frames through both. The recurrent families run two contexts: 80 (their
sequential scans; it wraps the reduced Zamba2's 64-slot ring) and 128 (a
multiple of 64: the chunked WKV and SSD). Tolerances are those of
``tests/test_torch_transformer.py``: logits within rtol 1e-5, atol 2e-5;
caches (recurrent states, conv carries and K/V rings too) within rtol =
atol = 1e-5; greedy tokens identical.
"""
import dataclasses
import functools
import importlib.util
import re
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import save_checkpoint
from repro.launch import serve as jserve
from repro.models import config as jconfig
from repro.models import decode as jdecode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_util
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve
from repro_torch.models import config as tconfig
from repro_torch.models import decode as tdecode
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from torch_replay import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-5, atol=2e-5)
ARCHS = ["granite_moe_1b_a400m", "grok_1_314b", "internvl2_26b", "seamless_m4t_large_v2",
         "rwkv6_7b", "zamba2_7b"]
CONTEXT, CHUNKED_CONTEXT, SRC_LEN, STEPS = 80, 128, 48, 4
# (arch, context): every arch at CONTEXT, the recurrent ones also at a
# context their chunked scans take
CASES = [(a, CONTEXT) for a in ARCHS] + [("rwkv6_7b", CHUNKED_CONTEXT),
                                         ("zamba2_7b", CHUNKED_CONTEXT)]
CASE_IDS = [a if c == CONTEXT else f"{a}-context{c}" for a, c in CASES]
# the leaves a bf16 init_params keeps in fp32, per family (else "scale" only)
FP32_LEAVES = {"ssm": {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "wa", "wb", "u", "scale",
                       "bias"},
               "hybrid": {"a_log", "d_skip", "dt_bias", "scale"}}
ROOT = Path(__file__).resolve().parents[1]


def _inputs(cfg, context: int, seed: int = 1) -> dict:
    """numpy context tokens (B=2), and the family's patch embeddings or
    source frames, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, context)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vis_embeds"] = rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "encdec":
        batch["tokens"] = batch["tokens"][:, :12]          # a short target for forward_logits
        batch["src_embeds"] = rng.standard_normal((2, SRC_LEN, cfg.d_model), dtype=np.float32)
    return batch


def _seq_len(cfg, context: int) -> int:
    """Every position the prefill and STEPS decode steps write (generate's)."""
    if cfg.family == "encdec":
        return 1 + STEPS
    return cfg.n_vis_tokens + context + STEPS


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def _prefill_batch(cfg, batch: dict) -> dict:
    return {k: v for k, v in batch.items() if not (cfg.family == "encdec" and k == "tokens")}


@functools.lru_cache(maxsize=None)
def _reference(arch: str, context: int = CONTEXT):
    """The JAX package's weights, inputs, forward logits, and its prefill
    + greedy decode: the logits and cache after each step, and the tokens."""
    cfg = jconfigs.get_reduced(arch)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    batch = _inputs(cfg, context)
    fwd = np.asarray(jmodel.forward_logits(cfg, params, _jax(batch)))
    logits, cache = jdecode.prefill(cfg, params, _jax(_prefill_batch(cfg, batch)),
                                    _seq_len(cfg, context))
    trace = [(np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache))]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    tokens = [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = jdecode.decode_step(cfg, params, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        trace.append((np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache)))
        tokens.append(np.asarray(tok))
    return (jax.tree_util.tree_map(np.asarray, params), batch, fwd, trace,
            np.stack(tokens, axis=1))


def _check_cache(got: dict, want: dict):
    # k/v rings, cross k/v, recurrent states and carries: fp32 in the reduced configs
    assert set(got) == set(want)
    for name in set(want) - {"slot_pos", "pos"}:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), want[name], **F32)
    if "slot_pos" in want:
        assert np.array_equal(got["slot_pos"].numpy(), want["slot_pos"])
    assert got["pos"] == int(want["pos"])


# ------------------------------------------------------------ parameters

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS + ["llama3_8b"])
def test_uncounted_params_match_the_jax_init(arch):
    # chip_smoke holds the full-size models' parameter counts to
    # param_count() + param_count_correction(cfg) (negative for ssm): the
    # JAX package's init on the reduced configs has exactly that many
    cfg = jconfigs.get_reduced(arch)
    shapes = jax.eval_shape(lambda: jmodel.init_params(cfg, jax.random.PRNGKey(0)))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert n == cfg.param_count() + _chip_smoke().param_count_correction(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_shapes_and_dtypes(arch):
    want = jax.eval_shape(lambda: jmodel.init_params(jconfigs.get_reduced(arch),
                                                     jax.random.PRNGKey(0)))
    cfg = tconfigs.get_reduced(arch)
    p32 = tmodel.init_params(cfg, 3, device="cpu")
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), p32)
            == jax.tree_util.tree_map(lambda s: tuple(s.shape), want))
    # a bf16 config holds the same draws cast once; norm scales (and the
    # recurrent families' fp32 vectors) stay fp32
    p16 = tmodel.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3, device="cpu")
    fp32 = FP32_LEAVES.get(cfg.family, {"scale"})
    for path, a, b in zip(tree_util.paths(p32), tree_util.leaves(p32), tree_util.leaves(p16)):
        if path[-1] in fp32:
            assert b.dtype == torch.float32 and torch.equal(a, b)
        else:
            assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_tree(arch):
    params = _reference(arch)[0]
    tp = tmodel.params_from_numpy(params, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(tree_util.leaves(tp))
    for (path, want), key, got in zip(flat, tree_util.paths(tp), tree_util.leaves(tp)):
        assert tuple(p.key for p in path) == key
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("arch,context", CASES, ids=CASE_IDS)
def test_forward_logits_match(arch, context):
    params, batch, fwd, _trace, _tokens = _reference(arch, context)
    cfg = tconfigs.get_reduced(arch)
    got = tmodel.forward_logits(cfg, tmodel.params_from_numpy(params, "cpu"), _torch(batch))
    np.testing.assert_allclose(got.numpy(), fwd, **LOGITS)


@pytest.mark.parametrize("arch,context", CASES, ids=CASE_IDS)
def test_prefill_and_decode_steps_match(arch, context):
    params, batch, _fwd, trace, tokens = _reference(arch, context)
    cfg = tconfigs.get_reduced(arch)
    tp = tmodel.params_from_numpy(params, "cpu")
    logits, cache = tdecode.prefill(cfg, tp, _torch(_prefill_batch(cfg, batch)),
                                    _seq_len(cfg, context))
    np.testing.assert_allclose(logits.numpy(), trace[0][0], **LOGITS)
    _check_cache(cache, trace[0][1])
    for step, (want_logits, want_cache) in enumerate(trace[1:]):
        tok = torch.from_numpy(tokens[:, step]).long()
        logits, cache = tdecode.decode_step(cfg, tp, cache, tok)
        np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
        _check_cache(cache, want_cache)


@pytest.mark.parametrize("arch,context", CASES, ids=CASE_IDS)
def test_generate_matches_greedy_decode(arch, context):
    params, batch, _fwd, trace, tokens = _reference(arch, context)
    cfg = tconfigs.get_reduced(arch)
    extra = {"vlm": "vis_embeds", "encdec": "src_embeds"}.get(cfg.family)
    gen = serve.generate(cfg, tmodel.params_from_numpy(params, "cpu"),
                         None if cfg.family == "encdec" else batch["tokens"], STEPS,
                         device="cpu", **({extra: batch[extra]} if extra else {}))
    assert np.array_equal(gen.tokens.numpy(), tokens)
    np.testing.assert_allclose(gen.logits.numpy(), trace[-1][0], **LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches(arch):
    want = jdecode.cache_spec(jconfigs.get_reduced(arch), 3, 40, src_len=24)
    got = tdecode.cache_spec(tconfigs.get_reduced(arch), 3, 40, src_len=24)
    assert set(got) == set(want)
    for name, spec in want.items():
        if name == "pos":
            assert got["pos"] == 0 and spec.shape == ()
            continue
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == spec.shape
        assert str(got[name].dtype).removeprefix("torch.") == spec.dtype.name
    cfg = tconfigs.get_reduced(arch)
    if cfg.family == "encdec":
        cache = tdecode.init_cache(cfg, 3, 40, device="cpu")
        assert cache["mem_k"] is None and cache["mem_v"] is None
        with pytest.raises(ValueError, match="encode"):
            tdecode.decode_step(cfg, tmodel.init_params(cfg, device="cpu"), cache,
                                torch.zeros(3, dtype=torch.int64))


def test_bf16_moe_forward_logits_match():
    # the reduced Granite in bf16: the routing and the experts in bf16, the
    # router's logits fp32 products; logits within a few bf16 ulps of |logit|
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite_moe_1b_a400m"), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite_moe_1b_a400m"), dtype="bfloat16")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    ctx = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 24))
    want = np.asarray(jmodel.forward_logits(jcfg, params, {"tokens": jnp.asarray(ctx)}))
    got = tmodel.forward_logits(
        tcfg, tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        {"tokens": torch.from_numpy(ctx)}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2**-8 * np.abs(want).max())


def test_granite_width_routing_matches():
    # Granite's width (d_model 1024, 32 experts top-8, capacity 1.25) at two
    # layers and one 512-token chunk: the port's aux values equal JAX's on
    # its weights. At random init the second layer's routing concentrates
    # on a few experts and drops a third of the slots in both packages (the
    # full-size prefill on the card drops more; PERF.md §6, PR 19)
    over = dict(n_layers=2, vocab=512, dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_config("granite_moe_1b_a400m"), **over)
    tcfg = dataclasses.replace(tconfigs.get_config("granite_moe_1b_a400m"), **over)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    ctx = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 512))
    _, want = jmodel._forward_dense(jcfg, params, jlayers.embed(
        params["embed"], jnp.asarray(ctx), jnp.float32), remat=False)
    tp = tmodel.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    _, got = tmodel._forward_dense(tcfg, tp, tlayers.embed(
        tp["embed"], torch.from_numpy(ctx), torch.float32))
    assert set(got) == set(want)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(got[name].item(), float(want[name]), **F32)
    assert got["dropped_frac"].item() == float(want["dropped_frac"]) > 0.25


@pytest.mark.parametrize("family", ["moe", "vlm", "encdec", "hybrid", "ssm"])
def test_flash_dispatch_per_family(family):
    # S = 2560 > DENSE_ATTN_MAX_SEQ and a multiple of chunk_size: each
    # family's attention takes the flash path (JAX: its XLA twin; here the
    # wrapper, on the CPU its plain version); the encoder without a mask,
    # the moe routing in five 512-token chunks, the hybrid's shared
    # attention at its default window (4096, no sliding_window set) after a
    # chunked SSD; the ssm family has no attention and never calls it
    base = dict(name="t", family=family, n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=64, chunk_size=128, attn_impl="flash", dtype="float32")
    base.update({"moe": dict(n_experts=4, top_k=2), "vlm": dict(n_vis_tokens=8),
                 "encdec": dict(n_enc_layers=1),
                 "hybrid": dict(ssm_state=16, ssm_head_dim=32, attn_every=1),
                 "ssm": dict(n_heads=0, n_kv_heads=0, rwkv_heads=4)}[family])
    jcfg, tcfg = jconfig.ModelConfig(**base), tconfig.ModelConfig(**base)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    n_tok = {"vlm": 2552, "encdec": 4}.get(family, 2560)
    batch = {"tokens": rng.integers(0, 64, (1, n_tok)).astype(np.int32)}
    if family == "vlm":
        batch["vis_embeds"] = rng.standard_normal((1, 8, 64), dtype=np.float32)
    if family == "encdec":
        batch["src_embeds"] = rng.standard_normal((1, 2560, 64), dtype=np.float32)
    want = np.asarray(jmodel.forward_logits(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                                            _jax(batch)))
    with mock.patch.object(tfa, "flash_attention", wraps=tfa.flash_attention) as spy:
        got = tmodel.forward_logits(tcfg, tmodel.params_from_numpy(params, "cpu"),
                                    _torch(batch))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)
    if family == "ssm":
        assert spy.call_count == 0
        return
    assert spy.call_count == 1
    assert spy.call_args.kwargs == dict(causal=family != "encdec",
                                        window=4096 if family == "hybrid" else 0, q_offset=0)
    assert tuple(spy.call_args.args[0].shape) == (1, 2560, 4, 16)


# ------------------------------------------------------------ the launcher

def _printed_tokens(out: str) -> np.ndarray:
    rows = [re.sub(r"np\.\w+\((-?\d+)\)", r"\1", line.split(":", 1)[1])
            for line in out.splitlines() if re.match(r"req\d+: ", line)]
    return np.array([eval(r.strip()) for r in rows])  # noqa: S307 (lists of ints)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "granite_moe_1b_a400m",
                                  "rwkv6_7b", "zamba2_7b"])
def test_serve_main_prints_the_jax_launchers_tokens(arch, tmp_path, capsys, monkeypatch):
    # the JAX launcher's weights through a checkpoint; for encdec its own
    # branch: encode of --context normal frames, greedy decode from BOS = 0
    save_checkpoint(str(tmp_path), 1,
                    jmodel.init_params(jconfigs.get_reduced(arch), jax.random.PRNGKey(4)))
    argv = ["--arch", arch, "--batch", "2", "--context", "24", "--new-tokens", "5",
            "--seed", "3", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = _printed_tokens(capsys.readouterr().out)
    gen = serve.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert want.shape == (2, 6)
    np.testing.assert_array_equal(_printed_tokens(out), want)
    np.testing.assert_array_equal(gen.tokens.numpy(), want)
    if arch.startswith("seamless"):
        assert (want[:, 0] == 0).all() and "encode of 2 x 24 source frames" in out


def test_serve_main_refuses_the_vlm_family():
    with pytest.raises(ValueError, match="vis_embeds"):
        serve.main(["--arch", "internvl2_26b"], device="cpu")
    # the JAX launcher fails on the same flags (no patch embeddings drawn)
    with mock.patch.object(sys, "argv", ["serve", "--arch", "internvl2_26b", "--batch", "1",
                                         "--context", "4", "--new-tokens", "1"]):
        with pytest.raises(KeyError, match="vis_embeds"):
            jserve.main()


def test_generate_refuses_inputs_the_family_does_not_take():
    tok = np.zeros((1, 4), np.int64)
    emb = np.zeros((1, 3, 256), np.float32)
    cases = [("internvl2_26b", tok, {}, "takes vis_embeds"),
             ("internvl2_26b", tok, {"src_embeds": emb, "vis_embeds": emb}, "not take src"),
             ("granite_moe_1b_a400m", tok, {"vis_embeds": emb}, "not take vis"),
             ("seamless_m4t_large_v2", None, {}, "takes src_embeds"),
             ("seamless_m4t_large_v2", tok, {"src_embeds": emb}, "ctx_tokens=None"),
             ("internvl2_26b", tok, {"vis_embeds": emb[:, :, :8]}, r"\(B, n, 256\)")]
    for arch, ctx, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            serve.generate(tconfigs.get_reduced(arch), {}, ctx, 1, device="cpu", **kw)


def test_new_families_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA guard cannot be exercised")
    for arch in ARCHS:
        cfg = tconfigs.get_reduced(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.init_params(cfg, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdecode.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(tconfigs.get_reduced("seamless_m4t_large_v2"), {}, None, 1,
                       src_embeds=np.zeros((1, 3, 256), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "seamless_m4t_large_v2", "--new-tokens", "1"])
