"""Tensor-parallel serving on CPU ranks of a gloo group: ``prefill`` and 8
greedy ``decode_step``s under ``make_plan(mesh, mode="serve")`` on ``1x2``
and ``1x4`` meshes, the parameters placed as DTensors, for the reduced
Llama-3-8B (KV whole on every rank, GQA expanded per rank), Phi-3-medium's
head counts (H 40 / KV 10: at ``model`` 2 the KV heads split, at 4 they do
not), the reduced Granite-3.0 1B-A400M (experts on ``model``), RWKV6-7B
(WKV heads and channel-mix columns), Zamba2-7B (Mamba2 heads, the
in-projection's output gathered; the shared attention's heads),
SeamlessM4T-large-v2 (self- and cross-attention heads, every SwiGLU) and
InternVL2-26B (KV 1: GQA expanded per rank; ``vis_proj`` gathered); and
``serve.main --mesh-shape``. The recurrent families take a context of 64,
their chunked scans' length.

fp32: every step's logits within rtol 1e-5 of the unsharded ones, the
greedy tokens identical, every rank alike; the cache holds the rank's part
(:func:`_cache_heads`): KV/m heads where KV divides ``model``, else every
head; the rank's WKV or SSM heads; the carries whole.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

MESHES = {"1x2": 2, "1x4": 4}
CASES = ("llama3_8b", "phi3_h40_kv10", "granite_moe_1b_a400m", "rwkv6_7b", "zamba2_7b",
         "seamless_m4t_large_v2", "internvl2_26b")
B, CTX, NEW, SRC = 2, 40, 8, 24


def _cfg(name):
    from repro_torch.configs import get_reduced

    if name == "phi3_h40_kv10":
        return dataclasses.replace(get_reduced("phi3_medium_14b"), n_heads=40, n_kv_heads=10,
                                   head_dim=16)
    return get_reduced(name)


def _greedy(cfg, params):
    """The prefill's and each decode step's logits, the tokens, the cache."""
    from repro_torch.models import decode

    rng = np.random.default_rng(6)
    ctx = 64 if cfg.family in ("ssm", "hybrid") else CTX
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, ctx)))}
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
        ctx += cfg.n_vis_tokens
    if cfg.family == "encdec":
        batch = {"src_embeds": torch.as_tensor(
            rng.standard_normal((B, SRC, cfg.d_model), dtype=np.float32))}
    logits, cache = decode.prefill(cfg, params, batch, ctx + NEW)
    steps, out = [logits], [torch.argmax(logits, -1)]
    for _ in range(NEW):
        logits, cache = decode.decode_step(cfg, params, cache, out[-1])
        steps.append(logits)
        out.append(torch.argmax(logits, -1))
    return steps, torch.stack(out, 1), cache


def _serve_rank(rank, world, out_dir, mesh_shape):
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model

    plan = make_plan(make_production_mesh(shape=mesh_shape, device="cpu"), mode="serve")
    res = {}
    for name in CASES:
        cfg = _cfg(name)
        placed = place_tree(plan, model.init_params(cfg, 0, device="cpu"))
        with activation_mesh(plan):
            res[name] = _greedy(cfg, placed)
    res["main"] = serve.main(["--arch", "llama3_8b", "--batch", "2", "--context", "24",
                              "--new-tokens", "4", "--mesh-shape", mesh_shape],
                             device="cpu").tokens
    with open(os.path.join(out_dir, f"{mesh_shape}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import serve
    from repro_torch.models import model
    from torch_replay import join_all

    out = tmp_path_factory.mktemp("serve_tp")
    worlds = [spawn_gloo(_serve_rank, n, out, str(out), m, join=False)
              for m, n in MESHES.items()]
    refs = {name: _greedy(_cfg(name), model.init_params(_cfg(name), 0, device="cpu"))
            for name in CASES}
    refs["main"] = serve.main(["--arch", "llama3_8b", "--batch", "2", "--context", "24",
                               "--new-tokens", "4"], device="cpu").tokens
    join_all(*worlds)
    ranks = {}
    for m, n in MESHES.items():
        for r in range(n):
            with open(out / f"{m}_rank{r}.pkl", "rb") as f:
                ranks[m, r] = pickle.load(f)
    return ranks, refs


def _cache_heads(cfg, m):
    """The head counts a rank's cache holds, by key and dim: KV heads where
    they divide ``model``, the recurrent states' heads (every reduced count
    divides 2 and 4), the carries whole."""
    kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else cfg.n_kv_heads
    if cfg.family == "ssm":
        return {("s", 2): cfg.rwkv_heads // m, ("x_tm", 2): cfg.d_model,
                ("x_cm", 2): cfg.d_model}
    if cfg.family == "hybrid":
        return {("k", 3): kv, ("v", 3): kv, ("ssm", 2): cfg.n_ssm_heads // m,
                ("conv", 3): cfg.d_inner + 2 * cfg.ssm_state}
    out = {("k", 3): kv, ("v", 3): kv}
    if cfg.family == "encdec":
        out.update({("mem_k", 3): kv, ("mem_v", 3): kv})
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_unsharded(runs, mesh, case):
    ranks, refs = runs
    want_steps, want_tokens, want_cache = refs[case]
    cfg = _cfg(case)
    m = MESHES[mesh]
    for r in range(m):
        steps, tokens, cache = ranks[mesh, r][case]
        assert torch.equal(tokens, want_tokens)
        for got, want in zip(steps, want_steps):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        assert cache["pos"] == want_cache["pos"]
        for (key, dim), n in _cache_heads(cfg, m).items():
            assert cache[key].shape[dim] == n, (key, cache[key].shape, n)
    for r in range(1, m):
        assert all(torch.equal(a, b) for a, b in zip(ranks[mesh, r][case][0],
                                                     ranks[mesh, 0][case][0]))


@pytest.mark.parametrize("mesh", MESHES)
def test_serve_main_mesh_shape(runs, mesh):
    ranks, refs = runs
    for r in range(MESHES[mesh]):
        assert torch.equal(ranks[mesh, r]["main"], refs["main"])
