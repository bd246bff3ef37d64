"""Sequence-parallel forward and prefill of the port on 4 CPU ranks of a
gloo group (a ``(1, 1, 4, 1)`` mesh, ``activation_mesh`` of its serve
plan), against the JAX package's ``forward_logits`` under
``activation_mesh`` of the same mesh shape on 4 forced host devices (a
subprocess) and against the port's unsharded forward:

  * the ring: the reduced Llama-3-8B and StarCoder2-7B (sliding window)
    with ``attn_impl="flash"`` at S = 4,096;
  * the other families: the reduced Granite-3.0 1B-A400M (S = 2,048: one
    512-token routing group a shard, K/V gathered over ``seq``),
    InternVL2-26B (8 patch positions and 20 tokens: 7 positions a shard,
    the prefix across shards 0 and 1), RWKV6-7B and Zamba2-7B (S = 256:
    one scan chunk a shard, the halos and the state fold; Zamba2's shared
    attention gathered, window 64), and SeamlessM4T-large-v2 with
    ``attn_impl="flash"`` at 4,096 source frames (the encoder's non-causal
    ring, 1,024 frames a shard) and 512 target tokens (128 a shard, K/V
    gathered; cross-attention over the memory gathered over ``seq``);

each with the prefill's cache and logits and the greedy tokens against the
unsharded ones. The gathered paths (the reduced Llama at 1,024
positions, with chunked attention, and at a length off the ring's
chunks; RWKV6 and Zamba2 with their heads on ``model`` 2 beside ``seq``
2: the fold on the rank's heads; Seamless at 256 source frames, its
encoder's K/V gathered, and at 256 frames with a 30-token target that
does not divide over ``seq``: the target whole on every rank; the reduced
Granite at 1,024 positions, each 512-token routing group across two
shards), against the unsharded forward; and the refusal that stays (a
recurrent shard off its scan's chunk).
Tolerance: 1e-5 relative and absolute, greedy tokens equal.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import model as tmodel
from torch_replay import one_torch_thread, spawn_gloo  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3_8b", "starcoder2_7b")
SEAMLESS = "seamless_m4t_large_v2"
# the other families on the same mesh: context length (text tokens) each;
# Seamless's source frames and target tokens
FAMILIES = {"granite_moe_1b_a400m": 2048, "internvl2_26b": 20, "rwkv6_7b": 256,
            "zamba2_7b": 256, SEAMLESS: (4096, 512)}
FLASH = ARCHS + (SEAMLESS,)
S, B, NEW = 4096, 2, 3

# the JAX forward on the port's weights (the same tree, leaf for leaf)
_JAX_FORWARD = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.dist.activations import activation_mesh
from repro.dist.plan import make_plan
from repro.models import forward_logits
out_dir = sys.argv[1]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 4, 1), ("pod", "data", "seq", "model"))
for arch in sys.argv[2:]:
    name, flash = arch.split(":")
    cfg = get_reduced(name)
    if flash == "flash":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    data = dict(np.load(f"{out_dir}/{name}.npz"))
    params, batch = {}, {}
    for key, arr in data.items():
        if key in ("tokens", "vis_embeds", "src_embeds"):
            batch[key] = jnp.asarray(arr)
            continue
        node = params
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    fwd = jax.jit(lambda p, b: forward_logits(cfg, p, b))
    with activation_mesh(make_plan(mesh, mode="serve")):
        logits = np.asarray(fwd(params, batch))
    np.save(f"{out_dir}/{name}_logits.npy", logits)
print("JAX-SEQ-OK")
"""


def _inputs(arch):
    """The reduced ``arch`` (flash attention for the ring cases), its fp32
    weights from seed 0 and a (B, S) context (the vlm family's patch
    embeddings beside it; the encdec family's (B, S_src, d) source frames
    and (B, T) target)."""
    cfg = get_reduced(arch)
    if arch in FLASH:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    params = tmodel.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        return cfg, params, _encdec_batch(cfg, *FAMILIES[arch], rng)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, FAMILIES.get(arch, S))))}
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32))
    return cfg, params, batch


def _encdec_batch(cfg, s_src, t, rng, rows=B):
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (rows, t))),
            "src_embeds": torch.as_tensor(
                rng.standard_normal((rows, s_src, cfg.d_model), dtype=np.float32))}


def _context(cfg, batch):
    """What ``prefill`` and ``generate`` take: the context, or for encdec
    the source frames alone (decoding starts from BOS)."""
    if cfg.family == "encdec":
        return {"src_embeds": batch["src_embeds"]}
    return batch


def _save(path, params, batch):
    from repro_torch import tree as tree_util

    flat = {"/".join(p): t.numpy() for p, t in zip(tree_util.paths(params),
                                                   tree_util.leaves(params))}
    np.savez(path, tokens=batch["tokens"].numpy().astype(np.int32),
             **{k: v.numpy() for k, v in batch.items() if k != "tokens"}, **flat)


def _generate(cfg, params, batch):
    from repro_torch.launch import serve

    if cfg.family == "encdec":
        return serve.generate(cfg, params, None, NEW, device="cpu",
                              src_embeds=batch["src_embeds"]).tokens
    return serve.generate(cfg, params, batch["tokens"], NEW, device="cpu",
                          vis_embeds=batch.get("vis_embeds")).tokens


def _seq_len(cfg, batch):
    if cfg.family == "encdec":
        return 1 + NEW
    return batch["tokens"].shape[1] + (cfg.n_vis_tokens if cfg.family == "vlm" else 0) + NEW


# the gathered paths: (cfg, S (encdec: source, target), mesh shape)
def _gathered_cases():
    small = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash")
    seamless = dataclasses.replace(get_reduced(SEAMLESS), attn_impl="flash")
    return {
        "short": (small, 1024, (1, 1, 4, 1)),
        "chunked": (dataclasses.replace(small, attn_impl="chunked"), S, (1, 1, 4, 1)),
        "indivisible": (small, S + 64, (1, 1, 4, 1)),  # S % n == 0, S % (n chunk_size) != 0
        "model_axis": (get_reduced("rwkv6_7b"), 128, (1, 1, 2, 2)),
        "model_axis_zamba2": (get_reduced("zamba2_7b"), 128, (1, 1, 2, 2)),
        "seamless_gathered": (seamless, (256, 32), (1, 1, 4, 1)),
        "seamless_target_whole": (seamless, (256, 30), (1, 1, 4, 1)),   # 30 % 4 != 0
        # two 512-token routing groups, each across two 256-position shards
        "moe_group": (get_reduced("granite_moe_1b_a400m"), 1024, (1, 1, 4, 1)),
    }


def _gathered_batch(cfg, s):
    rng = np.random.default_rng(4)
    if cfg.family == "encdec":
        return _encdec_batch(cfg, *s, rng, rows=1)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, s)))}


def _seq_ranks(rank, world, out_dir):
    """Every sharded run of this module on one rank, pickled to
    ``out_dir/rank<r>.pkl``: logits, prefill logits and cache, greedy tokens,
    the gathered paths' logits and the refusals' messages."""
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import place_tree
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import decode

    mesh = make_production_mesh(shape=(1, 1, world, 1), device="cpu")
    plan = make_plan(mesh, mode="serve")
    res = {}
    for arch in ARCHS + tuple(FAMILIES):
        cfg, params, batch = _inputs(arch)
        with activation_mesh(plan), CollectiveCounter() as counter:
            res[arch, "logits"] = tmodel.forward_logits(cfg, params, batch)
        res[arch, "collectives"] = counter.totals()
        with activation_mesh(plan):
            res[arch, "prefill"] = decode.prefill(cfg, params, _context(cfg, batch),
                                                  _seq_len(cfg, batch))
            res[arch, "tokens"] = _generate(cfg, params, batch)
    for name, (cfg, s, shape) in _gathered_cases().items():
        m = make_production_mesh(shape=shape, device="cpu")
        p = place_tree(make_plan(m, mode="serve"), tmodel.init_params(cfg, 0, device="cpu"))
        with activation_mesh(make_plan(m, mode="serve")):
            res["gathered", name] = tmodel.forward_logits(cfg, p, _gathered_batch(cfg, s))
    refusals = {
        "rwkv_chunk": (get_reduced("rwkv6_7b"), 128),                # 32 positions a shard
        "zamba2_chunk": (get_reduced("zamba2_7b"), 128),
    }
    for name, (cfg, s) in refusals.items():
        batch = {"tokens": torch.zeros((1, s), dtype=torch.int64)}
        try:
            with activation_mesh(plan):
                tmodel.forward_logits(cfg, None, batch)
            res["refusal", name] = None
        except ValueError as e:
            res["refusal", name] = str(e)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess, the 4 gloo ranks and the unsharded references
    run side by side."""
    from repro_torch.models import decode

    out = tmp_path_factory.mktemp("seq")
    inputs = {arch: _inputs(arch) for arch in ARCHS + tuple(FAMILIES)}
    for arch, (_cfg, params, batch) in inputs.items():
        _save(out / f"{arch}.npz", params, batch)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_args = [f"{a}:{'flash' if a in FLASH else 'default'}" for a in inputs]
    proc = subprocess.Popen([sys.executable, "-c", _JAX_FORWARD, str(out), *jax_args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        ctx = spawn_gloo(_seq_ranks, 4, out, str(out), join=False)
        refs = {arch: dict(logits=tmodel.forward_logits(cfg, params, batch),
                           prefill=decode.prefill(cfg, params, _context(cfg, batch),
                                                  _seq_len(cfg, batch)),
                           tokens=_generate(cfg, params, batch))
                for arch, (cfg, params, batch) in inputs.items()}
        refs["gathered"] = {
            name: tmodel.forward_logits(cfg, tmodel.init_params(cfg, 0, device="cpu"),
                                        _gathered_batch(cfg, s))
            for name, (cfg, s, _shape) in _gathered_cases().items()}
        while not ctx.join():
            pass
        stdout, stderr = proc.communicate(timeout=540)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "JAX-SEQ-OK" in stdout, stdout[-2000:] + stderr[-2000:]
    for arch in inputs:
        refs[arch]["jax"] = np.load(out / f"{arch}_logits.npy")
    ranks = []
    for r in range(4):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


@pytest.mark.parametrize("arch", ARCHS + tuple(FAMILIES))
def test_sharded_forward_matches_jax_and_unsharded(runs, arch):
    ranks, refs = runs
    for res in ranks:
        got = res[arch, "logits"].numpy()
        np.testing.assert_allclose(got, refs[arch]["jax"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, refs[arch]["logits"].numpy(), rtol=1e-5, atol=1e-5)
    for res in ranks[1:]:          # every rank leaves with the same logits
        assert torch.equal(res[arch, "logits"], ranks[0][arch, "logits"])


@pytest.mark.parametrize("arch", ARCHS + tuple(FAMILIES))
def test_sharded_prefill_matches_unsharded(runs, arch):
    ranks, refs = runs
    want_logits, want = refs[arch]["prefill"]
    for res in ranks:
        logits, cache = res[arch, "prefill"]
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
        assert cache["pos"] == want["pos"]
        assert set(cache) == set(want)
        for name, t in want.items():
            if not torch.is_tensor(t):
                continue
            if t.dtype == torch.int32:
                assert torch.equal(cache[name], t), name
                continue
            assert cache[name].shape == t.shape, name
            np.testing.assert_allclose(cache[name].numpy(), t.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ARCHS + tuple(FAMILIES))
def test_sharded_greedy_tokens_identical(runs, arch):
    ranks, refs = runs
    for res in ranks:
        assert torch.equal(res[arch, "tokens"], refs[arch]["tokens"])


@pytest.mark.parametrize("name", ["granite", "rwkv6", "zamba2", "internvl2", "short", "chunked",
                                  "indivisible", "model_axis", "model_axis_zamba2",
                                  "seamless_gathered", "seamless_target_whole", "moe_group"])
def test_off_ring_paths_run(runs, name):
    """The paths off the ring: the four families above, the gathered dense
    paths, Seamless with its encoder's K/V gathered (the source cut, the
    target too, or whole on every rank where it does not divide), and
    Granite's routing groups across shards, against the unsharded
    forward."""
    ranks, refs = runs
    fam = {"granite": "granite_moe_1b_a400m", "rwkv6": "rwkv6_7b", "zamba2": "zamba2_7b",
           "internvl2": "internvl2_26b"}
    for res in ranks:
        if name in fam:
            got, want = res[fam[name], "logits"], refs[fam[name]]["logits"]
        else:
            got, want = res["gathered", name], refs["gathered"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,match", [
    ("rwkv_chunk", "scan's chunk"), ("zamba2_chunk", "scan's chunk"),
])
def test_off_ring_paths_raise(runs, name, match):
    ranks, _refs = runs
    for res in ranks:
        assert res["refusal", name] is not None and match in res["refusal", name], \
            res["refusal", name]


def test_seamless_encoder_takes_the_ring(runs):
    """The Seamless forward on 4 ranks: the encoder's non-causal ring (2
    layers x 3 rotations x (k, v) send/recv), the memory gathered once, the
    decoder's K and V gathered a layer (its 512 target tokens are off the
    ring's length), the last logits broadcast from the last rank."""
    ranks, _refs = runs
    for res in ranks:
        seq = res[SEAMLESS, "collectives"]["seq"]
        assert seq["send/recv"]["count"] == 2 * 3 * 2
        assert seq["all-gather"]["count"] == 1 + 2 * 2
        assert seq["broadcast"]["count"] == 1
        assert set(seq) == {"send/recv", "all-gather", "broadcast"}


def test_no_plan_no_seq_axis_run_whole():
    """Without a plan, or under one whose seq axis does not divide S, the
    batch is not sharded: ``seq_shard`` hands it back as it came."""
    cfg = dataclasses.replace(get_reduced("llama3_8b"), attn_impl="flash")
    batch = {"tokens": torch.zeros((1, 4096), dtype=torch.int64)}
    assert tmodel.seq_shard(cfg, batch) == (None, batch)
