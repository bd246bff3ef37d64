"""The hybrid_moe family (Granite-4.0-H) of the port against its plain
reference (``tests/granite_hybrid_ref.py``), on the CPU at a small size
with the published structure: a Mamba-2, a NoPE attention and a Mamba-2
layer, each followed by an 8-expert top-2 MoE beside a shared expert,
d 128, the four multipliers. Seeded weights of the port's init.

Tolerances: both sides compute in float32 by other algorithms (the SSD in
chunks of another form, the conv as shifted sums against ``conv1d``, the
grouped experts against a loop with ``index_add``), so sums round
differently: losses and logits agree to 1e-5 relative, every gradient
leaf to 1e-4 of its largest entry."""
import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import granite_hybrid_ref as ref
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import model, moe

ROOT = Path(__file__).resolve().parents[1]
SEQ = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(held=(2, 6)):
    """Granite-4.0-H's structure at d 128: layers M, A, M; 8 experts top-2,
    ``held`` of them here; the published multipliers."""
    return dataclasses.replace(
        get_config("granite_4_0_h_small"), name="granite_hybrid_small", n_layers=3,
        layer_types=("mamba", "attention", "mamba"), d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=64, shared_ff=96, vocab=101, n_experts=8, top_k=2,
        experts_held=held, ssm_state=16, ssm_head_dim=32, chunk_size=16, dtype="float32")


def ref_cfg(cfg) -> dict:
    """The reference's sizes, by the published config.json's keys."""
    return {"num_hidden_layers": cfg.n_layers, "layer_types": list(cfg.layer_types),
            "mamba_d_state": cfg.ssm_state, "mamba_n_heads": cfg.n_ssm_heads,
            "mamba_d_head": cfg.ssm_head_dim, "mamba_chunk_size": cfg.chunk_size,
            "rms_norm_eps": cfg.norm_eps, "attention_multiplier": cfg.attention_multiplier,
            "num_experts_per_tok": cfg.top_k, "experts_held": list(cfg.held),
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


def params_of(cfg, seed=7):
    return model.init_params(cfg, seed=seed, device="cpu", param_dtype=torch.float32)


def batch_of(cfg, n=1, seed=3):
    gen = torch.Generator().manual_seed(seed)
    seq = torch.randint(0, cfg.vocab, (n, SEQ + 1), generator=gen)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:], "mask": torch.ones(n, SEQ)}


def _close(a, b, rel):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    scale = max(b.abs().max().item(), 1e-30)
    assert (a - b).abs().max().item() <= rel * scale, ((a - b).abs().max().item(), scale)


def test_logits_loss_and_every_gradient_match_the_reference():
    cfg = small()
    params, batch = params_of(cfg), batch_of(cfg)
    rc = ref_cfg(cfg)
    logits = model.forward_logits(cfg, params, {"tokens": batch["tokens"]})
    want = ref.head_logits(params, rc, ref.hidden(params, rc, batch["tokens"]))[:, -1]
    _close(logits, want, 1e-5)
    loss, metrics, grads = steps.value_and_grad(cfg, params, batch, remat=True)
    ref_loss, ref_grads = ref.loss_and_grads(params, rc, batch["tokens"], batch["labels"])
    _close(loss, ref_loss, 1e-5)
    assert tree_util.paths(grads) == tree_util.paths(ref_grads)
    for path, g, r in zip(tree_util.paths(grads), tree_util.leaves(grads),
                          tree_util.leaves(ref_grads)):
        assert r.abs().max() > 0, path
        _close(g, r, 1e-4)
    # the counters: each layer's slots on its held experts, and the largest load
    assert metrics["moe_routed"].shape == (3,) and metrics["moe_max_load"].shape == (3,)
    assert torch.all(metrics["moe_max_load"] <= metrics["moe_routed"])
    assert torch.all(metrics["moe_routed"] <= SEQ * cfg.top_k)


def test_blockwise_reference_equals_its_whole_graph():
    """The reference's layer-at-a-time gradient is the gradient of its loss."""
    cfg = small()
    params, batch = params_of(cfg), batch_of(cfg)
    rc = ref_cfg(cfg)
    leaves = [t.detach().requires_grad_(True) for t in tree_util.leaves(params)]
    whole = tree_util.from_leaves(tree_util.paths(params), leaves)
    loss = ref.loss(whole, rc, batch["tokens"], batch["labels"])
    want = torch.autograd.grad(loss, leaves)
    got_loss, got = ref.loss_and_grads(params, rc, batch["tokens"], batch["labels"])
    _close(got_loss, loss.detach(), 1e-6)
    for g, w in zip(tree_util.leaves(got), want):
        _close(g, w, 1e-5)


def test_the_shares_add_up_to_the_whole_layer():
    """Four shares of two experts each: their partials, plus the shared
    expert counted once, are the reference's layer with every expert."""
    cfg = small(held=(0, 8))
    p = model.layer_params(params_of(cfg), 0, "mamba_layers")
    x = torch.randn(2, SEQ, cfg.d_model, generator=torch.Generator().manual_seed(11))
    total = model.shared_expert(p["shared"], x)
    for s in range(4):
        lo, hi = 2 * s, 2 * s + 2
        share = dict(p["moe"], **{k: p["moe"][k][lo:hi] for k in ("wg", "wu", "wd")})
        part, _ = moe.dropless_apply(share, x, top_k=cfg.top_k, held=(lo, hi))
        total = total + part
    whole = ref.moe(p["moe"], x, {"experts_held": [0, 8], "num_experts_per_tok": cfg.top_k})
    whole = whole + ref.swiglu(x, p["shared"]["wg"], p["shared"]["wu"], p["shared"]["wd"])
    _close(total, whole, 1e-5)


def test_a_router_forced_onto_one_expert_drops_no_token():
    """Every token's first pick is expert 5: the dropless route computes all
    of its slots (the capacity route would keep 1.25 x its fair share), and
    its output and gradients are the reference's."""
    cfg = small(held=(0, 8))
    p = dict(model.layer_params(params_of(cfg), 0, "mamba_layers")["moe"])
    p["router"] = p["router"].clone()
    p["router"][:, 5] += 1.0
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(2, SEQ, cfg.d_model, generator=gen) + 0.5      # positive: expert 5 wins
    xg = x.clone().requires_grad_(True)
    out, loads = moe.dropless_apply(p, xg, top_k=2, held=(0, 8))
    assert loads[5] == 2 * SEQ and loads.sum() == 2 * SEQ * 2
    want_x = x.clone().requires_grad_(True)
    want = ref.moe(p, want_x, {"experts_held": [0, 8], "num_experts_per_tok": 2})
    _close(out, want, 1e-5)
    w = torch.randn(out.shape, generator=gen)
    _close(torch.autograd.grad((out * w).sum(), xg)[0],
           torch.autograd.grad((want * w).sum(), want_x)[0], 1e-5)
    _, aux = moe.moe_apply(dict(p), x, top_k=2, capacity_factor=1.25)
    assert aux["dropped_frac"] > 0.2


def _ref_round(cfg, params, batch, q_bits, weights, uniforms, lr):
    """The round by the reference: each client's SGD step from ``params``,
    its eq.-4 u8 indexes against its range, the eq.-2 sum."""
    rc = ref_cfg(cfg)
    paths = tree_util.paths(params)
    aggs, idxs, tmaxes, losses = None, [], [], []
    for k in range(len(q_bits)):
        loss, grads = ref.loss_and_grads(params, rc, batch["tokens"][k:k + 1],
                                           batch["labels"][k:k + 1])
        new = [p - lr * g for p, g in zip(tree_util.leaves(params), tree_util.leaves(grads))]
        tmax = max(t.abs().max() for t in new)
        levels = 2.0 ** min(q_bits[k], 8) - 1.0
        idx = [torch.minimum(torch.floor(t.abs() * (levels / tmax))
                             + (u < t.abs() * (levels / tmax)
                                - torch.floor(t.abs() * (levels / tmax))).float(),
                             torch.tensor(levels)) for t, u in zip(new, uniforms[k])]
        terms = [weights[k] * tmax / levels * torch.where(t < 0, -i, i) for t, i in zip(new, idx)]
        aggs = terms if aggs is None else [a + t for a, t in zip(aggs, terms)]
        idxs.append(idx)
        tmaxes.append(tmax)
        losses.append(loss)
    return tree_util.from_leaves(paths, aggs), idxs, torch.stack(tmaxes), torch.stack(losses)


def test_one_fl_round_matches_the_reference():
    cfg = small()
    params = params_of(cfg)
    batch = batch_of(cfg, n=2)
    batch = {k: v[:, None] for k, v in batch.items()}               # (K, B_local = 1, S)
    shapes = [tuple(t.shape) for t in tree_util.leaves(params)]
    gen = torch.Generator().manual_seed(99)
    uniforms = [[torch.rand(s, generator=gen) for s in shapes] for _ in range(2)]
    stacked = tree_util.map(lambda t: t[None].expand((2,) + tuple(t.shape)), params)
    q_bits, weights = [6, 8], [0.5455, 0.4545]
    out, loss, theta_max = steps.make_fl_round(cfg, lr=1e-3, wire_packed=True)(
        stacked, batch, torch.tensor(q_bits), torch.tensor(weights), uniforms=uniforms)
    want, _, want_tmax, want_loss = _ref_round(
        cfg, params, {k: v[:, 0] for k, v in batch.items()}, q_bits, weights, uniforms, 1e-3)
    _close(loss, want_loss.mean(), 1e-5)
    _close(theta_max, want_tmax, 1e-6)
    agg = tree_util.map(lambda t: t[0], out)
    for a, w in zip(tree_util.leaves(agg), tree_util.leaves(want)):
        # an index may land one level apart where fp32 rounding moves a
        # coordinate across its uniform
        step = float(want_tmax.max()) / 63.0
        assert (a - w).abs().max() <= step * 1.01
        assert ((a - w).abs() > 1e-6).float().mean() <= 1e-3
    for a, b in zip(tree_util.leaves(out), tree_util.leaves(agg)):
        assert torch.equal(a[1], b)                                  # every client's start


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "fp32"])
def test_generator_draws_equal_the_given_uniforms(packed):
    """Drawn from a generator, each client's uniforms come just before its
    wire: the round is bit-equal to the same draws passed in, client by
    client, leaf by leaf."""
    cfg = small()
    params = params_of(cfg)
    batch = {k: v[:, None] for k, v in batch_of(cfg, n=2).items()}
    stacked = tree_util.map(lambda t: t[None].expand((2,) + tuple(t.shape)), params)
    shapes = [tuple(t.shape) for t in tree_util.leaves(params)]
    gen = torch.Generator().manual_seed(123)
    given = [[torch.rand(s, generator=gen) for s in shapes] for _ in range(2)]
    fl_round = steps.make_fl_round(cfg, wire_packed=packed)
    args = (stacked, batch, torch.tensor([6, 8]), torch.tensor([0.5, 0.5]))
    a = fl_round(*args, uniforms=given)
    b = fl_round(*args, generator=torch.Generator().manual_seed(123))
    for x, y in zip(tree_util.leaves(a[0]), tree_util.leaves(b[0])):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_the_round_hands_back_each_clients_counters():
    cfg = small()
    params = params_of(cfg)
    batch = {k: v[:, None] for k, v in batch_of(cfg, n=2).items()}
    stacked = tree_util.map(lambda t: t[None].expand((2,) + tuple(t.shape)), params)
    got = []
    steps.make_fl_round(cfg, wire_packed=True)(
        stacked, batch, torch.tensor([6, 8]), torch.tensor([0.5, 0.5]),
        generator=torch.Generator().manual_seed(1), client_metrics=got)
    assert len(got) == 2 and set(got[0]) >= {"loss", "moe_routed", "moe_max_load"}


def test_a_plan_is_refused_with_what_is_missing(monkeypatch):
    cfg = small()
    params, batch = params_of(cfg), batch_of(cfg)
    monkeypatch.setattr(model, "current_activation_plan", lambda: object())
    with pytest.raises(NotImplementedError, match="no sharding rule"):
        model.forward_train(cfg, params, batch)


def test_the_published_config_and_its_counts():
    cfg = get_config("granite_4_0_h_small")
    assert cfg.family == "hybrid_moe" and cfg.d_inner == 8192 and cfg.n_ssm_heads == 128
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert len(cfg.layer_types) == 40 and cfg.held == (0, 72)
    cut = dataclasses.replace(cfg, n_layers=10, vocab=12544, experts_held=(0, 9))
    assert cut.param_count() == 2_055_031_424
    assert cut.active_param_count() == 1_323_649_664
    assert np.isclose(cfg.param_count() / 1e9, 32.2, atol=0.05)


def test_the_two_reference_copies_are_byte_identical():
    assert filecmp.cmp(ROOT / "tests" / "granite_hybrid_ref.py",
                       ROOT / "bench" / "reference" / "granite_hybrid.py", shallow=False)


def test_each_layer_names_its_forward_recompute_and_backward():
    """Under remat every mixer and MoE range opens three times a layer
    (forward, recompute, backward), and none holds another: a layer's
    recompute runs before its backward's ranges open."""
    from torch.profiler import ProfilerActivity, profile

    cfg = small()
    params, batch = params_of(cfg), batch_of(cfg)
    names = ("mamba_mixer", "attention_mixer", "moe_route", "moe_experts", "shared_expert")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.value_and_grad(cfg, params, batch, remat=True)
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.name in names), key=lambda r: r[0])
    counts = {n: sum(r[2] == n for r in ranges) for n in names}
    assert counts == {"mamba_mixer": 6, "attention_mixer": 3, "moe_route": 9,
                      "moe_experts": 9, "shared_expert": 9}
    for (a0, a1, _), (b0, _b1, _) in zip(ranges, ranges[1:]):
        assert a1 <= b0


def test_the_round_hands_back_each_clients_step_norms():
    """``grad_norm`` and ``update_norm``: each leaf's gradient norm and norm
    of new - start, by client, against the reference's g and (p - lr g) -
    p on the same batch (a leaf whose lr g is under half an ulp of p does
    not move, on both sides)."""
    cfg = small()
    params = params_of(cfg)
    batch = {k: v[:, None] for k, v in batch_of(cfg, n=2).items()}
    stacked = tree_util.map(lambda t: t[None].expand((2,) + tuple(t.shape)), params)
    got = []
    steps.make_fl_round(cfg, lr=1e-3, wire_packed=True)(
        stacked, batch, torch.tensor([6, 8]), torch.tensor([0.5, 0.5]),
        generator=torch.Generator().manual_seed(1), client_metrics=got)
    rc = ref_cfg(cfg)
    for k in range(2):
        _, grads = ref.loss_and_grads(params, rc, batch["tokens"][k], batch["labels"][k])
        pg = list(zip(tree_util.leaves(params), tree_util.leaves(grads)))
        grad = torch.stack([torch.linalg.vector_norm(g) for _, g in pg])
        step = torch.stack([torch.linalg.vector_norm((p - 1e-3 * g) - p) for p, g in pg])
        assert got[k]["grad_norm"].shape == got[k]["update_norm"].shape == grad.shape
        assert torch.all((got[k]["grad_norm"] - grad).abs() <= 1e-3 * grad)
        _close(got[k]["update_norm"], step, 1e-3)
