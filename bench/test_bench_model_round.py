"""The model-round driver's files and counts, on the CPU: the operation
and parameter counts against hand derivations, ``check_files`` against
broken files, the new readers on hand-built traces, and one run through
the harness at a small size (the Granite-4.0-H structure at d 128), sound
and with the shared expert left out."""
import copy
import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "granite4h_small_fl_k2"
SEED = 2**31 + 777


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec():
    from bench import harness

    return copy.deepcopy(harness.cell_spec(WORKLOAD, ROOT))


def test_parameter_count_by_hand():
    from bench.counts.model_flops import param_count

    cfg = _spec()["config"]
    # Mamba-2: in_proj 4096 x (2*8192 + 2*128 + 128), conv 4 x 8448 + bias 8448,
    # A_log, D, dt_bias 3 x 128, gated norm 8192, out_proj 8192 x 4096
    mamba = 68_681_728 + 33_792 + 8_448 + 384 + 8_192 + 33_554_432
    # attention: q, o 4096 x 4096; k, v 4096 x 1024
    attn = 2 * 16_777_216 + 2 * 4_194_304
    # router 4096 x 72, 9 experts x 3 x 4096 x 768, shared 3 x 4096 x 1536, two norms
    ffn = 294_912 + 84_934_656 + 18_874_368 + 8_192
    total = 9 * (mamba + ffn) + (attn + ffn) + 12_544 * 4096 + 4096
    assert param_count(cfg) == total == cfg["params_held"] == 2_055_031_424


def test_round_flops_by_hand():
    from bench.counts import model_flops
    from bench.drivers import model_round

    spec = _spec()
    cfg, traffic = spec["config"], spec["traffic"]
    # a token's forward: Mamba-2 in/out projections and its SSD at chunk 256
    mamba = 2 * 4096 * 16_768 + 2 * 8192 * 4096 + 2 * 256 * 128 + 2 * 256 * 8192 \
        + 4 * 128 * 128 * 64
    # attention: q/o, k/v projections, QK^T and PV over 4,096 keys
    attn = 4 * 4096 * 4096 + 4 * 4096 * 1024 + 4 * 4096 * 32 * 128
    # router, 10 x 9 / 72 expert passes of 3 x 4096 x 768, the shared expert
    ffn = 2 * 4096 * 72 + 1.25 * 6 * 4096 * 768 + 6 * 4096 * 1536
    token = 9 * mamba + attn + 10 * ffn + 2 * 4096 * 12_544
    assert token == 2_789_408_768
    assert model_flops.round_flops(cfg, traffic) == 2 * 3 * 4096 * token
    assert model_round.round_flops(cfg, traffic) == pytest.approx(68.55e12, rel=1e-3)
    assert model_round.FLOP_PEAK == "fp32_flop_per_s"
    # the grouped products: 9 + 3 products of 2 D F a routed slot
    assert model_flops.grouped_flops(cfg, 1000, model_flops.ROWS_PRODUCTS) \
        == 9 * 2 * 1000 * 4096 * 768


BROKEN = {
    "traffic without seq_len": lambda s: s["traffic"].pop("seq_len"),
    "a level for one client only": lambda s: s["traffic"].update(q_bits=[6]),
    "two rounds a call": lambda s: s["traffic"].update(rounds_per_call=2),
    "a limit renamed": lambda s: s["limits"]["limits"].update(
        model_gap=s["limits"]["limits"].pop("model_err")),
    "a limit left out": lambda s: s["limits"]["limits"].pop("theta_err"),
    "a parameter count off": lambda s: s["config"].update(params_held=2_055_031_425),
    "eight experts held of nine": lambda s: s["config"].update(experts_held=[0, 8]),
    "the layer pattern cut": lambda s: s["config"].update(
        layer_types=s["config"]["layer_types"][:10]),
    "the vocabulary cut but not listed": lambda s: s["config"].update(
        reduced=["num_hidden_layers", "num_local_experts"]),
    "a router of the held experts": lambda s: s["config"].update(router_experts=9),
}


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_check_files_refuses_a_broken_file(fault):
    from bench.drivers import model_round

    spec = _spec()
    model_round.check_files(spec)
    BROKEN[fault](spec)
    with pytest.raises(ValueError):
        model_round.check_files(spec)


def test_the_file_states_the_published_widths():
    """Every width of the catalog's config is the file's; the program's
    architecture has them all (``program_config`` checks it)."""
    from bench.drivers import model_round

    cfg = _spec()["config"]
    assert (cfg["hidden_size"], cfg["intermediate_size"], cfg["shared_intermediate_size"]) \
        == (4096, 768, 1536)
    assert (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]) == (128, 64, 128)
    assert (cfg["num_attention_heads"], cfg["num_key_value_heads"]) == (32, 8)
    assert (cfg["embedding_multiplier"], cfg["residual_multiplier"],
            cfg["attention_multiplier"], cfg["logits_scaling"]) == (12, 0.22, 0.0078125, 16)
    assert cfg["position_embedding_type"] == "nope" and cfg["num_experts_per_tok"] == 10
    prog = model_round.program_config(cfg)
    assert prog.held == (0, 9) and prog.n_layers == 10 and prog.vocab == 12_544
    assert prog.param_count() == cfg["params_held"]


def _event(n, a, b, device=False, annotation=False):
    return SimpleNamespace(name=n, time_range=SimpleNamespace(start=a, end=b),
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                           is_user_annotation=annotation, is_async=False, thread=1)


NEW_READERS = ("ssd_device_ms", "moe_device_ms", "moe_launches_per_round", "uplink_device_ms",
               "moe_rows_gemm_roofline", "moe_wgrad_gemm_roofline")


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_find_nothing_in_a_trace_without_their_work(name):
    """A traced call of another program (the fleet's kernels and ranges):
    each new reader returns None."""
    import importlib

    from bench.drivers import model_round
    from bench.trace import WINDOW, TraceView

    events = [_event(WINDOW, 0, 100, annotation=True), _event("fleet_local_sgd", 5, 50),
              _event("fleet_local_sgd", 10, 40, device=True, annotation=True),
              _event("sm80_xmma_fprop_implicit_gemm", 12, 30, device=True)]
    ctx = {"view": TraceView(events, 1), "config": _spec()["config"], "traffic": {},
           "device_kind": "NVIDIA H100 80GB HBM3",
           "driver": model_round}
    assert importlib.import_module(f"bench.metrics.{name}").read(ctx) is None


def test_readers_on_a_hand_built_trace():
    """Two Mamba ranges, a MoE range with two launches, the grouped kernel
    at a known time: the readers' numbers by hand."""
    from bench.drivers import model_round
    from bench.metrics import (moe_device_ms, moe_launches_per_round, moe_rows_gemm_roofline,
                               ssd_device_ms)
    from bench.trace import WINDOW, TraceView

    kernel = "(anonymous namespace)::moe_rows_gemm_kernel(float const*, long const*)"
    events = [_event(WINDOW, 0, 10_000, annotation=True),
              _event("mamba_mixer", 100, 200, device=True, annotation=True),
              _event("ssd_op", 100, 150, device=True),
              _event("mamba_mixer", 300, 400, device=True, annotation=True),
              _event("ssd_op", 300, 330, device=True),
              _event("moe_experts", 1000, 6000, device=True, annotation=True),
              _event(kernel, 1000, 5000, device=True),
              _event("copy", 5500, 6000, device=True),
              _event("routed_slots 100000 20", 7000, 7000)]
    cfg = _spec()["config"]
    ctx = {"view": TraceView(events, 1), "config": cfg, "device_kind": "NVIDIA H100 80GB HBM3",
           "driver": model_round}
    assert ssd_device_ms.read(ctx) == pytest.approx(0.08)
    assert moe_device_ms.read(ctx) == pytest.approx(4.5)
    assert moe_launches_per_round.read(ctx) == 2
    least_s = 9 * 2 * 100_000 * 4096 * 768 / 67e12          # compute-bound at these sizes
    assert moe_rows_gemm_roofline.read(ctx) == pytest.approx(100 * least_s / 4e-3)


def _small_cell(monkeypatch):
    """The cell's spec at the Granite-4.0-H structure cut to d 128: 6
    layers (one attention), 2 of 8 experts top-2, 64 tokens a client; the
    embeddings unscaled, so that at this width a layer's output is a
    larger part of the residual stream than at the published one."""
    from repro_torch.configs import get_config

    from bench.drivers import model_round

    spec = _spec()
    spec["config"].update(
        hidden_size=128, num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
        shared_intermediate_size=96, router_experts=8, num_local_experts=2,
        experts_held=[2, 4], num_experts_per_tok=2, mamba_d_state=16, mamba_n_heads=8,
        mamba_d_head=32, mamba_chunk_size=16, vocab_size=101, num_hidden_layers=6,
        embedding_multiplier=1.0)
    spec["traffic"]["seq_len"] = 64
    c = spec["config"]
    small = dataclasses.replace(
        get_config(c["arch"]), n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, shared_ff=96, vocab=101, n_experts=8, top_k=2, experts_held=(2, 4),
        ssm_state=16, ssm_head_dim=32, chunk_size=16, embedding_multiplier=1.0,
        dtype="float32")
    monkeypatch.setattr(model_round, "program_config", lambda cfg: small)
    return spec


@pytest.mark.parametrize("fault", [None, "no_shared_expert", "router_frozen", "state_unchanged"],
                         ids=["sound", "no_shared_expert", "router_frozen", "state_unchanged"])
def test_a_small_cell_runs_through_the_harness(monkeypatch, fault):
    import contextlib

    from bench import harness, model_faults

    spec = _small_cell(monkeypatch)
    with model_faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = harness.run_cell(WORKLOAD, SEED, 0.05, False, time.perf_counter(),
                               device=torch.device("cpu"), spec=spec)
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"round_ms", "setup_s"}
    if fault is None:
        assert out["correct"], out["check"]
        assert out["readings"]["wire_off"] == 0
        assert len(out["readings"]["routed"]) == 2 and len(out["readings"]["routed"][0]) == 6
    elif fault == "no_shared_expert":
        assert not out["correct"], out["check"]
        assert out["check"]["loss_err"]["value"] > 2 * out["check"]["loss_err"]["limit"]
    else:
        # the forward is sound; a leaf left as it was reads 1
        assert not out["correct"], out["check"]
        assert out["check"]["grad_err"]["value"] == pytest.approx(1.0)
        assert "router" in out["readings"]["grad_worst"] or fault == "state_unchanged"
        if fault == "state_unchanged":
            assert out["check"]["update_err"]["value"] == pytest.approx(1.0)
    json.dumps(out)


def test_the_rope_control_moves_the_attention_mixer():
    """``model_faults.rope`` rotates the NoPE mixer's queries and keys: the
    mixer's output moves, and is as it was once the control ends."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.models import model

    from bench import model_faults

    cfg = dataclasses.replace(
        get_config("granite_4_0_h_small"), n_layers=1, layer_types=("attention",),
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, shared_ff=32, vocab=50,
        n_experts=4, top_k=2, dtype="float32")
    params = model.init_params(cfg, seed=1, device="cpu", param_dtype=torch.float32)
    attn = tree_util.map(lambda t: t[0], params["attn_layers"]["attn"])
    x = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(0))
    plain = model._hybrid_moe_attention(cfg, attn, x)
    with model_faults.rope():
        rotated = model._hybrid_moe_attention(cfg, attn, x)
    assert (rotated - plain).abs().max() > 1e-4 * plain.abs().max()      # fp32 rounding: 1e-7
    assert torch.equal(plain, model._hybrid_moe_attention(cfg, attn, x))
