"""The dry run's other modes (``repro_torch.launch.dryrun``) on the CPU at
reduced size, rank 0 under torch's fake process group in this process,
each held against the JAX package where its side is spec or formula math:

  * a serving dry run takes rank 0's rows of the batch (the plan's
    ``data_specs``, JAX's ``in_shardings``): a prefill on ``2x2`` holds
    half the rows of ``1x2`` and moves exactly half the ``model``
    all-reduce bytes, with the same counts;
  * decode shapes: rank 0's cache equals the local shapes JAX's
    ``cache_specs_plan`` implies for ``decode_inputs_spec`` under the serve
    plan, for the six families on ``data 2 x model 2``, for a mesh where
    the KV heads do not divide ``model``, and for ``long_500k``'s
    window-bounded cache through both packages' ``long_context_variant``;
    every step issues the same collectives;
  * the analytic terms of both packages for decode and ``causal_skip``,
    and ``--causal-skip`` reaching ``make_train_step``;
  * ``--fl-round``: the ``pod``-axis bytes are the per-client payload rule
    of ``tests/test_torch_fl_round_ranks.py`` (fp32: 4 Z + 4 a client, Z
    the elements of the rank's shard of its client's model) plus the
    losses' gather; JAX's message without a ``pod`` axis of 2 or more;
  * ``--wire-ratio``: ``model_dim_z`` and the downlink's bytes by JAX's
    formula over ``repro.models.abstract_params``, and the inter-pod bytes
    and ratio of both wire modes by the payload rule (the wire's u8
    indexes Z, its sign planes the rows x (last dim padded to 128) / 8);
  * the default meshes; ``--out`` (one JSON line), the ledger's ``record``
    event (valid under both packages' ``validate_event``), and a failing
    run's ``ok: false`` record and exit code 1.
"""
import dataclasses
import json
import math
import re

import pytest
import torch.distributed as dist

from torch_replay import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("llama3_8b", "granite_moe_1b_a400m", "seamless_m4t_large_v2", "internvl2_26b",
            "rwkv6_7b", "zamba2_7b")
B, S = 4, 128
FL = ["--shape", "train_512", "--batch", "8", "--seq", "64", "--mesh-shape", "2x2x1"]


def _run(*argv, arch="llama3_8b"):
    from repro_torch.launch import dryrun

    rec = dryrun.main(["--arch", arch, "--reduced", *argv], device="cpu")
    assert not dist.is_initialized()
    return rec


def _sizes(mesh: str) -> dict:
    from repro_torch.launch.mesh import MESH_AXIS_NAMES, parse_mesh_shape

    shape = parse_mesh_shape(mesh)
    return dict(zip(MESH_AXIS_NAMES[len(shape)], shape))


def _local(shape, spec, sizes) -> list:
    """The per-rank shape of ``shape`` laid out by a JAX ``spec``."""
    out = []
    for i, n in enumerate(shape):
        ent = spec[i] if i < len(spec) else None
        axes = () if ent is None else (ent,) if isinstance(ent, str) else tuple(ent)
        out.append(n // math.prod(sizes[a] for a in axes))
    return out


# ------------------------------------------------------- step 0: the rows

def test_prefill_runs_rank0_rows():
    one = _run("--shape", "prefill_32k", "--batch", str(B), "--seq", str(S), "--mesh-shape", "1x2",
               "--steps", "1")
    two = _run("--shape", "prefill_32k", "--batch", str(B), "--seq", str(S), "--mesh-shape", "2x2",
               "--steps", "1")
    assert one["batch"] == two["batch"] == B
    assert (one["batch_local"], two["batch_local"]) == (B, B // 2)
    ar1, ar2 = one["collectives"]["model"]["all-reduce"], two["collectives"]["model"]["all-reduce"]
    assert ar1["bytes"] == 4 * 4 * 128 * 256 * 4 and ar2["bytes"] * 2 == ar1["bytes"]
    assert ar1["count"] == ar2["count"] == 4
    assert one["collectives"]["model"]["all-gather"] == two["collectives"]["model"]["all-gather"]


# ------------------------------------------------------------- decode

DECODE_CASES = [(arch, "2x2", "decode_32k") for arch in FAMILIES] + [
    ("granite_moe_1b_a400m", "1x4", "decode_32k"),     # KV 2 on model 4: "expand" heads
    ("llama3_8b", "2x2", "long_500k")]                 # B 1 whole, the 8,192-slot window


@pytest.mark.parametrize("arch,mesh,shape", DECODE_CASES)
def test_decode_cache_equals_jax_specs(arch, mesh, shape):
    from repro import configs as jconfigs
    from repro.dist import plan as jplan
    from repro.dist import sharding as jshd
    from repro.launch.inputs import decode_inputs_spec
    from repro.models.config import INPUT_SHAPES

    cut = [] if shape == "long_500k" else ["--batch", str(B), "--seq", str(S)]
    rec = _run("--shape", shape, "--mesh-shape", mesh, "--steps", "2", *cut, arch=arch)
    jcfg = jconfigs.get_reduced(arch)
    jshape = INPUT_SHAPES[shape]
    if shape == "long_500k":
        jcfg = jconfigs.long_context_variant(jcfg)
    else:
        jshape = dataclasses.replace(jshape, global_batch=B, seq_len=S)
    sizes = _sizes(mesh)
    jplan_ = jplan.make_plan(sizes, mode="serve")
    jtokens, jcache = decode_inputs_spec(jcfg, jshape)
    specs = jshd.cache_specs_plan(jplan_, jcache)
    want = {name: _local(t.shape, specs[name], sizes) for name, t in jcache.items()
            if len(t.shape)}
    assert rec["kind"] == "decode" and rec["cache_shapes"] == want
    assert rec["batch_local"] == _local(jtokens.shape, jshd.data_specs(jplan_, jtokens), sizes)[0]
    assert rec["collectives_same_each_step"]
    if shape == "long_500k":
        assert rec["batch_local"] == 1 and want["k"][2] == 8192


# ----------------------------------------------------- analytic terms

@pytest.mark.parametrize("kind", ["decode_32k", "long_500k", "train_causal_skip"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_analytic_terms_equal_jax(arch, kind):
    from repro import configs as jconfigs
    from repro.launch.analytic import analytic_record as j_analytic
    from repro.models.config import INPUT_SHAPES as J_SHAPES
    from repro_torch import configs as tconfigs
    from repro_torch.launch.analytic import analytic_record as t_analytic
    from repro_torch.models.config import INPUT_SHAPES as T_SHAPES

    name = "train_4k" if kind == "train_causal_skip" else kind
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if kind == "long_500k":
        jcfg, tcfg = jconfigs.long_context_variant(jcfg), tconfigs.long_context_variant(tcfg)
    step = "train" if kind == "train_causal_skip" else "decode"
    kw = dict(causal_skip=kind == "train_causal_skip", dp_size=16)
    got = t_analytic(tcfg, T_SHAPES[name], step, 256, **kw)
    want = j_analytic(jcfg, J_SHAPES[name], step, 256, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_causal_skip_reaches_the_step(monkeypatch):
    from repro_torch.configs import get_reduced
    from repro_torch.launch import steps
    from repro_torch.launch.analytic import analytic_record
    from repro_torch.models.config import INPUT_SHAPES

    seen = []
    make = steps.make_train_step

    def spy(*a, **kw):
        seen.append(kw.get("causal_skip"))
        return make(*a, **kw)

    monkeypatch.setattr(steps, "make_train_step", spy)
    rec = _run("--shape", "train_4k", "--batch", str(B), "--seq", str(S), "--mesh-shape", "2x2",
               "--steps", "1", "--causal-skip")
    assert seen == [True] and rec["causal_skip"] is True
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=B, seq_len=S)
    ana = analytic_record(get_reduced("llama3_8b"), shape, "train", 4, causal_skip=True, dp_size=2)
    assert rec["analytic_flops_per_device"] == ana["analytic_flops_per_device"]
    assert ana != analytic_record(get_reduced("llama3_8b"), shape, "train", 4, dp_size=2)


# ----------------------------------------------------- federated round

def _shards(mesh: str) -> list:
    """The rank's shard shape of each leaf of a client's reduced Llama under
    the round's plan (FSDP over the intra-client axes)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.dist.plan import make_plan
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import model

    sizes = _sizes(mesh)
    plan = make_plan(sizes, dp_override=tuple(a for a in ("data", "seq") if a in sizes))
    one = model.abstract_params(get_reduced("llama3_8b"))
    return [tuple(n // plan.axis_size(spec[i] if i < len(spec) else None)
                  for i, n in enumerate(t.shape))
            for t, spec in zip(tree_util.leaves(one), tree_util.leaves(param_specs(plan, one)))]


def _payload(shard_shapes, wire: bool) -> int:
    """One client's uplink bytes (``tests/test_torch_fl_round_ranks.py``)."""
    if not wire:
        return sum(4 * math.prod(s) for s in shard_shapes) + 4
    total = 4
    for s in shard_shapes:
        rows, d = math.prod(s[:-1]), s[-1]
        total += math.prod(s) + rows * ((d + 127) // 128 * 128) // 8
    return total


def test_fl_round_pod_bytes_follow_the_payload_rule():
    rec = _run("--fl-round", *FL, "--steps", "1")
    shards, k = _shards("2x2x1"), 2
    assert rec["kind"] == "fl_round" and rec["n_clients"] == k and rec["batch_local"] == 2
    pod = rec["collectives"]["pod"]
    assert set(pod) == {"all-gather"}
    assert pod["all-gather"]["count"] == len(shards) + 2          # payloads, range, loss
    assert pod["all-gather"]["bytes"] == k * _payload(shards, False) + 4 * k
    assert rec["param_bytes"] == _payload(shards, False) - 4      # the rank's block of client 0
    assert {"data"} <= set(rec["collectives"]) and rec["collectives_same_each_step"]


def test_fl_round_needs_a_pod_axis():
    with pytest.raises(ValueError, match=re.escape("--fl-round needs a pod axis >= 2 "
                                                   "(clients = pods)")):
        _run("--fl-round", "--shape", "train_512", "--mesh-shape", "2x2")
    assert not dist.is_initialized()


@pytest.mark.parametrize("downlink", ["off", "quant", "delta"])
def test_wire_ratio_equals_the_formulas(downlink):
    import jax

    from repro import configs as jconfigs
    from repro.launch.steps import DOWNLINK_Q_BITS
    from repro.models import abstract_params

    rec = _run("--wire-ratio", "--downlink", downlink, *FL)
    shards, k = _shards("2x2x1"), 2
    extra = 4 * k + (8 if downlink == "delta" else 0)      # the losses; delta's range max
    fp32, packed = k * _payload(shards, False) + extra, k * _payload(shards, True) + extra
    assert (rec["fp32_inter_bytes"], rec["packed_inter_bytes"]) == (fp32, packed)
    assert rec["packed_inter_wire_bytes"] == k * (_payload(shards, True) - 4)
    assert rec["packed_inter_dense_bytes"] == 4 * k + extra
    assert rec["fp32_inter_wire_bytes"] == 0 and rec["fp32_inter_dense_bytes"] == fp32
    assert rec["fp32_unattributed_bytes"] == rec["packed_unattributed_bytes"] == 0
    assert rec["inter_pod_ratio"] == packed / fp32
    z = sum(math.prod(x.shape) for x in
            jax.tree_util.tree_leaves(abstract_params(jconfigs.get_reduced("llama3_8b"))))
    assert rec["model_dim_z"] == z and rec["downlink_fp32_bytes"] == 4 * z
    if downlink == "off":
        assert "downlink_wire_bytes" not in rec
    else:
        want = (z * DOWNLINK_Q_BITS) // 8 + (z + 7) // 8 + 4
        assert rec["downlink_wire_bytes"] == want and rec["downlink_ratio"] == want / (4.0 * z)


# ------------------------------------------- default meshes, --out, ledger

def test_default_meshes():
    from repro_torch.launch.dryrun import _mesh_arg, _parser

    def mesh(*argv):
        return _mesh_arg(_parser().parse_args(list(argv)))

    assert mesh() == "16x16"
    assert mesh("--multi-pod") == mesh("--wire-ratio") == "2x16x16"
    assert mesh("--multi-pod", "--mesh-shape", "1x2") == "1x2"


@pytest.mark.parametrize("argv,mesh", [([], "16x16"), (["--multi-pod"], "2x16x16")])
def test_decode_on_a_default_mesh(argv, mesh):
    """Rank 0 of 256 and of 512 fake ranks: the batch's 32 or 64 rows cut
    to 2 over (pod, data); the reduced heads (4, KV 1) stay whole on a
    ``model`` of 16."""
    n = 2 * math.prod(int(x) for x in mesh.split("x")[:-1])
    rec = _run("--shape", "decode_32k", "--batch", str(n), "--seq", "64", "--steps", "1", *argv)
    assert rec["mesh"] == mesh and rec["world"] == math.prod(int(x) for x in mesh.split("x"))
    assert rec["batch_local"] == 2 and rec["cache_shapes"]["k"] == [2, 2, 64, 1, 64]


def _events(path):
    from repro.obs.ledger import validate_event as j_validate
    from repro_torch.obs.ledger import read_ledger, validate_event

    events = read_ledger(str(path))
    for ev in events:
        validate_event(ev)
        j_validate(ev)
    return events


def test_out_and_ledger(tmp_path, monkeypatch):
    from repro_torch.launch.dryrun import cli

    out, ledger = tmp_path / "out.jsonl", tmp_path / "ledger.jsonl"
    monkeypatch.setenv("REPRO_LEDGER", str(ledger))
    argv = ["--arch", "llama3_8b", "--reduced", "--shape", "decode_32k", "--batch", str(B),
            "--seq", str(S), "--mesh-shape", "2x2", "--steps", "1", "--out", str(out)]
    assert cli(argv, device="cpu") == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["ok"] is True and rec["kind"] == "decode"
    (ev,) = _events(ledger)
    assert ev["event"] == "record" and ev["source"] == "launch.dryrun[llama3_8b,decode_32k]"
    assert ev["payload"]["cache_shapes"] == rec["cache_shapes"]


@pytest.mark.parametrize("argv,error", [
    (["--fl-round", "--shape", "train_512"], "ValueError: --fl-round needs a pod axis >= 2"),
    (["--shape", "prefill_32k", "--batch", str(B), "--seq", str(S), "--mesh-shape", "1x2",
      "--steps", "1", "--require-seq-sharded"], "AssertionError: ")])
def test_a_failure_is_a_record(tmp_path, monkeypatch, argv, error):
    from repro_torch.launch.dryrun import cli

    out, ledger = tmp_path / "out.jsonl", tmp_path / "ledger.jsonl"
    monkeypatch.setenv("REPRO_LEDGER", str(ledger))
    assert cli(["--arch", "llama3_8b", "--reduced", *argv, "--out", str(out)],
               device="cpu") == 1
    assert not dist.is_initialized()
    (line,) = out.read_text().splitlines()
    rec = json.loads(line)
    assert rec["ok"] is False and rec["error"].startswith(error), rec["error"]
    assert rec["mesh"] == ("1x2" if "1x2" in argv else "16x16")
    assert set(rec) == {"arch", "shape", "mesh", "ok", "error", "traceback"}
    assert "Traceback" in rec["traceback"] and len(rec["traceback"]) <= 4000
    (ev,) = _events(ledger)
    assert ev["payload"]["ok"] is False
