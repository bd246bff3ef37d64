"""``repro_torch.launch.dryrun`` on the CPU at reduced size: rank 0 of a
multi-rank mesh under torch's fake process group (in this process; the
group is destroyed after each run). The collectives one train step
issues, by axis and kind (counts and result bytes), must equal
``analytic_collectives``, alike in every timed step; the record carries
its fields, the fake group's note, rank 0's state bytes (its shards of the
``param_specs``; the gradient's as the optimizer update received it) and
no peak (not measured on the CPU); a prefill shape runs under the serve
plan and issues two all-reduces a layer over ``model`` and the two table
gathers; the four other families' prefills under the serve plan issue
their tensor-parallel collectives, counted layer by layer. The collective
term counts the bytes on the links by NCCL's ring factors. The gates
(``--require-seq-sharded``, ``--require-flash``) hold on a reduced Llama
prefill on ``1x1x4x1`` (the ring, its seq-axis send/recv counted) and each
fails on purpose where it should: the sequence whole on a ``1x2`` mesh,
and dense attention's S² scores at S <= 2048. The JAX package's train
counterpart (``tests/test_sharding_dryrun.py``'s ``lower_train_step`` on
``(1, 2, 2, 2)``): the reduced Llama's train step at B = 8, S = 2,304 on
``1x2x2x2`` passes ``--require-seq-sharded``, its seq-axis collectives
counted by kind, and the same run on ``1x2x1x2`` fails it (two
subprocesses side by side, one torch thread each). The gates read one
untimed step run alone under the shape log after the warm-up: no timed
step runs under it, and its time is recorded apart.

The seq gate against the JAX package's (a third subprocess beside those
two, on 2 forced host devices: ``lower_train_step`` /
``lower_prefill_step`` and ``hlo_analysis.full_length_intermediates`` at
its own threshold) on a ``seq`` 2 mesh, for the reduced Zamba2-7B train
step, the reduced SeamlessM4T-large-v2 train step and its prefill, each
at 2,304 positions (the Zamba2 and encoder attention chunked; the
Seamless target 288, the encoder's prefill on the ring): both verdicts
fail alike on every case, and an offender of the port's is the same
tensor, up to its layout, as one JAX's step holds whole on a device.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from torch_replay import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("arch", "shape", "kind", "mesh", "axes", "world", "rank", "batch", "seq", "note",
          "param_bytes", "grad_bytes", "opt_bytes", "s_per_step", "step_seconds",
          "shape_log_step_s", "peak_gb",
          "fwd_bwd_peak_gb", "collectives",
          "collectives_same_each_step", "compute_term_s", "memory_term_s",
          "collective_term_s")


def _run(*argv, shape="train_4k", arch="llama3_8b", batch=4, seq=128):
    from repro_torch.launch import dryrun

    rec = dryrun.main(["--arch", arch, "--reduced", "--shape", shape, "--batch", str(batch),
                       "--seq", str(seq), *argv], device="cpu")
    assert not dist.is_initialized()
    return rec


def _rank0_bytes(mesh_shape):
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced
    from repro_torch.dist.plan import make_plan
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import model

    sizes = dict(zip(("data", "model"), (int(x) for x in mesh_shape.split("x"))))
    plan = make_plan(sizes)
    params = model.abstract_params(get_reduced("llama3_8b"))
    return sum(4 * math.prod(n // plan.axis_size(s[i] if i < len(s) else None)
                             for i, n in enumerate(t.shape))
               for t, s in zip(tree_util.leaves(params),
                               tree_util.leaves(param_specs(plan, params))))


@pytest.mark.parametrize("mesh", ("2x2", "2x1", "1x4"))
def test_train_collectives_equal_the_analytic_count(mesh):
    rec = _run("--mesh-shape", mesh, "--steps", "2")
    assert rec["collectives"] == rec["analytic_collectives"]
    assert rec["collectives_same_each_step"]
    assert rec["param_bytes"] == rec["grad_bytes"] == _rank0_bytes(mesh)
    assert rec["opt_bytes"] == 2 * rec["param_bytes"] + 4       # mu, nu and the int32 step


def test_record_fields_and_note():
    rec = _run("--mesh-shape", "2x2", "--steps", "1")
    assert set(FIELDS) <= set(rec)
    assert rec["peak_gb"] is None and rec["fwd_bwd_peak_gb"] is None
    assert rec["world"] == 4 and rec["mesh"] == "2x2" and rec["kind"] == "train"
    assert "no data moved" in rec["note"] and "not meaningful" in rec["note"]
    assert len(rec["step_seconds"]) == 1 and rec["shape_log_step_s"] is None   # no gate: no log
    assert all(rec[k] > 0 for k in ("compute_term_s", "memory_term_s", "collective_term_s"))


def _under_the_log(monkeypatch, kind):
    """Record, for each step the dry run takes, whether a shape log was
    open around it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from repro_torch.dist.shape_log import ShapeLog
    from repro_torch.launch import steps
    from repro_torch.models import decode

    seen = []

    def logged():
        seen.append(isinstance(_get_current_dispatch_mode(), ShapeLog))

    if kind == "prefill":
        prefill = decode.prefill

        def spy(*a, **kw):
            logged()
            return prefill(*a, **kw)

        monkeypatch.setattr(decode, "prefill", spy)
    else:
        make = steps.make_train_step

        def spy_make(*a, **kw):
            step = make(*a, **kw)

            def spy(*args):
                logged()
                return step(*args)
            return spy

        monkeypatch.setattr(steps, "make_train_step", spy_make)
    return seen


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_timed_steps_run_without_the_shape_log(monkeypatch, kind):
    """The warm-up, then the gates' step alone under the log (untimed, its
    time apart), then ``--steps`` timed steps without it; every step
    issues the same collectives."""
    seen = _under_the_log(monkeypatch, kind)
    if kind == "prefill":
        rec = _run("--mesh-shape", "1x1x4x1", "--steps", "2", "--require-seq-sharded",
                   "--require-flash", shape="prefill_32k", batch=1, seq=2560)
        assert rec["seq_sharded_ok"] and rec["ring_p2p"] == 2 * 3 * 2
    else:                            # one row a data rank: no score tensor of 1 MiB
        rec = _run("--mesh-shape", "2x1", "--steps", "2", "--require-flash", batch=2)
    assert seen == [False, True, False, False]
    assert rec["no_s2_scores_ok"] and len(rec["step_seconds"]) == 2
    assert rec["s_per_step"] == pytest.approx(sum(rec["step_seconds"]) / 2, rel=1e-12)
    assert rec["shape_log_step_s"] > 0 and rec["shape_log_step_s"] not in rec["step_seconds"]
    assert rec["collectives_same_each_step"]


@pytest.mark.parametrize("mesh", ("1x2", "1x4"))
def test_prefill_under_the_serve_plan(mesh):
    rec = _run("--mesh-shape", mesh, "--steps", "1", shape="prefill_32k")
    assert rec["kind"] == "prefill"
    coll = rec["collectives"]
    assert set(coll) == {"model"}
    assert coll["model"]["all-gather"]["count"] == 2            # the two vocab tables
    assert coll["model"]["all-reduce"]["count"] == 2 * 2        # attention + SwiGLU, 2 layers
    assert coll["model"]["all-reduce"]["bytes"] == 4 * 4 * 128 * 256 * 4


# (model all-gathers, model all-reduces) of a reduced prefill, 2 layers, B 4, S 128:
# the two vocab tables (+ vis_proj; + each Mamba2 in-projection's output);
# RWKV6: each layer's time-mix output and channel-mix v; Zamba2: each Mamba2
# layer's norm statistics and output, each shared block's attention and SwiGLU;
# Seamless: each encoder layer's attention and SwiGLU, the BOS decode step's
# self-attention, cross-attention and SwiGLU a layer.
FAMILY_PREFILL = {"rwkv6_7b": (2, 4), "zamba2_7b": (4, 8), "seamless_m4t_large_v2": (2, 10),
                  "internvl2_26b": (3, 4)}


@pytest.mark.parametrize("arch", FAMILY_PREFILL)
def test_family_prefill_under_the_serve_plan(arch):
    rec = _run("--mesh-shape", "1x2", "--steps", "1", shape="prefill_32k", arch=arch)
    coll = rec["collectives"]
    assert rec["kind"] == "prefill" and set(coll) == {"model"}
    gathers, reduces = FAMILY_PREFILL[arch]
    assert coll["model"]["all-gather"]["count"] == gathers
    assert coll["model"]["all-reduce"]["count"] == reduces


def test_gates_hold_on_a_seq_sharded_prefill():
    rec = _run("--mesh-shape", "1x1x4x1", "--steps", "1", "--require-seq-sharded",
               "--require-flash", shape="prefill_32k", batch=1, seq=2560)
    assert rec["seq_sharded_ok"] and rec["full_seq_intermediates"] == []
    assert rec["no_s2_scores_ok"] and rec["s2_offenders"] == []
    assert rec["ring_p2p"] == 2 * 3 * 2        # rank 0: 2 layers x 3 rotations x (k, v)


def test_seq_gate_fails_without_a_seq_axis():
    with pytest.raises(AssertionError, match="full-seq intermediates"):
        _run("--mesh-shape", "1x2", "--steps", "1", "--require-seq-sharded",
             shape="prefill_32k")
    assert not dist.is_initialized()


def test_flash_gate_fails_on_dense_scores():
    with pytest.raises(AssertionError, match=r"O\(S\^2\) score tensors"):
        _run("--mesh-shape", "1x2", "--steps", "1", "--require-flash", shape="prefill_32k",
             seq=512)
    assert not dist.is_initialized()


def test_collective_term_counts_wire_bytes():
    from repro_torch.dist.collectives import Record
    from repro_torch.launch.dryrun import NVLINK_BW, wire_bytes

    recs = [Record("all-gather", "data", "float32", 800, 2),
            Record("reduce-scatter", "data", "float32", 400, 2),
            Record("all-reduce", "model", "bfloat16", 1000, 4),
            Record("send/recv", "seq", "float32", 64, 2)]
    assert wire_bytes(recs) == 400 + 400 + 1500 + 64
    rec = _run("--mesh-shape", "2x2", "--steps", "1")
    want = 0
    for axis, kinds in rec["collectives"].items():
        for kind, v in kinds.items():
            want += wire_bytes([Record(kind, axis, "float32", v["bytes"], 2)])
    assert rec["collective_term_s"] == pytest.approx(want / NVLINK_BW, rel=1e-9)


def test_refuses_an_initialized_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="initialized already"):
            _run("--mesh-shape", "2x2")
    finally:
        dist.destroy_process_group()


def test_analytic_count_refuses_other_families():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.dryrun import analytic_collectives

    with pytest.raises(ValueError, match="dense family"):
        analytic_collectives(get_reduced("granite_moe_1b_a400m"), {"data": 2, "model": 2}, 4, 128)


def test_full_width_count_at_the_card_cell():
    """The count the card's dry run is held to: Llama-3-8B, data 2 x model
    2, one 4,096-token sequence a data rank (PERF.md's analytic count)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import analytic_collectives

    got = analytic_collectives(get_config("llama3_8b"), {"data": 2, "model": 2}, 2, 4096)
    assert got == {
        "data": {"all-gather": {"count": 450, "bytes": 30018633728},
                 "reduce-scatter": {"count": 226, "bytes": 8029995008},
                 "all-reduce": {"count": 68, "bytes": 1065004}},
        "model": {"all-gather": {"count": 2, "bytes": 4202692608},
                  "all-reduce": {"count": 161, "bytes": 5368709156}}}


TRAIN_GATE = ["--arch", "llama3_8b", "--reduced", "--shape", "train_4k", "--batch", "8",
              "--seq", "2304", "--steps", "1", "--require-seq-sharded"]
_GATE_RUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
try:
    rec = dryrun.main(sys.argv[1:], device="cpu")
    print("GATE-RECORD " + json.dumps(rec))
except AssertionError as e:
    print("GATE-FAILED " + str(e))
"""


# the seq gate's verdict, JAX's and the port's, on a seq 2 mesh: case ->
# (arch, shape kind); B = 1, 2,304 positions (> 2,048: chunked attention in
# training, the ring in the Seamless prefill; every sequence divides over
# seq and the Zamba2 scan's 64-position chunk; the Seamless target is 288)
VERDICT_CASES = {"zamba2_train": ("zamba2_7b", "train"),
                 "seamless_train": ("seamless_m4t_large_v2", "train"),
                 "seamless_prefill": ("seamless_m4t_large_v2", "prefill")}
VERDICT_B, VERDICT_S = 1, 2304
_JAX_GATES = r"""
import dataclasses, json, re, sys
from repro.configs import get_reduced
from repro.dist.hlo_analysis import full_length_intermediates
from repro.launch import steps
from repro.launch.mesh import make_production_mesh
from repro.models.config import InputShape
from repro.optim import adamw
b, s = int(sys.argv[1]), int(sys.argv[2])
mesh = make_production_mesh(shape=(1, 1, 2, 1))
gathered = re.compile(r"= (\w+)\[([\d,]*)\]\S* all-gather(?:-start)?\(")
out = {}
for case in sys.argv[3:]:
    arch, kind = case.split(":")[1:]
    cfg = get_reduced(arch)
    if kind == "prefill":              # as the port's dry run serves it: flash, the ring
        cfg = dataclasses.replace(cfg, attn_impl="flash")
        lowered = steps.lower_prefill_step(cfg, mesh, InputShape("p", s, b, "prefill"))
    else:
        lowered = steps.lower_train_step(cfg, mesh, InputShape("t", s, b, "train"), adamw(1e-3))
    hlo = lowered.compile().as_text()
    offenders = full_length_intermediates(hlo, s, min_bytes=2 * b * s * cfg.d_model)
    out[case.split(":")[0]] = {"offenders": offenders, "all_gathers": sorted(
        {f"{d}[{dims}]" for d, dims in gathered.findall(hlo)})}
print("JAX-GATES " + json.dumps(out))
"""


def _port_verdicts() -> dict:
    """The port's seq gate on each VERDICT_CASES case (this process, the
    fake group): ``{case: offenders}``, empty where the gate holds."""
    from repro_torch.launch import dryrun

    out = {}
    for case, (arch, kind) in VERDICT_CASES.items():
        try:
            _run("--mesh-shape", "1x1x2x1", "--steps", "1", "--require-seq-sharded",
                 arch=arch, shape="train_4k" if kind == "train" else "prefill_32k",
                 batch=VERDICT_B, seq=VERDICT_S)
            out[case] = []
        except AssertionError as e:
            out[case] = e.offenders
        assert not dist.is_initialized()
    return out


@pytest.fixture(scope="module")
def train_gates():
    """The train gate on ``1x2x2x2`` and on ``1x2x1x2``, each in its own
    subprocess, and the JAX package's seq gate on VERDICT_CASES in a third,
    all at once, while this process runs the port's verdicts:
    ``{mesh: record or the gate's message, "jax": {case: ...}, "port":
    {case: offenders}}``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = {mesh: subprocess.Popen([sys.executable, "-c", _GATE_RUN, *TRAIN_GATE,
                                     "--mesh-shape", mesh], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env, cwd=root)
             for mesh in ("1x2x2x2", "1x2x1x2")}
    jax_env = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs["jax"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_GATES, str(VERDICT_B), str(VERDICT_S),
         *(f"{case}:{arch}:{kind}" for case, (arch, kind) in VERDICT_CASES.items())],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jax_env, cwd=root)
    out = {}
    try:
        out["port"] = _port_verdicts()
        for mesh, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
            line = [ln for ln in stdout.splitlines() if ln.startswith(("GATE-", "JAX-GATES"))][-1]
            if mesh == "jax":
                out[mesh] = json.loads(line[len("JAX-GATES "):])
            else:
                out[mesh] = (json.loads(line[len("GATE-RECORD "):])
                             if line.startswith("GATE-RECORD") else line[len("GATE-FAILED "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def test_train_gate_holds_on_a_seq_axis(train_gates):
    rec = train_gates["1x2x2x2"]
    assert isinstance(rec, dict), rec
    assert rec["kind"] == "train" and rec["seq_sharded_ok"] and rec["full_seq_intermediates"] == []
    seq = rec["collectives"]["seq"]
    # 2 layers: K and V gathered in the forward and again in the recompute,
    # reduce-scattered in the backward; the gradient sums and the loss's
    assert seq["all-gather"]["count"] == 2 * 2 * 2
    assert seq["reduce-scatter"]["count"] == 2 * 2
    assert seq["all-reduce"]["count"] > 0
    assert rec["collectives_same_each_step"]


def test_train_gate_fails_without_a_seq_axis(train_gates):
    msg = train_gates["1x2x1x2"]
    assert isinstance(msg, str) and "full-seq intermediates" in msg and "seq=1" in msg, msg


def _tensor(label: str) -> tuple:
    """(dtype, elements) of an ``f32[1,2304,256]`` or ``float32[...]``
    shape label: the tensor up to its layout."""
    dtype, dims = label.rstrip("]").split("[")
    return ({"f32": "float32", "bf16": "bfloat16"}.get(dtype, dtype),
            math.prod(int(d) for d in dims.split(",") if d))


# the tensor both steps hold whole, by (dtype, elements): the port's
# offender, and the JAX step's offender or all-gather result
SAME_TENSOR = {
    # K (and V) of the shared attention gathered over seq: the port's
    # (1, 2304, 4, 64) offender; JAX gathers it as (1, 36, 64, 4, 64) chunks,
    # which the gate's rule does not read as full-length. JAX's own
    # offenders are the Mamba2 conv input laid out on channels, (1, 2304,
    # 272): the port keeps that one on the sequence, with a halo
    "zamba2_train": ("float32", VERDICT_B * VERDICT_S * 4 * 64),
    # the source frames whole: JAX's replicated input (in f32 after its
    # convert), the port's encoder memory gathered over seq
    "seamless_train": ("float32", VERDICT_B * VERDICT_S * 256),
    # a layer's cross k/v over the whole memory, the cache that seq never cuts
    "seamless_prefill": ("float32", VERDICT_B * VERDICT_S * 4 * 64),
}


@pytest.mark.parametrize("case", VERDICT_CASES)
def test_seq_gate_verdict_equals_jax(train_gates, case):
    """JAX's verdict and the port's agree (each fails: ROADMAP's reference
    state), and they fail on the same tensor up to its layout. The gate's
    threshold is 2 B_loc S d_model in both packages."""
    jax_case, port = train_gates["jax"][case], train_gates["port"][case]
    assert bool(jax_case["offenders"]) == bool(port)
    assert port and jax_case["offenders"]
    want = SAME_TENSOR[case]
    assert want in {_tensor(o["shape"]) for o in port}, port[:5]
    held = {_tensor(o["shape"]) for o in jax_case["offenders"]} | {
        _tensor(label) for label in jax_case["all_gathers"]}
    assert want in held, (jax_case["offenders"][:5], jax_case["all_gathers"])
    if case == "zamba2_train":
        assert {o["shape"] for o in jax_case["offenders"]} == {"f32[1,2304,272]"}
