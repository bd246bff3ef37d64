"""The harness's driver seam, on the CPU: a cell whose configuration names
a driver that exists only in this file (a few seeded float32 matrix
"rounds", judged against float64) runs through ``harness.run_cell``,
timed and traced, with no file under ``bench/`` changed to admit it. A
fault planted in that driver is not correct; a configuration that names
no driver is refused with its file named; ``round_mfu`` leaves a driver
with no operation count out."""
import json
import math
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 54321
DRIVER = "matmul_only_in_a_test"
WORKLOAD = "matmul_rounds"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matmul_driver(skip_round: bool = False) -> types.ModuleType:
    """A driver module: ``x <- tanh(A x / sqrt(n))``, ``rounds`` times a
    call, A from the configuration's data seed and x from the run's.
    ``skip_round``: every call leaves its last round out (a step that
    returns its state unchanged)."""
    mod = types.ModuleType(f"bench.drivers.{DRIVER}")

    def inputs(cfg, seed, device, dtype):
        data = torch.Generator(device=device).manual_seed(cfg["data_seed"])
        run = torch.Generator(device=device).manual_seed(seed)
        n = cfg["n"]
        a = torch.randn((n, n), generator=data, device=device).to(dtype)
        return a, torch.randn((n,), generator=run, device=device).to(dtype)

    def rounds(a, x, k):
        out = []
        for _ in range(k):
            x = torch.tanh(a @ x / math.sqrt(a.shape[0]))
            out.append(x)
        return x, out

    def build(spec, seed, device):
        a, x = inputs(spec["config"], seed, device, torch.float32)
        return {"a": a, "x0": x, "x": x}

    def call(state, traffic):
        k = traffic["rounds"] - (1 if skip_round else 0)
        state["x"], out = rounds(state["a"], state["x0"], k)
        with torch.profiler.record_function("results_to_host"):
            out = [x.cpu().numpy() for x in out]
        return out + out[-1:] * (traffic["rounds"] - k)

    def judge(spec, seed, run, device):
        a, x = inputs(spec["config"], seed, device, torch.float64)
        _, ref = rounds(a, x, spec["traffic"]["rounds"])
        ref = np.stack([r.numpy() for r in ref])
        raw = {"x_err": float(np.max(np.abs(run["x"] - ref)) / np.max(np.abs(ref))),
               "below_precision": run["below_precision"]}
        lim = spec["limits"]["limits"]
        return {k: {"value": float(raw[k]), "limit": lim[k]} for k in lim}, raw

    mod.build = build
    mod.warm = lambda state, traffic: rounds(state["a"], state["x0"], 1)
    mod.call = call
    mod.rounds_per_call = lambda traffic: traffic["rounds"]
    mod.failed = lambda res: int(sum(not np.all(np.isfinite(x)) for x in res))
    mod.outputs = lambda state, res: {"x": np.stack(res).astype(np.float64)}
    mod.judge = judge
    mod.check_files = lambda spec: None
    return mod


def _write_cell(root: Path, config: dict) -> None:
    """A checkout's files of one matmul cell under ``root``."""
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir()
    (root / "bench" / "limits").mkdir()
    metric = {"unit": "launches", "better": "lower", "source": "device_trace",
              "layer": "device", "moves": "round_ms"}
    spec = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"], "run_seconds": 1,
        "configs": [{"name": "matmul", "source": "a test", "file": "bench/configs/matmul.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": WORKLOAD, "config": "matmul", "traffic": "four",
                       "chips": 1, "why": "a test"}],
        "end_to_end": [
            {"name": "round_ms", "unit": "ms", "better": "lower", "bound": 0.1,
             "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            dict(metric, name="call_end_wait_ms", source="program_span", unit="ms",
                 layer="round loop"),
            dict(metric, name="round_mfu", unit="%", better="higher", source="host_clock"),
            # a reader of another kind of cell: this cell never reads it
            dict(metric, name="greedy_host_ms", unit="ms", source="program_span",
                 layer="decision", workloads=["some_other_cell"]),
        ],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "bench" / "configs" / "matmul.json").write_text(json.dumps(config))
    (root / "bench" / "traffic" / "four.json").write_text(json.dumps({"rounds": 4}))
    (root / "bench" / "limits" / f"{WORKLOAD}.json").write_text(json.dumps(
        {"limits": {"x_err": 1e-5, "below_precision": 0}}))


CONFIG = {"name": "matmul", "driver": DRIVER, "n": 48, "data_seed": 7,
          "below_precision": ["tf32", "bf16"], "reduced": []}


@pytest.fixture
def cell(tmp_path, monkeypatch):
    """(spec, install): the cell's spec read from its files by the
    harness; ``install(driver)`` registers a driver module under the name
    its configuration gives."""
    from bench import harness

    _write_cell(tmp_path, CONFIG)

    def install(driver):
        monkeypatch.setitem(sys.modules, f"bench.drivers.{DRIVER}", driver)

    install(_matmul_driver())
    return harness.cell_spec(WORKLOAD, tmp_path), install


def _run(spec, trace):
    from bench import harness

    return harness.run_cell(WORKLOAD, SEED, 0.05, trace, time.perf_counter(),
                            device=torch.device("cpu"), spec=spec)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_cell_runs_through_a_driver_of_its_own(cell, trace):
    spec, _ = cell
    out = _run(spec, trace)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    assert out["check"]["x_err"]["value"] < 1e-6
    assert out["attempted"] >= 4 and out["attempted"] % 4 == 0 and out["failed"] == 0
    if trace:
        # the per-layer loop: the reader of the call's copy to the host
        # reports; round_mfu has no operation count to read, and the other
        # kind of cell's reader is not read at all
        assert set(out["metrics"]) == {"call_end_wait_ms"}
        assert out["metrics"]["call_end_wait_ms"]["value"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"round_ms", "setup_s"}
        assert out["metrics"]["round_ms"]["value"] > 0
        assert out["metrics"]["setup_s"]["value"] > 0


def test_a_fault_planted_in_the_driver_is_not_correct(cell):
    spec, install = cell
    install(_matmul_driver(skip_round=True))
    out = _run(spec, False)
    assert not out["correct"], out["check"]
    assert out["check"]["x_err"]["value"] > 1e-5


def test_a_config_without_a_driver_is_refused_with_its_file_named(tmp_path):
    from bench import harness

    _write_cell(tmp_path, {k: v for k, v in CONFIG.items() if k != "driver"})
    with pytest.raises(harness.RunFailure, match="bench/configs/matmul.json"):
        harness.cell_spec(WORKLOAD, tmp_path)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu"])
def test_round_mfu_reads_the_drivers_operation_count(kind):
    from bench import harness
    from bench.metrics import round_mfu

    spec = harness.cell_spec("femnist_qccf_c128", ROOT)
    ctx = {"config": spec["config"], "traffic": spec["traffic"], "untraced_round_s": 0.1,
           "device_kind": kind, "driver": _matmul_driver()}
    assert round_mfu.read(ctx) is None
    ctx["driver"] = harness.load_driver(spec)
    got = round_mfu.read(ctx)
    if kind == "cpu":
        assert got is None
    else:
        flops = 128 * 6 * 32 * 63_886_592 + 1024 * 21_713_664
        assert got == pytest.approx(100.0 * flops / 0.1 / 67e12, rel=1e-12)


@pytest.mark.parametrize("name", ["aggregate_roofline", "local_sgd_device_ms",
                                  "kkt_solve_host_ms", "launches_per_round",
                                  "device_idle_share"])
def test_fleet_readers_find_nothing_in_a_trace_without_their_work(name):
    """A traced call of another program, on the card, whose trace holds
    none of the fleet's kernels and ranges: the fleet's readers return
    None, and so do the device's readers where the trace holds no device
    operation."""
    import importlib
    from types import SimpleNamespace

    from bench.trace import WINDOW, TraceView

    def event(n, a, b, device=False, annotation=False):
        return SimpleNamespace(name=n, time_range=SimpleNamespace(start=a, end=b),
                               device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                               is_user_annotation=annotation, is_async=False, thread=1)

    other = [event(WINDOW, 0, 100, annotation=True), event("aten::mm", 10, 20),
             event("ampere_sgemm_128x64_nn", 12, 30, device=True)]
    bare = [event(WINDOW, 0, 100, annotation=True), event("aten::mm", 10, 20)]
    reader = importlib.import_module(f"bench.metrics.{name}")
    cfg = json.loads((ROOT / "bench" / "configs" / "femnist_cnn.json").read_text())
    for events in (other, bare):
        ctx = {"view": TraceView(events, 2), "config": cfg,
               "traffic": {"n_channels": 32, "eval": True},
               "device_kind": "NVIDIA H100 80GB HBM3"}
        got = reader.read(ctx)
        if name in ("launches_per_round", "device_idle_share") and events is other:
            assert got is not None and got > 0
        else:
            assert got is None, (name, got)
