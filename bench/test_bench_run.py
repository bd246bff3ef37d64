"""A whole run of the harness on the CPU at the tiny task (U = 8, C = 4,
2 rounds a call): the port against the plain reference, each planted
fault seen as not correct, and the entry point refusing to run without
a card. On the card, the control (the plain reference in float32 with
TF32 on, in the program's place) at the cell's own size is not correct;
run it there with ``python -m pytest -q bench/test_bench_run.py``. The
check's numbers on the card are in PERF.md."""
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12345


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32, the control's precision, exists only there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_spec():
    """The FEMNIST cell's spec at the program's tiny task."""
    from bench import harness

    harness.environment()
    spec = copy.deepcopy(harness.cell_spec("femnist_qccf_c128", ROOT))
    cfg = spec["config"]
    cfg.update(task="tiny", n_clients=8)
    cfg["model"] = {"in_hw": 16, "in_ch": 1, "conv_channels": [8, 8], "hidden": [32],
                    "n_classes": 10, "kernel": 3, "extra_pool": False}
    cfg["data"].update(mu=200.0, beta=40.0, n_test=64)
    spec["traffic"] = dict(spec["traffic"], n_channels=4, rounds_per_call=2)
    return spec


def _run(spec, trace=False):
    from bench import harness

    return harness.run_cell("tiny", SEED, 0.1, trace, time.perf_counter(),
                            device=torch.device("cpu"), spec=spec)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_port_matches_reference_on_the_cpu(tiny_spec, trace):
    out = _run(tiny_spec, trace)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    assert out["check"]["rounds_off"]["value"] == 0
    assert out["check"]["loss_err"]["value"] < 1e-5
    assert out["check"]["model_err"]["value"] < 1e-5
    assert out["attempted"] >= 2 and out["failed"] == 0
    if trace:
        assert "kkt_solve_host_ms" in out["metrics"] and "breakdown" in out


@pytest.mark.parametrize("fault", ["stale_step", "half_batch", "altered_level"])
def test_a_planted_fault_is_not_correct(tiny_spec, fault):
    from bench import faults

    with faults.FAULTS[fault]():
        out = _run(tiny_spec)
    assert not out["correct"], (fault, out["check"])


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "femnist_qccf_c128", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_result_line_is_json_with_the_check_last(tiny_spec):
    out = _run(tiny_spec)
    line = json.loads(json.dumps(out))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for n in line["check"].values():
        assert set(n) == {"value", "limit"}


def test_tf32_control_is_not_correct(cuda):
    from bench import calibrate, check, harness

    harness.environment()
    spec = harness.cell_spec("femnist_qccf_c128", ROOT)
    driver = harness.load_driver(spec)
    nums, _ = driver.judge(spec, SEED, calibrate.control_outputs(spec, SEED, cuda), cuda)
    assert not check.correct(nums), nums


def test_flips_count_the_wire_indices_that_differ(tiny_spec):
    """``calibrate.flips``: none where the program and the float64
    reference round every index alike (the tiny task on the CPU), many
    where local SGD hands back stale models."""
    import contextlib

    from bench import calibrate, faults
    from bench.drivers import fleet as driver
    from bench.reference.data import FleetData

    dev = torch.device("cpu")
    data = FleetData(tiny_spec["config"])
    for fault, differ in ((contextlib.nullcontext, False), (faults.stale_step, True)):
        sim = driver.build(tiny_spec, SEED, dev)
        planes = []
        with calibrate.program_wire(planes), fault():
            run = driver.outputs(sim, driver.call(sim, tiny_spec["traffic"]))
        got = calibrate.flips(tiny_spec, SEED, run, planes, dev, data)
        assert len(got) == tiny_spec["traffic"]["rounds_per_call"]
        assert (sum(r[0] for r in got) > 0) == differ, got
