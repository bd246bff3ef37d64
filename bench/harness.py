"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the limits ``limits/<workload>.json``, one
reader ``metrics/<metric>.py`` per per-layer metric, and the driver
``drivers/<driver>.py`` that the configuration names: what builds the
program under test (``repro_torch``, ``src/`` of the checkout), calls it
in the window and judges its outputs (``bench/drivers/__init__.py``).
This module holds what every cell shares.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import check
from bench import trace as bench_trace

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunFailure(RuntimeError):
    """The run cannot give a result: it prints none and exits non-zero."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """The workload's entry and everything it names, read from files under
    ``root``. Its per-layer metrics are those that apply to the cell:
    without a ``workloads`` key, or with the cell in it."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunFailure(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config_file = configs[cell["config"]]["file"]
    config = load_json(root / config_file)
    if "driver" not in config:
        raise RunFailure(f"{config_file} names no driver: it needs a \"driver\" key")

    return {
        "cell": cell,
        "config": config,
        "traffic": load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(root / "bench" / "limits" / f"{workload}.json"),
        "end_to_end": spec["end_to_end"],
        "per_layer": [m for m in spec["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX pulled in
    by a library on the program's behalf."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def note(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------------ driver

def load_driver(spec: dict):
    """The cell's driver, ``bench.drivers.<driver>``, as its configuration
    names it."""
    return importlib.import_module(f"bench.drivers.{spec['config']['driver']}")


def below_precision(driver, state, spec: dict, on_card: bool) -> int:
    """One more round of the timed entry (``driver.warm``), under the
    profiler: how many of its device kernels do math below the
    configuration's precision (its ``below_precision`` markers). Run after
    the window and after the call's outputs are taken."""
    names, _ = bench_trace.kernel_names(lambda: driver.warm(state, spec["traffic"]), on_card)
    return bench_trace.below_precision(names, spec["config"]["below_precision"])


# ------------------------------------------------------------------- a run

def device_info(count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, spec: dict | None = None) -> dict:
    """One run; returns the result object (``check`` last). ``device`` and
    ``spec`` let a test drive the run on the CPU.

    Backward passes run on the calling thread, not on autograd's device
    thread, so that the program allocates from one thread in one order:
    with the device thread, about one timed call in seventy raised the
    run's peak memory by 0.28 or 0.41 GB (H100, FEMNIST fleet at C 128)."""
    with torch.autograd.set_multithreading_enabled(False):
        return _run_cell(workload, seed, seconds, trace, t_start, device, spec)


def _run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
              device, spec: dict | None) -> dict:
    spec = cell_spec(workload) if spec is None else spec
    chips = spec["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunFailure(f"needs {chips} CUDA device(s); "
                             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = torch.device("cuda")
    on_card = torch.device(device).type == "cuda"
    traffic = spec["traffic"]
    driver = load_driver(spec)
    rounds = driver.rounds_per_call(traffic)

    def peak() -> str:
        if not on_card:
            return ""
        asked = torch.cuda.memory_stats()["requested_bytes.all.peak"]
        return f", peak {torch.cuda.max_memory_allocated()} B (requested {asked} B)"

    note(f"imports {time.perf_counter() - t_start:.2f} s")
    state = driver.build(spec, seed, device)
    note(f"build done at {time.perf_counter() - t_start:.2f} s{peak()}")
    driver.warm(state, traffic)
    setup_s = time.perf_counter() - t_start
    note(f"set-up {setup_s:.2f} s{peak()}")

    attempted = failed = 0
    metrics, dev, breakdown = {}, {}, None
    if not trace:
        t0 = time.perf_counter()
        while True:
            res = driver.call(state, traffic)
            attempted += rounds
            failed += driver.failed(res)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        note(f"window {window_s:.3f} s, {attempted} rounds{peak()}")
        e2e = {"round_ms": window_s / attempted * 1e3,
               "setup_s": setup_s}
        if on_card:
            e2e["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
    else:
        t0 = time.perf_counter()
        res = driver.call(state, traffic)        # untraced: the round time beside the trace
        untraced_round_s = (time.perf_counter() - t0) / rounds
        attempted += rounds
        failed += driver.failed(res)
        try:
            view, res = bench_trace.capture(lambda: driver.call(state, traffic), rounds, on_card)
        except bench_trace.EmptyTrace as e:
            raise RunFailure(f"{e}: no per-layer metric can be read") from e
        attempted += rounds
        failed += driver.failed(res)
        ctx = {"view": view, "config": spec["config"], "traffic": traffic, "driver": driver,
               "untraced_round_s": untraced_round_s,
               "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu"}
        for m in spec["per_layer"]:
            value = importlib.import_module(f"bench.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": view.busy_s(), "window_s": view.window_s()}
        breakdown = {"device_ops": view.top_device_ops(10), "idle_gaps": view.idle_gaps(10)}

    device_fields = device_info(chips) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    device_fields.update(dev)
    run = driver.outputs(state, res)
    t_k = time.perf_counter()
    run["below_precision"] = below_precision(driver, state, spec, on_card)
    note(f"precision round {time.perf_counter() - t_k:.2f} s, "
         f"{run['below_precision']} kernels below the stated precision")
    del state, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, raw = driver.judge(spec, seed, run, device)
    note(f"reference {time.perf_counter() - t_ref:.2f} s")
    out = {"correct": failed == 0 and check.correct(nums), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_fields}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["readings"] = {k: (np.asarray(v).tolist() if not np.isscalar(v) else v)
                       for k, v in raw.items()}
    out["check"] = nums
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except RunFailure as e:
        print(f"bench: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}: the benchmark measures the port alone",
              file=sys.stderr, flush=True)
        return 3
    for name, n in out["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
