"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the limits ``limits/<workload>.json`` and one
reader ``metrics/<metric>.py`` per per-layer metric. The program under
test is ``repro_torch`` (``src/`` of the checkout): a fleet built by
``repro_torch.sim.build_sim`` in set-up, driven in the window by
back-to-back calls of ``FleetSim.run_compiled(rounds_per_call)``.
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

from bench import check, inputs
from bench import trace as bench_trace
from bench.reference import fleet
from bench.reference.data import FleetData

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunFailure(RuntimeError):
    """The run cannot give a result: it prints none and exits non-zero."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT) -> dict:
    """The workload's entry and everything it names, read from files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunFailure(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return {
        "cell": cell,
        "config": load_json(root / configs[cell["config"]]["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
        "end_to_end": spec["end_to_end"],
        "per_layer": spec["per_layer"],
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


# ------------------------------------------------------------------ program

class BenchEntropy:
    """The program's entropy seam (``repro_torch.sim.entropy``), fed from
    ``bench.inputs``: every draw keyed by (seed, round, kind)."""

    def __init__(self, seed: int, z: int, device) -> None:
        self.seed, self.z, self.device = int(seed), int(z), device

    def rates(self, ridx, channel):
        from repro_torch.sim.channel import draw_rates

        nx, ny = inputs.rate_normals(self.seed, ridx, channel.shape, self.device)
        return draw_rates(nx, ny, channel.params, channel.distances, channel.association)

    def batch_indices(self, ridx, n_s, tau, batch_size):
        u = inputs.batch_uniforms(self.seed, ridx, n_s.shape[0], tau, batch_size, self.device)
        return inputs.batch_rows(u, n_s)

    def uniforms(self, ridx, s, zpad):
        return inputs.wire_uniforms(self.seed, ridx, s, self.z, zpad, self.device)


def build(spec: dict, seed: int, device):
    """The fleet: its data from the configuration's data seed, its weights
    made on ``device`` from the run's seed, every draw of a round from the
    run's seed."""
    from repro_torch.sim import build_sim

    cfg, traffic = spec["config"], spec["traffic"]
    model = cfg["model"]
    flat = inputs.init_flat(seed, model, device)
    params = {a: {b: t.clone() for b, t in leaves.items()}
              for a, leaves in inputs.unflatten(flat, model).items()}
    return build_sim(
        cfg["task"], scenario=cfg["scenario"], n_clients=cfg["n_clients"],
        n_channels=traffic["n_channels"], mu=cfg["data"]["mu"], beta=cfg["data"]["beta"],
        lr=cfg["train"]["lr"], seed=cfg["data"]["seed"], batch_size=cfg["train"]["batch"],
        q_cap=cfg["train"]["q_cap"], n_test=cfg["data"]["n_test"],
        alpha_dirichlet=cfg["data"]["alpha_dirichlet"],
        v_weight=cfg["lyapunov"]["v_weight"], target_q=cfg["lyapunov"]["target_q"],
        policy_mode=traffic["policy"], init_params=params, device=device,
        entropy=BenchEntropy(seed, inputs.param_count(model), device),
    )


def call(sim, traffic: dict):
    """One call of the timed entry; its results are on the host on return."""
    return sim.run_compiled(traffic["rounds_per_call"], with_eval=traffic["eval"])


def warm(sim, traffic: dict) -> None:
    """One round of the timed entry: every shape a call uses (each round
    has the same shapes), every kernel built and loaded."""
    sim.run_compiled(1, with_eval=traffic["eval"])


def below_precision(sim, spec: dict) -> int:
    """One more round of the timed entry, under the profiler: how many of
    its device kernels do math below the configuration's precision (its
    ``below_precision`` markers). Run after the window and after the
    call's outputs are taken (it replaces ``final_flat``)."""
    names, _ = bench_trace.kernel_names(
        lambda: sim.run_compiled(1, with_eval=spec["traffic"]["eval"]),
        sim.device.type == "cuda")
    return bench_trace.below_precision(names, spec["config"]["below_precision"])


def outputs(sim, res) -> dict:
    """The call's results in the reference's terms."""
    model = sim.unravel(sim.final_flat)
    return {
        "energy": res.energy, "accuracy": res.accuracy, "loss": res.loss,
        "q": np.asarray(res.q_levels), "v": np.asarray(res.rates),
        "lambda1": res.lambda1, "lambda2": res.lambda2,
        "n_scheduled": np.asarray(res.n_scheduled),
        "model": {a: {b: t.detach().double().cpu().numpy() for b, t in leaves.items()}
                  for a, leaves in model.items()},
    }


def finite_rounds_failed(res) -> int:
    bad = ~(np.isfinite(res.energy) & np.isfinite(res.loss) & np.isfinite(res.lambda1)
            & np.isfinite(res.lambda2))
    return int(np.sum(bad))


# ------------------------------------------------------------------ judging

def judge(spec: dict, seed: int, run: dict, device, data=None) -> tuple[dict, dict]:
    """(compared numbers, raw readings) of a call's outputs against the
    plain reference in float64, computed after the program's state is
    freed."""
    cfg = spec["config"]
    data = FleetData(cfg) if data is None else data
    ref = fleet.simulate(cfg, spec["traffic"], seed, device, torch.float64,
                         follow={"q": run["q"], "v": run["v"]}, data=data)
    policy = importlib.import_module(f"bench.reference.policy_{spec['traffic']['policy']}")
    eps2 = policy.budgets(cfg["system"], data.sizes.astype(np.float64),
                          inputs.param_count(cfg["model"]), cfg["lyapunov"]["target_q"])[1]
    raw = check.readings(run, ref, eps2)
    return check.numbers(raw, spec["limits"]), raw


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
    rounds = traffic["rounds_per_call"]

    def peak() -> str:
        if not on_card:
            return ""
        asked = torch.cuda.memory_stats()["requested_bytes.all.peak"]
        return f", peak {torch.cuda.max_memory_allocated()} B (requested {asked} B)"

    note(f"imports {time.perf_counter() - t_start:.2f} s")
    sim = build(spec, seed, device)
    note(f"build_sim done at {time.perf_counter() - t_start:.2f} s{peak()}")
    warm(sim, traffic)
    setup_s = time.perf_counter() - t_start
    note(f"set-up {setup_s:.2f} s{peak()}")

    attempted = failed = 0
    metrics, dev, breakdown = {}, {}, None
    if not trace:
        t0 = time.perf_counter()
        while True:
            res = call(sim, traffic)
            attempted += rounds
            failed += finite_rounds_failed(res)
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
        res = call(sim, traffic)                 # untraced: the round time beside the trace
        untraced_round_s = (time.perf_counter() - t0) / rounds
        attempted += rounds
        failed += finite_rounds_failed(res)
        try:
            view, res = bench_trace.capture(lambda: call(sim, traffic), rounds, on_card)
        except bench_trace.EmptyTrace as e:
            raise RunFailure(f"{e}: no per-layer metric can be read") from e
        attempted += rounds
        failed += finite_rounds_failed(res)
        ctx = {"view": view, "config": spec["config"], "traffic": traffic,
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
    run = outputs(sim, res)
    t_k = time.perf_counter()
    run["below_precision"] = below_precision(sim, spec)
    note(f"precision round {time.perf_counter() - t_k:.2f} s, "
         f"{run['below_precision']} kernels below the stated precision")
    del sim, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums, raw = judge(spec, seed, run, device)
    note(f"reference {time.perf_counter() - t_ref:.2f} s, {raw['ties']} ties taken")
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
