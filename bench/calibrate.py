"""The readings a cell's limits are set from (``limits/<workload>.json``):
sound runs of the program, and the control, on the card.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 \
        [--faults stale_step,half_batch,altered_level]

A sound seed builds the cell's fleet, makes one call of the timed entry
and judges it as a run does; then one more call under each fault of
``bench/faults.py`` on the same fleet, each judged. A control seed puts the plain reference in
the program's place, computed in float32 with TF32 on (the precision
below the configuration's float32 with TF32 off), and judges that. One
JSON line a seed on standard output. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import faults, harness  # noqa: E402
from bench import trace as bench_trace  # noqa: E402
from bench.reference import fleet  # noqa: E402
from bench.reference.data import FleetData  # noqa: E402


def _plain(raw: dict) -> dict:
    return {k: (np.asarray(v).tolist() if not np.isscalar(v) else v) for k, v in raw.items()}


def control_outputs(spec: dict, seed: int, device) -> dict:
    """The reference in the program's place, in float32 with TF32 on; its
    first round's kernels read as a run's precision round is."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    one = dict(spec["traffic"], rounds_per_call=1)
    try:
        names, _ = bench_trace.kernel_names(
            lambda: fleet.simulate(spec["config"], one, seed, device, torch.float32), True)
        out = fleet.simulate(spec["config"], spec["traffic"], seed, device, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd
    out["below_precision"] = bench_trace.below_precision(
        names, spec["config"]["below_precision"])
    out["model"] = {a: {b: t.numpy() for b, t in leaves.items()}
                    for a, leaves in out["model"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    harness.environment()
    spec = harness.cell_spec(args.workload)
    dev = torch.device("cuda")
    planted = [f for f in args.faults.split(",") if f]

    def report(kind, seed, t0, run, data=None):
        gc.collect()
        torch.cuda.empty_cache()
        nums, raw = harness.judge(spec, seed, run, dev, data=data)
        print(json.dumps({"kind": kind, "seed": seed, "workload": args.workload,
                          "seconds": time.perf_counter() - t0,
                          "numbers": nums, "readings": _plain(raw)}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        sim = harness.build(spec, seed, dev)
        runs = [("sound", harness.outputs(sim, harness.call(sim, spec["traffic"])))]
        for name in planted:
            with faults.FAULTS[name]():
                runs.append((name, harness.outputs(sim, harness.call(sim, spec["traffic"]))))
        below = harness.below_precision(sim, spec)
        for _, run in runs:
            run["below_precision"] = below
        del sim
        data = FleetData(spec["config"])
        for kind, run in runs:
            report(kind, seed, t0, run, data)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        report("control", seed, time.perf_counter(), control_outputs(spec, seed, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
