"""The readings a model-round cell's limits are set from
(``limits/<workload>.json``): sound runs of the program, its controls, and
the reference computed in the precision below the stated one, on the card.

    python3 bench/calibrate_model.py --workload <name> --seeds 1,2,3 \
        [--faults <names in model_faults.FAULTS, comma-separated; default all>] \
        [--tf32-reference 1]

For a cell of the model-round driver (``bench/drivers/model_round.py``). A
seed builds the cell's program, warms it, makes one call and judges it as
a run does (``sound``); then one more call under each control of
``bench/model_faults.py``, each judged; with ``--tf32-reference 1`` the
sound call's round is judged once more against the reference computed with
TF32 on (``tf32_reference``: must come out not correct). One JSON line a
seed on standard output. Not part of a benchmark run.
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

from bench import check, harness, model_faults  # noqa: E402
from bench import trace as bench_trace  # noqa: E402
from bench.drivers import model_round as driver  # noqa: E402


def _plain(raw: dict) -> dict:
    return {k: (np.asarray(v).tolist() if not np.isscalar(v) else v) for k, v in raw.items()}


def _judged(spec, seed, state, res, device, names, tf32_reference=False) -> dict:
    """A call judged as a run judges it, and with ``tf32_reference`` also
    against the reference computed with TF32 on; the program's models wait
    on the host meanwhile, so the reference has the card's memory as in a
    run."""
    from repro_torch import tree as tree_util

    run = driver.outputs(state, res)
    run["below_precision"] = bench_trace.below_precision(names, spec["config"]["below_precision"])
    del state["start"], state["agg"]
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for key, tf32 in (("sound", False), ("tf32_reference", True))[:1 + tf32_reference]:
        if tf32:
            run["below_precision"] = 0
        nums, raw = driver.judge(spec, seed, run, device, tf32_reference=tf32)
        out[key] = {"correct": check.correct(nums), "check": nums, "readings": _plain(raw)}
    state["agg"] = tree_util.map(lambda t: t.to(device), run["agg"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default=",".join(model_faults.FAULTS))
    ap.add_argument("--tf32-reference", type=int, default=0)
    args = ap.parse_args(argv)
    harness.environment()
    spec = harness.cell_spec(args.workload)
    device = torch.device("cuda")
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with torch.autograd.set_multithreading_enabled(False):
            state = driver.build(spec, seed, device)
            driver.warm(state, spec["traffic"])
            line = {"seed": seed}
            names, res = bench_trace.kernel_names(lambda: driver.call(state, spec["traffic"]),
                                                  True)
            line.update(_judged(spec, seed, state, res, device, names,
                                tf32_reference=bool(args.tf32_reference)))
            for name in faults:
                with model_faults.FAULTS[name]():
                    names, res = bench_trace.kernel_names(
                        lambda: driver.call(state, spec["traffic"]), True)
                    line[name] = _judged(spec, seed, state, res, device, names)["sound"]
            line["seconds"] = time.perf_counter() - t0
        del state
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
