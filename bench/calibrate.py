"""The readings a cell's limits are set from (``limits/<workload>.json``):
sound runs of the program, and the control, on the card.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 \
        [--faults stale_step,half_batch,altered_level] [--flips 1]

For a cell of the fleet driver, through its functions
(``bench/drivers/fleet.py``). A sound seed builds the cell's fleet, makes
one call of the timed entry and judges it as a run does; then one more
call under each fault of ``bench/faults.py`` on the same fleet, each
judged. A control seed puts the plain reference in the program's place,
computed in float32 with TF32 on (the precision below the configuration's
float32 with TF32 off), and judges that. One JSON line a seed on standard
output. Not part of a benchmark run.

``--flips 1`` adds to each sound seed's line, round by round, where the
program's eq.-4 wire and the float64 reference's disagree: the count of
(client, coordinate) indices that differ, the largest difference in
levels, and the norm of what those differences add to the round's
aggregate over the aggregate's norm (``flips``, below).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import faults, harness, inputs  # noqa: E402
from bench import trace as bench_trace  # noqa: E402
from bench.drivers import fleet as driver  # noqa: E402
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


@contextlib.contextmanager
def program_wire(planes: list):
    """Records each aggregate's signed wire indices (K, Zpad) and its
    eq.-2 coefficients w_k theta_k / (2^q_k - 1) (K,), on the host."""
    from repro_torch.kernels import stochastic_quant as sq

    real = sq.aggregate

    def spy(idx, signs, scales, weights, q_bits):
        k = idx.shape[0]
        mag = idx.reshape(k, -1).to(torch.int16)
        planes.append((torch.where(signs.reshape(k, -1) > 0, -mag, mag).cpu(),
                       sq.aggregate_coef(scales, weights, q_bits, k).double().cpu()))
        return real(idx, signs, scales, weights, q_bits)

    with mock.patch.object(sq, "aggregate", spy):
        yield


@contextlib.contextmanager
def reference_wire(blocks: list):
    """Records the reference's signed eq.-4 indices of each block of slots."""
    real = fleet._quantize

    def spy(flat, u, q):
        out = real(flat, u, q)
        theta = flat.abs().amax(dim=1, keepdim=True)
        levels = (2.0 ** q.to(flat.dtype) - 1.0)[:, None]
        step = torch.where(theta > 0, theta, torch.ones_like(theta)) / levels
        blocks.append(torch.round(out / step).to(torch.int16).cpu())
        return out

    with mock.patch.object(fleet, "_quantize", spy):
        yield


def flips(spec: dict, seed: int, run: dict, planes: list, device, data) -> list:
    """Round by round, [indices that differ, the largest difference in
    levels, ||sum_k c_k (idx_k - ref_k)|| / ||sum_k c_k idx_k||] between the
    program's wire (``planes``) and the float64 reference's, which follows
    the run's decisions; c_k the program's eq.-2 coefficients."""
    blocks = []
    with reference_wire(blocks):
        fleet.simulate(spec["config"], spec["traffic"], seed, device, torch.float64,
                       follow={"q": run["q"], "v": run["v"]}, data=data)
    z, out = inputs.param_count(spec["config"]["model"]), []
    for (prog, coef), k in zip(planes, np.asarray(run["n_scheduled"]).tolist()):
        ref, got = [], 0
        while got < k:
            ref.append(blocks.pop(0))
            got += ref[-1].shape[0]
        ref = torch.cat(ref).double() if ref else torch.zeros(0, z, dtype=torch.float64)
        p = prog[:k, :z].double()
        diff = p - ref
        c = coef[:k, None]
        out.append([int((diff != 0).sum()), float(diff.abs().max()) if k else 0.0,
                    float((c * diff).sum(0).norm() / max(float((c * p).sum(0).norm()), 1e-300))])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--flips", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.environment()
    spec = harness.cell_spec(args.workload)
    if harness.load_driver(spec) is not driver:
        ap.error(f"{args.workload} is not a cell of the fleet driver")
    dev = torch.device("cuda")
    planted = [f for f in args.faults.split(",") if f]

    def report(kind, seed, t0, run, data=None, extra=None):
        gc.collect()
        torch.cuda.empty_cache()
        nums, raw = driver.judge(spec, seed, run, dev, data=data)
        print(json.dumps({"kind": kind, "seed": seed, "workload": args.workload,
                          "seconds": time.perf_counter() - t0,
                          "numbers": nums, "readings": _plain(raw), **(extra or {})}),
              flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        sim = driver.build(spec, seed, dev)
        planes = []
        with program_wire(planes) if args.flips else contextlib.nullcontext():
            runs = [("sound", driver.outputs(sim, driver.call(sim, spec["traffic"])))]
        for name in planted:
            with faults.FAULTS[name]():
                runs.append((name, driver.outputs(sim, driver.call(sim, spec["traffic"]))))
        below = harness.below_precision(driver, sim, spec, True)
        for _, run in runs:
            run["below_precision"] = below
        del sim
        data = FleetData(spec["config"])
        for kind, run in runs:
            extra = ({"flips": flips(spec, seed, run, planes, dev, data)}
                     if args.flips and kind == "sound" else None)
            report(kind, seed, t0, run, data, extra)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        report("control", seed, time.perf_counter(), control_outputs(spec, seed, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
