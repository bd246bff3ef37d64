"""An audit of one traced call of a cell's program, on the card: what the
per-layer readers rest on, which a result line does not show.

    python3 bench/trace_audit.py --seed <n> [--workload <cell>] [--out <file>]

Prints one JSON object: the untraced and the traced call's round time
(what tracing costs), the call's device operations a round split by layer
on the device's timeline (``bench.spans.launch_split``) and by the host's
CUDA launch, copy and set calls inside each layer's host records, the
shared clock (how many of the ranges' spans on the device's timeline start
before the host record they come from, paired by the record's id) and the
least time from a launch call to its operation's start early and late in
the call (the two clocks' drift), and the top idle gaps. Not part of a
run: it builds the cell through its driver as ``bench/run.py`` does and exits non-zero
without a card.
"""
from __future__ import annotations

import bisect
import json
import sys
import time
from pathlib import Path

# the host's CUDA runtime calls that put one operation on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _on(e, kind: str) -> bool:
    return str(getattr(e, "device_type", "")).endswith(kind)


def clock_violations(events, names) -> tuple[int, int]:
    """(spans on the device's timeline that start before their host
    record, spans paired): a range's span there carries its host record's
    id."""
    host = {e.id: e.time_range.start for e in events
            if _on(e, "CPU") and e.is_user_annotation and e.name in names}
    paired = [(host[e.id], e.time_range.start) for e in events
              if _on(e, "CUDA") and e.is_user_annotation and e.name in names and e.id in host]
    return sum(d < h for h, d in paired), len(paired)


def launch_lags(events) -> list[tuple[float, float]]:
    """(launch call's start, its operation's start less the call's) of
    every device operation whose launch call the trace holds, in time
    order. A lag below 0 is the two clocks' disagreement."""
    launched = {e.id: e.time_range.start for e in events
                if _on(e, "CPU") and e.name in LAUNCH_CALLS}
    return sorted((launched[e.id], e.time_range.start - launched[e.id]) for e in events
                  if _on(e, "CUDA") and not e.is_user_annotation and e.id in launched)


def host_launch_split(view, events) -> dict[str, float]:
    """The host's launch calls a round inside each layer's host records,
    and those inside none under ``spans.OUTSIDE``."""
    from bench import spans
    from bench.trace import _union

    calls = sorted(e.time_range.start for e in events if _on(e, "CPU")
                   and e.name in LAUNCH_CALLS and view.lo <= e.time_range.start <= view.hi)

    def inside(names):
        return sum(bisect.bisect_right(calls, b) - bisect.bisect_left(calls, a)
                   for a, b in _union(spans.host_records(view, names)))

    split = {name: inside((name,)) / view.rounds for name in spans.LAYERS}
    split[spans.OUTSIDE] = (len(calls) - inside(spans.LAYERS)) / view.rounds
    return split


def audit(workload: str, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import harness, spans
    from bench.trace import WINDOW, TraceView

    spec = harness.cell_spec(workload)
    traffic = spec["traffic"]
    driver = harness.load_driver(spec)
    rounds = driver.rounds_per_call(traffic)
    with torch.autograd.set_multithreading_enabled(False):
        state = driver.build(spec, seed, torch.device("cuda"))
        driver.warm(state, traffic)
        t = time.perf_counter()
        driver.call(state, traffic)
        untraced = (time.perf_counter() - t) / rounds
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            with record_function(WINDOW):
                driver.call(state, traffic)
            traced = (time.perf_counter() - t) / rounds
    events = prof.events()
    view = TraceView(events, rounds)
    lags = launch_lags(events)
    tenth = max(len(lags) // 10, 1)
    split = spans.launch_split(view)
    late, paired = clock_violations(events, spans.LAYERS + tuple(
        n for inner in spans.INNER.values() for n in inner))
    return {
        "device": torch.cuda.get_device_name(0), "seed": seed,
        "untraced_round_ms": untraced * 1e3, "traced_round_ms": traced * 1e3,
        "launches_per_round": len(view.device) / rounds,
        "launch_split": split, "launch_split_sum": sum(split.values()),
        "host_launch_split": host_launch_split(view, events),
        "clock_violations": late, "spans_paired": paired,
        "least_lag_us_first_tenth": min(d for _, d in lags[:tenth]) if lags else None,
        "least_lag_us_last_tenth": min(d for _, d in lags[-tenth:]) if lags else None,
        "idle_gaps": view.idle_gaps(5),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="femnist_qccf_c128")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    from bench import harness

    harness.environment()
    import torch

    if not torch.cuda.is_available():
        print("trace_audit: needs a CUDA device", file=sys.stderr)
        return 2
    rec = audit(args.workload, args.seed)
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
