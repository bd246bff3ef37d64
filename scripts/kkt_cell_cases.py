#!/usr/bin/env python3
"""The decision's KKT at the benchmark cell's own inputs, on the card.

    python3 scripts/kkt_cell_cases.py --seed <n>

Builds the cell ``femnist_qccf_c128`` as ``bench/run.py`` does, runs one
call of its timed entry (``run_compiled(10)``) and records every
``kernels.kkt.solve_kkt`` call: its inputs and the kernel's outputs.
Prints one JSON object: how many clients took each KKT case (the kernel's
case codes 1, 2, 4, 3, 5 and 6 for the grid), split into clients on a
channel and the rest, and whether every recorded call is bit-equal to the
plain twin on the same inputs (levels, feasibility and case codes equal,
f and q_hat as fp32 bits). Exits non-zero without a card or on any
difference.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "femnist_qccf_c128"


def record(seed: int) -> dict:
    import torch

    from bench import harness
    from repro_torch.kernels import kkt

    spec = harness.cell_spec(WORKLOAD)
    seen = []
    real = kkt.solve_kkt

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out

    with torch.autograd.set_multithreading_enabled(False):
        sim = harness.build(spec, seed, torch.device("cuda"))
        harness.warm(sim, spec["traffic"])
        with mock.patch.object(kkt, "solve_kkt", spy):
            harness.call(sim, spec["traffic"])
    counts = {"on a channel": [0] * 6, "unassigned": [0] * 6}
    differ = []
    for i, (args, kwargs, got) in enumerate(seen):
        want = kkt.solve_kkt_plain(*args, **kwargs)
        for name, g, w in zip(("q", "f", "feasible", "q_hat", "case"), got, want):
            same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                    if g.dtype == torch.float32 else torch.equal(g, w))
            if not same:
                differ.append(f"call {i}: {name} in {int((g != w).sum())} clients")
        on = args[0] > 0
        for label, sel in (("on a channel", on), ("unassigned", ~on)):
            codes = torch.bincount(got[4][sel].long(), minlength=7)[1:].tolist()
            counts[label] = [a + b for a, b in zip(counts[label], codes)]
    total = sum(map(sum, counts.values()))
    grid = sum(c[5] for c in counts.values())
    return {"device": torch.cuda.get_device_name(0), "workload": WORKLOAD, "seed": seed,
            "kkt_calls": len(seen), "clients": total,
            "case_codes_1_to_6": counts, "grid_share": grid / total if total else None,
            "grid_share_on_a_channel": (counts["on a channel"][5] / sum(counts["on a channel"])
                                        if sum(counts["on a channel"]) else None),
            "bit_equal_to_plain": not differ, "differences": differ[:20]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench import harness

    harness.environment()
    import torch

    if not torch.cuda.is_available():
        print("kkt_cell_cases: needs a CUDA device", file=sys.stderr)
        return 2
    rec = record(args.seed)
    print(json.dumps(rec))
    return 0 if rec["bit_equal_to_plain"] else 1


if __name__ == "__main__":
    sys.exit(main())
