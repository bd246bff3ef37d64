#!/usr/bin/env python3
"""Count the aten operations one fleet round dispatches, per policy mode.

    PYTHONPATH=src python scripts/round_ops.py [--clients 64] [--channels 8]

Runs the port (``repro_torch``) on the CPU at the FEMNIST CNN's width with a
small fleet: one round to warm up, then one round under a
``TorchDispatchMode`` counter. On the card nearly every dispatched op is one
kernel launch, and the round is bound by the host's time per launch, so the
count predicts a mode's cost before a run on the card. It does not depend on
the number of clients (every op is vectorised over them).
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.sim import build_sim  # noqa: E402

MODES = (("greedy", 8), ("compiled-ga", 8), ("no_quant", 16), ("channel_allocate", 16),
         ("principle", 16), ("same_size", 16))


class OpCounter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--channels", type=int, default=8)
    args = ap.parse_args(argv)
    for mode, q_cap in MODES:
        sim = build_sim("femnist", n_clients=args.clients, n_channels=args.channels, seed=0,
                        n_test=64, q_cap=q_cap, policy_mode=mode, device="cpu")
        with torch.no_grad():
            carry, _ = sim._round_body(sim._init_carry(), 0, with_eval=True)
            with OpCounter() as counter:
                sim._round_body(carry, 1, with_eval=True)
        top = ", ".join(f"{k} {n}" for k, n in counter.ops.most_common(4))
        print(f"{mode} (q_cap {q_cap}): {sum(counter.ops.values())} aten ops per round ({top})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
