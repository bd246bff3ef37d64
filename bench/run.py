"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``. Exits
non-zero with no result when there is no CUDA device for the cell.
"""
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench import harness

    sys.exit(harness.main(t_start=T_START))
