"""Render a run summary from a ledger file (the port of
``repro.obs.report``: numpy over the events, and a ledger of either package reads).

    PYTHONPATH=src python -m repro_torch.obs.report LEDGER.jsonl [--target-acc A]

For every run (``run_id``) in the ledger that carries ``round`` events,
prints the header provenance, the phase timings, and the paper's
trajectory diagnostics:

* **energy to target accuracy** — cumulative energy at the first round
  whose accuracy reaches the target (default: the run's final accuracy,
  i.e. "energy to the level this run ends at");
* **q vs round** (Remark 1) — mean scheduled q over the first vs last
  third of rounds, plus the Pearson correlation of ``q_mean`` with the
  round index: the doubly adaptive level should RISE over training;
* **q vs dataset size** (Remark 2) — the mean per-round
  ``corr_q_d`` tap over rounds where it is defined: larger datasets
  should get COARSER quantization (negative correlation).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.obs.ledger import read_ledger


def _corr(x: np.ndarray, y: np.ndarray) -> float:
    if len(x) < 2 or np.std(x) == 0 or np.std(y) == 0:
        return float("nan")
    return float(np.corrcoef(x, y)[0, 1])


def summarize_run(events: list[dict], target_acc: Optional[float] = None) -> dict:
    """One run's ledger events -> summary dict (see module docstring)."""
    header = next((e for e in events if e["event"] == "run_header"), None)
    rounds = sorted((e for e in events if e["event"] == "round"),
                    key=lambda e: e["round"])
    timings = {e["phase"]: e["seconds"] for e in events
               if e["event"] == "timing"}
    out: dict = {
        "run_id": events[0]["run_id"] if events else None,
        "name": header.get("name") if header else None,
        "entry": header.get("entry") if header else None,
        "policy": header.get("policy") if header else None,
        "scenario_hash": header.get("scenario_hash") if header else None,
        "git_rev": header.get("git_rev") if header else None,
        "n_rounds": len(rounds),
        "timings_s": timings,
    }
    if not rounds:
        return out

    def col(key):
        return np.array([np.nan if r.get(key) is None else float(r[key])
                         for r in rounds])

    energy = col("energy")
    acc = col("accuracy")
    cum_e = np.nancumsum(energy)
    out["total_energy_J"] = float(cum_e[-1])
    out["final_accuracy"] = float(acc[-1]) if np.isfinite(acc[-1]) else None

    if target_acc is None and np.isfinite(acc).any():
        target_acc = float(acc[np.isfinite(acc)][-1])
    if target_acc is not None:
        hit = np.nonzero(np.nan_to_num(acc, nan=-1.0) >= target_acc)[0]
        out["target_acc"] = float(target_acc)
        out["rounds_to_target"] = int(hit[0]) + 1 if hit.size else -1
        out["energy_to_target_J"] = (
            float(cum_e[hit[0]]) if hit.size else float(cum_e[-1]))

    q_mean = col("q_mean")
    qm = np.isfinite(q_mean)
    if qm.any():
        qs = q_mean[qm]
        third = max(len(qs) // 3, 1)
        out["q_first_third"] = float(np.mean(qs[:third]))
        out["q_last_third"] = float(np.mean(qs[-third:]))
        out["corr_q_round"] = _corr(np.arange(len(qs), dtype=float), qs)
    corr_qd = col("corr_q_d")
    if np.isfinite(corr_qd).any():
        out["mean_corr_q_d"] = float(np.nanmean(corr_qd))
    return out


def summarize(path: str, target_acc: Optional[float] = None) -> list[dict]:
    """Ledger file -> one summary per run_id (runs without round events
    still report their header + timings)."""
    by_run: dict[str, list[dict]] = {}
    for ev in read_ledger(path):
        by_run.setdefault(ev["run_id"], []).append(ev)
    return [summarize_run(evs, target_acc) for evs in by_run.values()]


def render(summary: dict) -> str:
    """One run summary -> human-readable block."""
    lines = [
        f"run {summary['run_id']}  {summary.get('name') or '?'}"
        f"  [{summary.get('entry') or '?'}]"
    ]
    prov = [f"policy={summary['policy']}" if summary.get("policy") else None,
            f"scenario={summary['scenario_hash']}" if summary.get("scenario_hash") else None,
            f"git={summary['git_rev']}" if summary.get("git_rev") else None]
    prov = [p for p in prov if p]
    if prov:
        lines.append("  " + "  ".join(prov))
    if summary.get("timings_s"):
        lines.append("  timings: " + "  ".join(
            f"{k}={v:.3f}s" for k, v in summary["timings_s"].items()))
    if summary.get("n_rounds"):
        lines.append(
            f"  rounds={summary['n_rounds']}"
            f"  total_energy={summary.get('total_energy_J', float('nan')):.5f}J"
            + (f"  final_acc={summary['final_accuracy']:.4f}"
               if summary.get("final_accuracy") is not None else ""))
    if "energy_to_target_J" in summary:
        lines.append(
            f"  energy_to_target(acc>={summary['target_acc']:.4f}):"
            f" {summary['energy_to_target_J']:.5f}J"
            f" in {summary['rounds_to_target']} round(s)")
    if "q_first_third" in summary:
        lines.append(
            f"  Remark 1 — q first third {summary['q_first_third']:.2f}"
            f" -> last third {summary['q_last_third']:.2f}"
            f" (corr q~round {summary.get('corr_q_round', float('nan')):+.3f})")
    if "mean_corr_q_d" in summary:
        lines.append(
            f"  Remark 2 — mean per-round corr(q, D)"
            f" {summary['mean_corr_q_d']:+.3f}")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger", help="path to a ledger JSONL file")
    ap.add_argument("--target-acc", type=float, default=None)
    args = ap.parse_args()
    for summary in summarize(args.ledger, target_acc=args.target_acc):
        print(render(summary))
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
