"""The comparison that decides ``correct``: a run's outputs against the
plain reference's (``bench.reference.fleet.simulate``) over the same call.

Readings, all from one call of ``rounds_per_call`` rounds:

- ``rounds_off``: the rounds whose decision differs: the schedule or a
  level, client by client (the reference takes the judged run's ties,
  ``policy_qccf.RATE_TIE`` and ``J_TIE``), or a scheduled client's rate,
  the round's energy or a Lyapunov queue off the reference's by more than
  its rounding tolerance in the cell's limits file (``tolerances``);
- ``loss_err``: the largest relative gap of a round's test loss;
- ``model_err``: the norm of the gap between the two final models over the
  norm of the reference's, all coordinates together;
- ``below_precision``: the device kernels of one round of the timed entry
  whose names mark math below the configuration's stated precision (a
  count, read from the profiler in a round after the window).

``correct`` holds when every number is finite and within its limit.
"""
from __future__ import annotations

import math

import numpy as np


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


def readings(run: dict, ref: dict, eps2: float) -> dict:
    """Raw per-round gaps of ``run`` against ``ref`` (both as returned by
    ``simulate``; a program run converted by the harness)."""
    q_p, q_r = np.asarray(run["q"]), np.asarray(ref["q"])
    v_p, v_r = np.asarray(run["v"], np.float64), np.asarray(ref["v"], np.float64)
    sched = (v_p > 0) != (v_r > 0)
    both = (v_p > 0) & (v_r > 0)
    v_err = np.where(both, _rel(v_p, np.where(both, v_r, 1.0)), 0.0).max(axis=1)
    gap = norm = 0.0
    for a in ref["model"]:
        for b in ref["model"][a]:
            r = ref["model"][a][b].numpy()
            gap += float(np.sum((np.asarray(run["model"][a][b], np.float64) - r) ** 2))
            norm += float(np.sum(r**2))
    return {
        "decisions_off": (sched | (q_p != q_r)).sum(axis=1),
        "v_err": v_err,
        "energy_err": _rel(run["energy"], ref["energy"]),
        "lambda1_err": _rel(run["lambda1"], ref["lambda1"], 1.0),
        "lambda2_err": _rel(run["lambda2"], ref["lambda2"], eps2),
        "loss_err": _rel(run["loss"], ref["loss"]),
        "model_err": math.sqrt(gap / norm),
        "below_precision": int(run["below_precision"]),
        "ties": int(ref["ties"]),
    }


def numbers(r: dict, limits: dict) -> dict:
    """The compared numbers, each ``{"value", "limit"}``."""
    off = r["decisions_off"] > 0
    for key, tol in limits["tolerances"].items():
        off = off | ~(np.asarray(r[key]) <= tol)
    values = {
        "rounds_off": float(np.sum(off)),
        "loss_err": float(np.max(r["loss_err"])),
        "model_err": float(r["model_err"]),
        "below_precision": float(r["below_precision"]),
    }
    return {k: {"value": values[k], "limit": limits["limits"][k]} for k in limits["limits"]}


def correct(nums: dict) -> bool:
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"] for n in nums.values())
