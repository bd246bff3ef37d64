"""Bytes the eq.-2 aggregate of one round needs: every scheduled client's
index plane (one byte a coordinate up to q_cap = 8, else two) and sign
plane (one byte), read once, its (K,) coefficients, and the (Z,) fp32
model written once."""
from __future__ import annotations

from bench import inputs


def aggregate_bytes(cfg: dict, traffic: dict) -> int:
    z = inputs.param_count(cfg["model"])
    k = min(cfg["n_clients"], traffic["n_channels"])
    idx = 1 if cfg["train"]["q_cap"] <= 8 else 2
    return k * z * (idx + 1) + 4 * k + 4 * z
