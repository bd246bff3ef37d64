"""Latency and energy models (paper eq. 14-17)."""
from __future__ import annotations


def comm_latency(payload_bits: float, rate: float) -> float:
    """T_com = ell / v (eq. 14)."""
    return payload_bits / rate


def comm_energy(p_tx: float, payload_bits: float, rate: float) -> float:
    """E_com = p * T_com (eq. 15)."""
    return p_tx * comm_latency(payload_bits, rate)


def comp_latency(tau_e: int, gamma: float, d_size: float, freq: float) -> float:
    """T_cmp = tau_e * gamma * D / f (eq. 16)."""
    return tau_e * gamma * d_size / freq


def comp_energy(tau_e: int, alpha: float, gamma: float, d_size: float, freq: float) -> float:
    """E_cmp = tau_e * alpha * gamma * D * f^2 (eq. 17)."""
    return tau_e * alpha * gamma * d_size * freq**2
