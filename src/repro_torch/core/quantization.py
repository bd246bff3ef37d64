"""Stochastic model quantization, the parts the fleet round calls (the port
of ``repro.core.quantization``: paper Sec. II-B, eq. 4/5, Lemma 1).

``quantize_array`` takes its uniforms as an argument, so the same uniforms
give the JAX function's result bit for bit: the arithmetic keeps its order
(``|x| * (levels / safe_max)``, then ``sign(x) * idx * (safe_max /
levels)``) and divides by tensors, never by a Python scalar (torch turns
that into a multiply by the reciprocal on the card).
"""
from __future__ import annotations

import torch

RANGE_BITS = 32  # the scalar range is transmitted as one fp32 (paper eq. 5)


def payload_bits(z: int, q: int) -> int:
    """Payload length in bits for a Z-dim model at level q (eq. 5)."""
    return z * int(q) + z + RANGE_BITS


def variance_bound(z: int, theta_max, q) -> torch.Tensor:
    """Lemma 1 variance bound: Z * theta_max^2 / (4 (2^q - 1)^2), fp32."""
    q = torch.as_tensor(q, dtype=torch.float32)
    levels = torch.pow(2.0, q) - 1.0
    theta = torch.as_tensor(theta_max, dtype=torch.float32, device=q.device)
    return z * theta**2 / (4.0 * levels**2)


def quantize_array(u01: torch.Tensor, x: torch.Tensor,
                   q_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastically quantize ``x`` to ``q_bits`` levels with one shared
    range (eq. 4), rounding up where the uniform ``u01`` (x's shape) falls
    below the fractional part. Returns ``(xq, theta_max)``: the dequantized
    tensor (what a receiver reconstructs) and the fp32 range."""
    levels = torch.pow(torch.tensor(2.0, dtype=torch.float32, device=x.device),
                       float(q_bits)) - 1.0
    theta_max = torch.amax(torch.abs(x))
    # the all-zero tensor: a range of 0 would give NaNs
    safe_max = torch.where(theta_max > 0, theta_max, torch.ones_like(theta_max))
    scaled = torch.abs(x) * (levels / safe_max)
    lower = torch.floor(scaled)
    frac = scaled - lower
    idx = lower + (u01 < frac).to(torch.float32)
    xq = torch.sign(x) * idx * (safe_max / levels)
    xq = torch.where(theta_max > 0, xq, torch.zeros_like(x))
    return xq.to(x.dtype), theta_max
