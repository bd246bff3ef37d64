"""Uplink rates of one round (the paper's eq. 14), in plain torch.

(K, zeta) Rician small-scale fading from two standard normal draws, the
TR 38.901 UMa line-of-sight path loss 28 + 22 log10(d) + 20 log10(f_c)
with the antenna gain, and v = B log2(1 + p h / (B N0)) per (client,
channel), single access point.
"""
from __future__ import annotations

import math

import torch


def rates(nx: torch.Tensor, ny: torch.Tensor, distances: torch.Tensor, ch: dict) -> torch.Tensor:
    """(1, U, C) normals and (U,) distances in metres -> (U, C) bit/s, in
    the dtype of ``distances``."""
    dt = distances.dtype
    k, zeta = ch["rician_k"], ch["rician_zeta"]
    los = math.sqrt(k / (k + 1.0) * zeta)
    nlos = math.sqrt(zeta / (2.0 * (k + 1.0)))
    small = (los + nlos * nx[0].to(dt)) ** 2 + (nlos * ny[0].to(dt)) ** 2
    loss_db = 28.0 + 22.0 * torch.log10(distances) + 20.0 * math.log10(ch["carrier_ghz"])
    large = 10.0 ** ((ch["antenna_gain_db"] - loss_db) / 10.0)
    noise_w = 10.0 ** (ch["noise_psd_dbm"] / 10.0) * 1e-3 * ch["bandwidth"]
    snr = ch["p_tx"] * small * large[:, None] / noise_w
    return ch["bandwidth"] * torch.log2(1.0 + snr)
