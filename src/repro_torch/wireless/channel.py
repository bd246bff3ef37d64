"""Wireless channel simulation (paper Sec. IV-A, Table I).

Uplink OFDMA with C orthogonal channels of bandwidth B. Channel response
  h_{i,c}^n = h_gain * h^{Rician}_{i,c} * h^{Loss}_i
with (K, zeta) Rician small-scale fading per (client, channel) and 3GPP
TR 38.901 UMa-style log-distance path loss from the client-server distance.
Rates: v = B log2(1 + p h / (B N0))   (eq. 14 denominator).

Clients are dropped uniformly in a 500 m radius disc, as in Sec. VI.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    n_clients: int = 10
    n_channels: int = 10
    # Paper Table I says B = 1 MHz, but at that bandwidth even q = 1
    # (0.49 Mbit for Z = 246590) cannot fit in T_max = 20 ms at any
    # achievable spectral efficiency (Shannon-capped at ~17 Mbit/s here):
    # the paper's own operating regime (q ~ 2..8 in Fig. 5) is
    # information-theoretically unreachable. We default to 10 MHz, which
    # reproduces exactly that regime. See DESIGN.md §6.
    bandwidth: float = 1e7          # B [Hz]
    noise_psd_dbm: float = -174.0   # N0 [dBm/Hz]
    p_tx: float = 0.2               # [W]
    rician_k: float = 4.0           # K factor
    rician_zeta: float = 1.0        # scale
    carrier_ghz: float = 2.4        # nu
    radius_m: float = 500.0
    antenna_gain_db: float = 5.0    # h_gain (antenna + misc)
    # Clients closer than this to a serving point are snapped outward: the
    # TR 38.901 log-distance fit is a far-field model and the sqrt-uniform
    # disc drop would otherwise put a tail of clients at unphysical SNR.
    near_field_m: float = 10.0

    @property
    def noise_power(self) -> float:
        """Noise power over one channel: N0 * B [W]."""
        return 10 ** (self.noise_psd_dbm / 10.0) * 1e-3 * self.bandwidth


def ap_ring_layout(n_aps: int, radius_m: float) -> np.ndarray:
    """(A, 2) access-point xy positions for a cell-free drop.

    A = 1 is the degenerate single-BS layout (the AP at the origin);
    A > 1 spreads the APs evenly on a ring of ``radius_m`` so the serving
    points tile the client disc (PAPERS 2412.20785's cell-free geometry).
    """
    if n_aps == 1:
        return np.zeros((1, 2))
    phi = 2.0 * np.pi * np.arange(n_aps) / n_aps
    return radius_m * np.stack([np.cos(phi), np.sin(phi)], axis=1)


class ChannelModel:
    """Draws per-round channel states and converts them to OFDMA rates."""

    def __init__(self, params: ChannelParams, seed: int = 0) -> None:
        self.params = params
        self.rng = np.random.default_rng(seed)
        # Static client drop (distance drives large-scale fading).
        r = params.radius_m * np.sqrt(self.rng.uniform(size=params.n_clients))
        self.distances = np.maximum(r, params.near_field_m)

    def path_loss_db(self) -> np.ndarray:
        """3GPP TR 38.901-flavoured UMa LOS path loss:
        PL = 28.0 + 22 log10(d) + 20 log10(f_GHz)."""
        return (
            28.0
            + 22.0 * np.log10(self.distances)
            + 20.0 * np.log10(self.params.carrier_ghz)
        )

    def draw_gains(self) -> np.ndarray:
        """(U, C) linear power gains h_{i,c} for one round."""
        p = self.params
        k, zeta = p.rician_k, p.rician_zeta
        # Rician amplitude: LOS component sqrt(K/(K+1)), scatter sqrt(1/(K+1)).
        los = np.sqrt(k / (k + 1.0) * zeta)
        nlos_std = np.sqrt(zeta / (2.0 * (k + 1.0)))
        shape = (p.n_clients, p.n_channels)
        x = los + nlos_std * self.rng.standard_normal(shape)
        y = nlos_std * self.rng.standard_normal(shape)
        small_scale = x**2 + y**2  # |h|^2, Rician power gain
        large_scale_db = -self.path_loss_db() + p.antenna_gain_db
        large_scale = 10 ** (large_scale_db / 10.0)
        return small_scale * large_scale[:, None]

    def draw_rates(self) -> np.ndarray:
        """(U, C) achievable uplink rates [bit/s] for one round (eq. 14)."""
        p = self.params
        gains = self.draw_gains()
        snr = p.p_tx * gains / p.noise_power
        return p.bandwidth * np.log2(1.0 + snr)
