"""Wire kernels: stochastic quantize / dequantize / fused aggregate.

The CUDA ports (``csrc/stochastic_quant.cu``) of the Pallas TPU kernels in
``repro.kernels.stochastic_quant``, on the same wire layout:

  x      : (M, 128) fp32 tile-padded flat model chunk
  rbits  : (M, 128) uint32 random bits (stochastic-rounding entropy)
  scale  : 1-element fp32 range theta_max (paper eq. 4)
  idx    : (M, 128) uint8 magnitude index in [0, 2^q - 1] (uint16 planes
           are accepted by ``aggregate``, as the engine emits them for
           q_cap > 8)
  signs  : (M, 128) uint8, 1 = negative

Each kernel has a plain torch version beside it (``quantize_plain`` and so
on) computing the same function with the same fp32 operations in the same
order. The wrapper (``quantize`` and so on) runs the plain version for a
tensor on the CPU and the CUDA kernel for a tensor on the card, with no
fallback between the two; ``launches`` counts kernel launches only. The
kernels have no backward: under grad a wrapper raises on every device
(``build.refuse_grad``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs.profile import scope as _profile_scope

LANES = 128
# what a caller that needs gradients uses instead of the wire kernels
WIRE_GRAD_ROUTE = ("the plain torch quantizer of repro_torch.core.quantization "
                   "(quantize_pytree, quantize_indices, dequantize_indices)")

# kernel launches per wrapper since the last reset_launches(); the CPU path
# (plain version) never counts
launches = {"aggregate": 0, "quantize": 0, "dequantize": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def levels_of(q_bits: torch.Tensor) -> torch.Tensor:
    """fp32 ``2^q - 1`` of an integer level tensor, exact (the JAX package's
    ``2.0 ** q - 1.0`` is exact at integer q too)."""
    q = q_bits.to(torch.int64)
    return (torch.ones_like(q) << q).to(torch.float32) - 1.0


def _check_q8(q_bits: int) -> None:
    # same wire-format bound as repro.kernels.stochastic_quant.quantize: the
    # u8 index plane holds levels up to 2^8 - 1
    if not 1 <= int(q_bits) <= 8:
        raise ValueError(
            f"quantize: q_bits={q_bits} does not fit the uint8 index plane "
            "(max level 2^q - 1 needs 1 <= q <= 8)"
        )


def _check_plane(name: str, what: str, t: torch.Tensor, dtypes, shape=None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_scale(name: str, scale: torch.Tensor) -> None:
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(
            f"{name}: scale must be a 1-element fp32 tensor, got "
            f"{scale.dtype} with {scale.numel()} elements"
        )


# ---------------------------------------------------------------- quantize

def quantize_plain(x: torch.Tensor, rbits: torch.Tensor, scale: torch.Tensor,
                   q_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch eq.-4 stochastic rounding from explicit uint32 entropy."""
    levels = float(2.0**q_bits - 1.0)
    s = scale.reshape(())
    safe = torch.where(s > 0, s, torch.ones_like(s))
    # a true division: torch's ``float / tensor`` is reciprocal-then-multiply
    ratio = torch.full_like(safe, levels) / safe
    scaled = torch.minimum(torch.abs(x) * ratio, torch.full_like(x, levels))
    lower = torch.floor(scaled)
    frac = scaled - lower
    # uint32 has no shift on the CPU: widen through int32's bit pattern
    bits = rbits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (bits >> 8).to(torch.float32) * (2.0**-24)
    idx = torch.minimum(lower + (u < frac).to(torch.float32), torch.full_like(x, levels))
    return idx.to(torch.uint8), (x < 0).to(torch.uint8)


def quantize_variant(x: torch.Tensor, rbits: torch.Tensor, idx: torch.Tensor,
                     signs: torch.Tensor) -> str:
    """``"vec4"`` (4 elements per thread: one 16-byte load of x and of
    rbits, one 4-byte word of each plane out) when x and rbits start on
    16-byte and idx and signs on 4-byte boundaries and they hold a multiple
    of 4 elements, else ``"scalar"`` (one element per thread). A pure
    function of the data pointers and sizes of contiguous planes; it
    launches nothing."""
    aligned = (x.data_ptr() % 16 == 0 and rbits.data_ptr() % 16 == 0
               and idx.data_ptr() % 4 == 0 and signs.data_ptr() % 4 == 0)
    return "vec4" if aligned and x.numel() % 4 == 0 else "scalar"


def quantize(x: torch.Tensor, rbits: torch.Tensor, scale: torch.Tensor,
             q_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x fp32 and rbits uint32, both (M, 128); scale 1-element fp32.
    Returns (idx u8, signs u8), each (M, 128). On the card the kernel's
    variant is :func:`quantize_variant`'s."""
    build.refuse_grad("quantize", WIRE_GRAD_ROUTE, x, rbits, scale)
    _check_q8(q_bits)
    if x.ndim != 2 or x.shape[1] != LANES:
        raise ValueError(f"quantize expects lane-tiled (M, {LANES}) input, got {tuple(x.shape)}")
    _check_plane("quantize", "x", x, (torch.float32,))
    _check_plane("quantize", "rbits", rbits, (torch.uint32,), x.shape)
    _check_scale("quantize", scale)
    if not build.route("quantize", x, rbits, scale):
        return quantize_plain(x, rbits, scale, q_bits)
    idx = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    signs = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel():
        lib = build.library("stochastic_quant")
        fn = (lib.sq_quantize_vec4 if quantize_variant(x, rbits, idx, signs) == "vec4"
              else lib.sq_quantize)
        with _profile_scope("cuda_quantize"):
            err = fn(
                x.data_ptr(), rbits.data_ptr(), scale.data_ptr(), idx.data_ptr(),
                signs.data_ptr(), x.numel(), float(2.0**q_bits - 1.0),
                x.device.index or 0, build.stream(x.device),
            )
        build.check("stochastic_quant", "quantize", err)
        launches["quantize"] += 1
    return idx, signs


# -------------------------------------------------------------- dequantize

def _inv_levels(q_bits: int) -> float:
    """fp32 ``1 / (2^q - 1)``. The Pallas dequantize divides its range by
    the constant level count, which XLA rewrites into a multiply by this
    reciprocal (``repro.kernels.ref.dequantize_ref`` divides, and differs
    from it in the last bit); the port follows the kernel."""
    return float(np.float32(1.0) / np.float32(2.0**q_bits - 1.0))


def dequantize_plain(idx: torch.Tensor, signs: torch.Tensor, scale: torch.Tensor,
                     q_bits: int) -> torch.Tensor:
    """Plain torch clamped dequantize: min(idx, L) * (scale * (1 / L)), signed."""
    levels = float(2.0**q_bits - 1.0)
    s = scale.reshape(())
    step = s * torch.full_like(s, _inv_levels(q_bits))
    mag = torch.clamp(idx.to(torch.float32), max=levels) * step
    return torch.where(signs > 0, -mag, mag)


def dequantize_variant(idx: torch.Tensor, signs: torch.Tensor, out: torch.Tensor) -> str:
    """``"vec4"`` (4 elements per thread: one 4-byte word of each plane in,
    one 16-byte store out) when idx and signs start on 4-byte and out on
    16-byte boundaries and they hold a multiple of 4 elements, else
    ``"scalar"`` (one element per thread). A pure function of the data
    pointers and sizes of contiguous planes; it launches nothing."""
    aligned = (idx.data_ptr() % 4 == 0 and signs.data_ptr() % 4 == 0
               and out.data_ptr() % 16 == 0)
    return "vec4" if aligned and idx.numel() % 4 == 0 else "scalar"


def dequantize(idx: torch.Tensor, signs: torch.Tensor, scale: torch.Tensor,
               q_bits: int) -> torch.Tensor:
    """idx and signs u8 (M, 128), scale 1-element fp32 -> (M, 128) fp32.
    The clamp to 2^q - 1 keeps a corrupted plane inside [-scale, scale].
    On the card the kernel's variant is :func:`dequantize_variant`'s."""
    build.refuse_grad("dequantize", WIRE_GRAD_ROUTE, idx, signs, scale)
    if idx.ndim != 2 or idx.shape[1] != LANES:
        raise ValueError(
            f"dequantize expects lane-tiled (M, {LANES}) input, got idx {tuple(idx.shape)}")
    _check_plane("dequantize", "idx", idx, (torch.uint8,))
    _check_plane("dequantize", "signs", signs, (torch.uint8,), idx.shape)
    _check_scale("dequantize", scale)
    if not build.route("dequantize", idx, signs, scale):
        return dequantize_plain(idx, signs, scale, q_bits)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel():
        lib = build.library("stochastic_quant")
        fn = (lib.sq_dequantize_vec4 if dequantize_variant(idx, signs, out) == "vec4"
              else lib.sq_dequantize)
        with _profile_scope("cuda_dequantize"):
            err = fn(
                idx.data_ptr(), signs.data_ptr(), scale.data_ptr(), out.data_ptr(),
                idx.numel(), float(2.0**q_bits - 1.0), _inv_levels(q_bits),
                idx.device.index or 0, build.stream(idx.device),
            )
        build.check("stochastic_quant", "dequantize", err)
        launches["dequantize"] += 1
    return out


def plane_in_range(idx: torch.Tensor, q_bits) -> torch.Tensor:
    """Per-client wire-plane range screen ``max(idx) <= 2^q - 1`` over (K, ...)
    index planes (see ``repro.kernels.stochastic_quant.plane_in_range``).
    u16 planes are widened first: torch's CPU uint16 has no max."""
    q = torch.clamp(torch.as_tensor(q_bits, device=idx.device), min=1)
    flat = idx.reshape(idx.shape[0], -1).to(torch.float32)
    return torch.amax(flat, dim=1) <= levels_of(q)


# --------------------------------------------------------------- aggregate

def aggregate_coef(scales: torch.Tensor, weights: torch.Tensor, q_bits, k: int) -> torch.Tensor:
    """(K,) fp32 ``w_k * scale_k / (2^{q_k} - 1)``, as the Pallas wrapper
    computes it (``stochastic_quant.py:208-210``)."""
    qb = torch.as_tensor(q_bits, device=scales.device)
    if qb.ndim != 0 and tuple(qb.shape) != (k,):
        raise ValueError(
            f"aggregate: q_bits must be a scalar or per-client ({k},), got shape {tuple(qb.shape)}")
    levels = levels_of(torch.broadcast_to(qb, (k,)))
    return (weights * scales / levels).to(torch.float32)


def _check_aggregate(idx, signs, scales, weights) -> None:
    if idx.ndim != 3 or idx.shape[2] != LANES:
        raise ValueError(
            f"aggregate expects lane-tiled (K, M, {LANES}) input, got idx {tuple(idx.shape)}")
    k = idx.shape[0]
    if k < 1:
        raise ValueError("aggregate: needs at least one client plane (K >= 1)")
    _check_plane("aggregate", "idx", idx, (torch.uint8, torch.uint16))
    _check_plane("aggregate", "signs", signs, (torch.uint8,), idx.shape)
    _check_plane("aggregate", "scales", scales, (torch.float32,), (k,))
    _check_plane("aggregate", "weights", weights, (torch.float32,), (k,))


def aggregate_plain(idx: torch.Tensor, signs: torch.Tensor, scales: torch.Tensor,
                    weights: torch.Tensor, q_bits) -> torch.Tensor:
    """Plain torch fused dequantize + eq.-2 weighted sum, accumulated over
    clients k = 0..K-1 in order (the Pallas kernel's order)."""
    k = idx.shape[0]
    coef = aggregate_coef(scales, weights, q_bits, k)
    acc = torch.zeros(idx.shape[1:], dtype=torch.float32, device=idx.device)
    for j in range(k):
        mag = idx[j].to(torch.float32)  # widen first: CPU uint16 has no compare
        acc = acc + coef[j] * torch.where(signs[j] > 0, -mag, mag)
    return acc


def aggregate(idx: torch.Tensor, signs: torch.Tensor, scales: torch.Tensor,
              weights: torch.Tensor, q_bits) -> torch.Tensor:
    """Fused dequantize + eq.-2 weighted sum over K wire payloads.

    idx (K, M, 128) u8 or u16, signs (K, M, 128) u8, scales and weights
    (K,) fp32, q_bits a scalar or (K,) per-client levels -> (M, 128) fp32.
    Any K >= 1 and any M; idx is not clamped (screen corrupt planes with
    :func:`plane_in_range` first).
    """
    build.refuse_grad("aggregate", WIRE_GRAD_ROUTE, idx, signs, scales, weights)
    _check_aggregate(idx, signs, scales, weights)
    if not build.route("aggregate", idx, signs, scales, weights):
        return aggregate_plain(idx, signs, scales, weights, q_bits)
    k = idx.shape[0]
    coef = aggregate_coef(scales, weights, q_bits, k)
    out = torch.empty(idx.shape[1:], dtype=torch.float32, device=idx.device)
    n = out.numel()
    if n:
        lib = build.library("stochastic_quant")
        fn = lib.sq_aggregate_u8 if idx.dtype == torch.uint8 else lib.sq_aggregate_u16
        with _profile_scope("cuda_aggregate"):
            err = fn(idx.data_ptr(), signs.data_ptr(), coef.data_ptr(), out.data_ptr(),
                     k, n, idx.device.index or 0, build.stream(idx.device))
        build.check("stochastic_quant", "aggregate", err)
        launches["aggregate"] += 1
    return out
