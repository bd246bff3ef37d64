"""Stochastic model quantization (the port of ``repro.core.quantization``:
paper Sec. II-B, eq. 4/5, Lemma 1).

A model vector theta in R^Z is quantized with q bits per dimension against
the range theta_max = max_z |theta_z|: [0, theta_max] is split into 2^q - 1
intervals and |theta_z| is rounded stochastically to one of the two knobs
around it (eq. 4), keeping the sign. The payload is Z*q + Z + 32 bits
(eq. 5). The wire kernels of ``repro_torch.kernels`` are a second route
with another entropy (u32 bits); the object runtime (``repro_torch.fl``)
uses this module, as the JAX package's does.

Every stochastic function takes its uniforms as an argument (``u01`` of
x's shape, or one fp32 tensor per leaf in ``repro_torch.tree.leaves``
order, the sorted-key order of ``jax.tree_util.tree_leaves``), so the same
uniforms give the JAX function's result bit for bit: the arithmetic keeps
its order (``|x| * (levels / safe_max)``, then ``sign(x) * idx *
(safe_max / levels)``) and divides by tensors, never by a Python scalar
(torch turns that into a multiply by the reciprocal on the card). The
level q is a Python int here: the JAX module's ``static_q_bits`` trace
probe has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch import tree as tree_util

Tree = Any

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


def _levels(q_bits: int, device) -> torch.Tensor:
    """2^q - 1 as an fp32 tensor (2^32 - 1 rounds to 2^32, as in JAX)."""
    return torch.pow(torch.tensor(2.0, dtype=torch.float32, device=device),
                     float(q_bits)) - 1.0


def _safe(theta_max: torch.Tensor) -> torch.Tensor:
    # the all-zero tensor: a range of 0 would give NaNs
    return torch.where(theta_max > 0, theta_max, torch.ones_like(theta_max))


def _round_index(u01: torch.Tensor, x: torch.Tensor, levels: torch.Tensor,
                 safe_max: torch.Tensor) -> torch.Tensor:
    """eq. 4: the fp32 index floor(s) + [u < s - floor(s)], s = |x| L / safe."""
    scaled = torch.abs(x).to(torch.float32) * (levels / safe_max)
    lower = torch.floor(scaled)
    return lower + (u01 < scaled - lower).to(torch.float32)


def quantize_array(u01: torch.Tensor, x: torch.Tensor,
                   q_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastically quantize ``x`` to ``q_bits`` levels with one shared
    range (eq. 4), rounding up where the uniform ``u01`` (x's shape) falls
    below the fractional part. Returns ``(xq, theta_max)``: the dequantized
    tensor (what a receiver reconstructs) and the fp32 range."""
    levels = _levels(q_bits, x.device)
    theta_max = torch.amax(torch.abs(x))
    safe_max = _safe(theta_max)
    idx = _round_index(u01, x, levels, safe_max)
    xq = torch.sign(x) * idx * (safe_max / levels)
    xq = torch.where(theta_max > 0, xq, torch.zeros_like(x))
    return xq.to(x.dtype), theta_max


def quantize_indices(u01: torch.Tensor, x: torch.Tensor,
                     q_bits: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`quantize_array` but returns the wire format: (index per
    dim, u8 sign bit per dim, fp32 range). The index plane is u8 for
    q <= 8, else u16; q > 16 does not fit the u16 plane and raises."""
    if int(q_bits) > 16:
        raise ValueError(
            f"quantize_indices: q_bits={int(q_bits)} does not fit the uint16 "
            "wire index plane (max level 2^q - 1 needs q <= 16 bits)"
        )
    levels = _levels(q_bits, x.device)
    theta_max = torch.amax(torch.abs(x)).to(torch.float32)
    idx = _round_index(u01, x, levels, _safe(theta_max))
    dtype = torch.uint8 if int(q_bits) <= 8 else torch.uint16
    # through int32: torch's CPU uint16 is partial
    return idx.to(torch.int32).to(dtype), (x < 0).to(torch.uint8), theta_max


def dequantize_indices(idx: torch.Tensor, signs: torch.Tensor, theta_max: torch.Tensor,
                       q_bits: int) -> torch.Tensor:
    """Reconstruct the fp32 tensor from the wire format."""
    levels = _levels(q_bits, idx.device)
    mag = idx.to(torch.int32).to(torch.float32) * (theta_max / levels)
    return torch.where(signs > 0, -mag, mag)


def quantize_pytree(uniforms: Sequence[torch.Tensor], tree: Tree,
                    q_bits: int) -> tuple[Tree, torch.Tensor]:
    """Quantize every leaf against one *global* range, the max |.| over all
    leaves (the paper's flat Z-dim vector with one 32-bit range, eq. 5).
    ``uniforms`` holds one tensor of each leaf's shape, in leaf order.
    Returns (dequantized tree, theta_max)."""
    leaves = tree_util.leaves(tree)
    if len(uniforms) != len(leaves):
        raise ValueError(f"quantize_pytree: {len(uniforms)} uniform tensors for "
                         f"{len(leaves)} leaves")
    theta_max = torch.amax(torch.stack([torch.amax(torch.abs(leaf)) for leaf in leaves]))
    theta_max = theta_max.to(torch.float32)
    safe_max = _safe(theta_max)
    levels = _levels(q_bits, theta_max.device)
    out = []
    for u01, leaf in zip(uniforms, leaves):
        idx = _round_index(u01, leaf, levels, safe_max)
        xq = torch.sign(leaf).to(torch.float32) * idx * (safe_max / levels)
        xq = torch.where(theta_max > 0, xq, torch.zeros_like(xq))
        out.append(xq.to(leaf.dtype))
    return tree_util.from_leaves(tree_util.paths(tree), out), theta_max


def pytree_size(tree: Tree) -> int:
    """Z: total number of scalar dimensions in the model."""
    return sum(int(leaf.numel()) for leaf in tree_util.leaves(tree))


@dataclasses.dataclass(frozen=True)
class QuantizedUpload:
    """What a client puts on the uplink (simulation bookkeeping)."""

    tree: Tree                 # dequantized model (what the server reconstructs)
    theta_max: torch.Tensor    # fp32 range scalar
    q_bits: int                # quantization level used
    z: int                     # model dimension

    @property
    def bits(self) -> int:
        return payload_bits(self.z, self.q_bits)


def quantize_upload(uniforms: Sequence[torch.Tensor], tree: Tree,
                    q_bits: int) -> QuantizedUpload:
    tq, tmax = quantize_pytree(uniforms, tree, q_bits)
    return QuantizedUpload(tree=tq, theta_max=tmax, q_bits=int(q_bits), z=pytree_size(tree))
