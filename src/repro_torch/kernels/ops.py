"""Public wrappers around the wire kernels: tree flatten -> (M, 128) tile
padding -> kernel -> unflatten (the port of ``repro.kernels.ops``).

Entropy is explicit: ``quantize_flat`` takes its uint32 stochastic-rounding
bits as ``rbits``, or draws them from the ``torch.Generator`` it is given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.kernels import stochastic_quant as sq

Tree = Any
LANES = sq.LANES
# rows of a tile: the JAX ops' 256-row blocks, so the (M, 128) planes and
# their rbits have the reference's shapes
_TILE_ROWS = 256


def pad_to_tiles(flat: torch.Tensor) -> tuple[torch.Tensor, int]:
    """1-D -> (M, 128) with M a multiple of 256. Returns (tiled, orig_len)."""
    n = flat.shape[0]
    tile = _TILE_ROWS * LANES
    padded = ((n + tile - 1) // tile) * tile
    return F.pad(flat, (0, padded - n)).reshape(-1, LANES), n


def flatten_pytree(tree: Tree) -> tuple[torch.Tensor, Any]:
    """Nested dict of tensors -> (1-D fp32 in sorted-key leaf order, meta)."""
    leaves = tree_util.leaves(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    meta = (tree_util.paths(tree), [(leaf.shape, leaf.dtype) for leaf in leaves])
    return flat, meta


def unflatten_pytree(flat: torch.Tensor, meta) -> Tree:
    key_paths, shapes = meta
    out = []
    off = 0
    for shape, dtype in shapes:
        size = 1
        for d in shape:
            size *= d
        out.append(flat[off: off + size].reshape(shape).to(dtype))
        off += size
    return tree_util.from_leaves(key_paths, out)


def random_bits(shape, generator: torch.Generator) -> torch.Tensor:
    """uint32 entropy of ``shape`` drawn from ``generator`` on its device."""
    bits = torch.randint(-(2**31), 2**31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=generator.device)
    return bits.view(torch.uint32)


def quantize_flat(flat: torch.Tensor, q_bits: int, *,
                  rbits: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-D fp32 -> (idx u8 (M, 128), signs u8, scale fp32 ()). Stochastic,
    from ``rbits`` ((M, 128) uint32) or else ``generator``. The caller keeps
    the original length (``flat.shape[0]``) for unpadding."""
    tiled, _ = pad_to_tiles(flat)
    scale = torch.amax(torch.abs(flat))
    if rbits is None:
        if generator is None:
            raise ValueError("quantize_flat: pass rbits or a torch.Generator")
        rbits = random_bits(tiled.shape, generator)
    idx, signs = sq.quantize(tiled, rbits, scale.reshape(1), q_bits)
    return idx, signs, scale


def dequantize_flat(idx: torch.Tensor, signs: torch.Tensor, scale: torch.Tensor,
                    q_bits: int, n: int) -> torch.Tensor:
    out = sq.dequantize(idx, signs, scale.reshape(1), q_bits)
    return out.reshape(-1)[:n]


def quantize_pytree_kernel(tree: Tree, q_bits: int, *,
                           rbits: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           ) -> tuple[Tree, torch.Tensor]:
    """Quantize -> wire -> dequantize a whole parameter tree through the
    kernels; returns (dequantized tree, range scale)."""
    flat, meta = flatten_pytree(tree)
    n = flat.shape[0]
    idx, signs, scale = quantize_flat(flat, q_bits, rbits=rbits, generator=generator)
    deq = dequantize_flat(idx, signs, scale, q_bits, n)
    return unflatten_pytree(deq, meta), scale


def aggregate_uploads(idx: torch.Tensor, signs: torch.Tensor, scales: torch.Tensor,
                      weights: torch.Tensor, q_bits) -> torch.Tensor:
    """Server-side fused dequant + weighted sum (paper eq. 2).
    idx/signs: (K, M, 128); returns (M*128,) fp32 flat aggregate."""
    return sq.aggregate(idx, signs, scales, weights, q_bits).reshape(-1)
