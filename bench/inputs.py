"""The benchmark's inputs, made from ``--seed``: the initial weights and
every random draw of a round.

Both sides read them: the program through its entropy seam
(``bench.drivers.fleet.BenchEntropy``) and ``init_params``, the plain reference
(``bench.reference``) directly. Every draw is keyed by (seed, round, kind)
on a generator of the device it is made on, so a draw does not depend on
the order in which a round asks for its draws, and two calls of the same
round see the same numbers. This module imports torch and numpy only.

The draws' layouts are part of the input format:

- rates: two (A, U, C) standard normals, in-phase then quadrature;
- minibatches: (S, tau, B) uniforms in [0, 1), slot s's row mapped onto
  its dataset by :func:`batch_rows`;
- the wire: (S, Z) uniforms, coordinate j of slot s at [s, j], in the
  model's sorted-key leaf order (``conv0/b, conv0/w, ...``), zero-padded
  to whatever width the program asks for (padding coordinates quantize to
  0 whatever their uniform).
"""
from __future__ import annotations

import numpy as np
import torch

# draw kinds: the third word of a draw's key
KINDS = ("init", "rates", "batch", "wire")


def draw_key(seed: int, ridx: int, kind: str) -> int:
    """A 63-bit generator seed from (seed, round, kind); any whole seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(ridx) & 0xFFFFFFFF, KINDS.index(kind)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, ridx: int, kind: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_key(seed, ridx, kind))
    return gen


# ---------------------------------------------------------------- weights

def cnn_layout(cfg: dict) -> list[tuple[str, str, tuple, float]]:
    """The CNN's leaves as (layer, leaf, shape, init scale), in sorted-key
    order: HWIO conv kernels, (in, out) dense matrices, zero biases."""
    k, hw, ch = cfg["kernel"], cfg["in_hw"], cfg["in_ch"]
    layers = []
    for i, out_ch in enumerate(cfg["conv_channels"]):
        layers.append((f"conv{i}", (k, k, ch, out_ch), 0.1))
        ch, hw = out_ch, hw // 2
    if cfg["extra_pool"]:
        hw //= 2
    dim = hw * hw * ch
    for j, h in enumerate(cfg["hidden"]):
        layers.append((f"fc{j}", (dim, h), 0.05))
        dim = h
    layers.append(("out", (dim, cfg["n_classes"]), 0.05))
    leaves = []
    for name, shape, scale in sorted(layers):
        leaves.append((name, "b", (shape[-1],), 0.0))
        leaves.append((name, "w", shape, scale))
    return leaves


def param_count(cfg: dict) -> int:
    return sum(int(np.prod(shape)) for _, _, shape, _ in cnn_layout(cfg))


def init_flat(seed: int, cfg: dict, device) -> torch.Tensor:
    """(Z,) fp32 initial model in sorted-key leaf order: one normal draw on
    ``device``, each kernel scaled by its layer's scale and clipped at two
    of its standard deviations, biases zero."""
    z = param_count(cfg)
    flat = torch.randn((z,), generator=generator(seed, 0, "init", device), device=device)
    scale = torch.cat([torch.full((int(np.prod(shape)),), s, device=device)
                       for _, _, shape, s in cnn_layout(cfg)])
    return torch.clamp(flat, -2.0, 2.0) * scale


def unflatten(flat: torch.Tensor, cfg: dict) -> dict:
    """(Z,) -> ``{layer: {"w", "b"}}`` views of ``flat``."""
    tree, off = {}, 0
    for name, leaf, shape, _ in cnn_layout(cfg):
        n = int(np.prod(shape))
        tree.setdefault(name, {})[leaf] = flat[off: off + n].reshape(shape)
        off += n
    return tree


# ------------------------------------------------------------------ draws

def rate_normals(seed: int, ridx: int, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Round ``ridx``'s two (A, U, C) Rician normal draws."""
    gen = generator(seed, ridx, "rates", device)
    return (torch.randn(tuple(shape), generator=gen, device=device),
            torch.randn(tuple(shape), generator=gen, device=device))


def batch_uniforms(seed: int, ridx: int, s: int, tau: int, batch: int, device) -> torch.Tensor:
    return torch.rand((s, tau, batch), generator=generator(seed, ridx, "batch", device),
                      device=device)


def batch_rows(u: torch.Tensor, n_s: torch.Tensor) -> torch.Tensor:
    """(S, tau, B) uniforms + (S,) dataset sizes -> row indices in [0, n_s)."""
    hi = n_s.to(u.device)[:, None, None]
    return torch.minimum((u * hi.to(torch.float32)).to(torch.int64), hi - 1)


def wire_uniforms(seed: int, ridx: int, s: int, z: int, width: int, device) -> torch.Tensor:
    """(S, width) stochastic-rounding uniforms: (S, Z) drawn, zero-padded."""
    if width < z:
        raise ValueError(f"wire_uniforms: width {width} is below the model's {z} coordinates")
    u = torch.rand((s, z), generator=generator(seed, ridx, "wire", device), device=device)
    return torch.nn.functional.pad(u, (0, width - z))
