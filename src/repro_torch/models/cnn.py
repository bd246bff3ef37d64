"""The paper's CNNs for the FL experiments (Sec. VI "Models"), in torch.

FEMNIST: conv 32@5x5 -> conv 64@5x5 -> hidden 3136 -> 62 classes.
CIFAR : conv 64@5x5 -> conv 64@5x5 -> hiddens 1024, 384, 192 -> 10.
MaxPool 2x2 after each conv.

Parameters keep the JAX package's layouts so that its weights carry over
unchanged and flat vectors line up coordinate for coordinate: a nested
dict ``{"conv0": {"w", "b"}, ..., "out": {"w", "b"}}`` with HWIO conv
kernels and ``(in, out)`` dense matrices. Images are NHWC at the public
functions; the forward permutes to torch's NCHW for the convolutions and
flattens back in NHWC (h, w, c) order, the order of ``fc0``/``out`` rows.
All functions are pure in ``params``, so ``torch.func.grad``/``vmap``
apply to them directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    in_hw: int             # input height/width (square)
    in_ch: int
    conv_channels: tuple[int, ...]
    hidden: tuple[int, ...]
    n_classes: int
    kernel: int = 5
    extra_pool: bool = False  # one more 2x2 maxpool after the conv stack


# Z = 832 + 51264 + 194494 = 246590, Table I's Z^FEMNIST (see repro.models.cnn).
FEMNIST_CNN = CNNConfig(
    name="femnist_cnn", in_hw=28, in_ch=1,
    conv_channels=(32, 64), hidden=(), n_classes=62,
)
# Z = 4864 + 102464 + 393600 + 73920 + 1930 = 576778 = Table I's Z^CIFAR.
CIFAR10_CNN = CNNConfig(
    name="cifar10_cnn", in_hw=32, in_ch=3,
    conv_channels=(64, 64), hidden=(384, 192), n_classes=10, extra_pool=True,
)
# Small variant for fast tests on CPU.
TINY_CNN = CNNConfig(
    name="tiny_cnn", in_hw=16, in_ch=1,
    conv_channels=(8, 8), hidden=(32,), n_classes=10, kernel=3,
)


def _flat_dim(cfg: CNNConfig) -> int:
    hw = cfg.in_hw
    for _ in cfg.conv_channels:
        hw = hw // 2  # 'SAME' conv + 2x2 maxpool
    if cfg.extra_pool:
        hw = hw // 2
    return hw * hw * cfg.conv_channels[-1]


def dense_init(shape: tuple[int, ...], scale: float,
               generator: torch.Generator) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2] (inverse-CDF
    sampling, as ``jax.random.truncated_normal`` does; the JAX package's
    ``models.layers.dense_init``). Drawn on the CPU generator."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
    return (scale * x.clamp(-2.0, 2.0)).to(torch.float32)


def init_params(cfg: CNNConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Random parameters from ``seed``. torch's generator cannot replay
    ``jax.random``, so these are not the JAX package's weights for the same
    seed; carry those over with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: dict = {}
    in_ch = cfg.in_ch
    for i, ch in enumerate(cfg.conv_channels):
        params[f"conv{i}"] = {
            "w": dense_init((cfg.kernel, cfg.kernel, in_ch, ch), 0.1, gen),
            "b": torch.zeros((ch,), dtype=torch.float32),
        }
        in_ch = ch
    dim = _flat_dim(cfg)
    for j, h in enumerate(cfg.hidden):
        params[f"fc{j}"] = {
            "w": dense_init((dim, h), 0.05, gen),
            "b": torch.zeros((h,), dtype=torch.float32),
        }
        dim = h
    params["out"] = {
        "w": dense_init((dim, cfg.n_classes), 0.05, gen),
        "b": torch.zeros((cfg.n_classes,), dtype=torch.float32),
    }
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}


def params_from_numpy(tree: dict,
                      device: Optional[Union[str, torch.device]] = None) -> dict:
    """The JAX package's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) -> this module's
    parameters, same layouts, fp32 copies on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node), dtype=torch.float32, device=dev)

    return conv(tree)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=2, stride=2)  # VALID: floor division


def forward(cfg: CNNConfig, params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)           # NHWC -> NCHW
    for i in range(len(cfg.conv_channels)):
        p = params[f"conv{i}"]
        w = p["w"].permute(3, 2, 0, 1)                         # HWIO -> OIHW
        # 'SAME' at stride 1 with an odd kernel: k // 2 on every side
        x = F.conv2d(x, w, padding=cfg.kernel // 2) + p["b"][:, None, None]
        x = _max_pool(torch.relu(x))
    if cfg.extra_pool:
        x = _max_pool(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)          # NHWC flatten
    for j in range(len(cfg.hidden)):
        p = params[f"fc{j}"]
        x = torch.relu(x @ p["w"] + p["b"])
    p = params["out"]
    return x @ p["w"] + p["b"]


def _nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return logz - gold


def loss_fn(cfg: CNNConfig, params: dict, batch: dict) -> torch.Tensor:
    return torch.mean(_nll(forward(cfg, params, batch["x"]), batch["y"]))


def eval_metrics(cfg: CNNConfig, params: dict, x: torch.Tensor,
                 y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(accuracy, mean cross-entropy) on a labelled set."""
    logits = forward(cfg, params, x)
    acc = torch.mean((torch.argmax(logits, -1) == y.long()).to(torch.float32))
    return acc, torch.mean(_nll(logits, y))


def param_count(cfg: CNNConfig) -> int:
    dims = [cfg.in_ch, *cfg.conv_channels]
    n = sum(cfg.kernel * cfg.kernel * a * b + b for a, b in zip(dims, dims[1:]))
    dims = [_flat_dim(cfg), *cfg.hidden, cfg.n_classes]
    return n + sum(a * b + b for a, b in zip(dims, dims[1:]))
