"""Floating-point operations of the paper's CNNs and of one fleet round,
from the layer shapes (a multiply-add is two operations; bias, ReLU,
pooling and the loss are left out).

Training a sample is its forward pass, the weight gradient of every layer
and the input gradient of every layer but the first (the images need
none): 3 x forward - the first layer's forward.
"""
from __future__ import annotations


def layer_flops(m: dict) -> list[int]:
    """Forward operations of one sample, layer by layer."""
    k, hw, ch = m["kernel"], m["in_hw"], m["in_ch"]
    out = []
    for c in m["conv_channels"]:
        out.append(2 * hw * hw * k * k * ch * c)      # 'SAME', stride 1
        ch, hw = c, hw // 2
    if m["extra_pool"]:
        hw //= 2
    dim = hw * hw * ch
    for h in list(m["hidden"]) + [m["n_classes"]]:
        out.append(2 * dim * h)
        dim = h
    return out


def forward_flops(m: dict) -> int:
    return sum(layer_flops(m))


def train_flops(m: dict) -> int:
    return 3 * forward_flops(m) - layer_flops(m)[0]


def round_flops(cfg: dict, traffic: dict) -> int:
    """One round: S = min(U, C) clients, tau SGD steps of a batch each,
    plus the test-set forward pass when the round evaluates."""
    m = cfg["model"]
    s = min(cfg["n_clients"], traffic["n_channels"])
    train = s * cfg["system"]["tau"] * cfg["train"]["batch"] * train_flops(m)
    return train + (cfg["data"]["n_test"] * forward_flops(m) if traffic["eval"] else 0)
