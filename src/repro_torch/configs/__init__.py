"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(arch_id)`` returns the full published config;
``get_reduced(arch_id)`` returns a 2-layer, d_model<=512, <=4-expert
variant of the same family for CPU smoke tests.

A copy of ``repro.configs``: the same ten configs (``configs/*.py``, data)
and the same reduction rules. The port serves every family; Grok-1 does
not fit one card at full size.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "llama3_8b",
    "seamless_m4t_large_v2",
    "grok_1_314b",
    "internvl2_26b",
    "rwkv6_7b",
    "phi3_medium_14b",
    "yi_6b",
    "starcoder2_7b",
    "zamba2_7b",
    "granite_moe_1b_a400m",
]

# accepted spellings: dashes or underscores
def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return reduce_config(get_config(arch_id))


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/topology, laptop-scale: 2 layers, d_model<=256, <=4 experts."""
    d = 256
    n_heads = 4 if cfg.n_heads else 0
    n_kv = 0
    if cfg.n_heads:
        # preserve the GQA ratio where possible
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        n_kv = max(n_heads // min(ratio, n_heads), 1)
    repl = dict(
        name=cfg.name + "_reduced",
        n_layers=2,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d // n_heads if n_heads else 0,
        d_ff=512,
        vocab=512,
        chunk_size=64,
        dtype="float32",
    )
    if cfg.family == "moe":
        repl.update(n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2))
    if cfg.family == "ssm":
        repl.update(rwkv_heads=4)
    if cfg.family == "hybrid":
        repl.update(
            n_layers=2, attn_every=1, ssm_state=16, ssm_head_dim=32,
            sliding_window=min(cfg.sliding_window or 64, 64),
        )
    if cfg.family == "encdec":
        repl.update(n_enc_layers=2)
    if cfg.family == "vlm":
        repl.update(n_vis_tokens=8)
    if cfg.sliding_window and cfg.family not in ("hybrid",):
        repl.update(sliding_window=64)
    return dataclasses.replace(cfg, **repl)


def long_context_variant(cfg: ModelConfig, window: int = 8192) -> ModelConfig:
    """Window-bound a full-attention config so ``long_500k`` decode lowers
    with an O(window) cache. No-op for natively sub-quadratic families or
    configs that already carry a window (e.g. starcoder2)."""
    if cfg.family in ("ssm", "hybrid") or cfg.sliding_window:
        return cfg
    return dataclasses.replace(cfg, sliding_window=window)
