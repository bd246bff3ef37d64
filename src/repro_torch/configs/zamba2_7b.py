"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

81 Mamba2 layers (d_state 64) with ONE weight-shared GQA attention block
applied every 9 layers (the paper interleaves shared blocks; we use a
uniform period that divides 81 — see DESIGN.md). Shared attention is
window-bounded (4096) so long-context decode stays O(window).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=9, sliding_window=4096, rope_theta=10000.0,
    source="arXiv:2411.15242",
)
