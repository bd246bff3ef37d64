"""Granite-3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
MoE with 32 experts top-8, GQA kv=8, d_ff 512 per expert."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, n_experts=32, top_k=8,
    rope_theta=10000.0, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
