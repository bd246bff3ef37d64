"""Grok-1 314B [hf:xai-org/grok-1]: MoE, 8 experts top-2, GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok_1_314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    rope_theta=10000.0, source="hf:xai-org/grok-1",
)
