"""Phi-3-medium 14B [arXiv:2404.14219]: dense, RoPE + SwiGLU + GQA kv=10."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3_medium_14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352, rope_theta=10000.0,
    source="arXiv:2404.14219",
)
