"""Llama-3 8B [arXiv:2407.21783]: dense decoder, GQA (8 kv heads), 128k vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3_8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=500000.0,
    source="arXiv:2407.21783",
)
