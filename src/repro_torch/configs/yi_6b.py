"""Yi-6B [arXiv:2403.04652]: llama-architecture dense, GQA kv=4."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5000000.0,
    source="arXiv:2403.04652",
)
