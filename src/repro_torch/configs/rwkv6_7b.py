"""RWKV6 "Finch" 7B [arXiv:2404.05892]: attention-free, data-dependent decay.

O(1) state per layer -> ``long_500k`` runs natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    rwkv_heads=64,  # 4096 / 64 per-head channels
    d_ff=14336, vocab=65536, source="arXiv:2404.05892",
)
