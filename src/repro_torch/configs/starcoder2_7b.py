"""StarCoder2-7B [arXiv:2402.19173]: dense, GQA kv=4, RoPE, native
sliding-window attention (w=4096) -> ``long_500k`` uses the native window."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152, rope_theta=1000000.0, sliding_window=4096,
    source="arXiv:2402.19173",
)
