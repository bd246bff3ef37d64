"""SeamlessM4T-large v2 [arXiv:2308.11596]: enc-dec multimodal backbone.

The speech frontend (mel + conformer feature extractor) is a STUB per the
assignment: ``input_specs`` provides precomputed frame embeddings of shape
(B, S_frames, d_model); this config is the transformer backbone only.
24 encoder + 24 decoder layers, d_model 1024, MHA (kv=16), vocab 256206.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_large_v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab=256206, rope_theta=10000.0,
    source="arXiv:2308.11596",
)
