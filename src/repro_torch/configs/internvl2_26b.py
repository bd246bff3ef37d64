"""InternVL2-26B [arXiv:2404.16821]: InternViT vision encoder + InternLM2 LM.

The ViT + pixel-shuffle projector is a STUB per the assignment:
``input_specs`` provides 256 precomputed patch embeddings per image; this
config is the 26B language backbone (48L InternLM2-20B-class geometry).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553, n_vis_tokens=256,
    rope_theta=1000000.0, source="arXiv:2404.16821",
)
