"""Granite-4.0-H Small, 32B-A9B [hf:ibm-granite/granite-4.0-h-small,
``model_type`` granitemoehybrid]: 40 layers of a Mamba-2 or NoPE GQA mixer
(attention at layers 5, 15, 25, 35), each followed by a 72-expert top-10
MoE of 768-wide SwiGLU experts and one shared 1,536-wide SwiGLU expert.
The port's ``hybrid_moe`` family; not one of the JAX package's ten
(``configs.ARCH_IDS``)."""
from repro_torch.models.config import HybridMoeConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoeConfig(
    name="granite_4_0_h_small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab=100352, n_experts=72, top_k=10,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, chunk_size=256,
    layer_types=_PERIOD[:5] + (_PERIOD[5:] + _PERIOD[:5]) * 3 + _PERIOD[5:],
    shared_ff=1536, embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0,
    conv_bias=True, norm_eps=1e-5, rope_theta=10000.0, tie_embeddings=True,
    source="hf:ibm-granite/granite-4.0-h-small",
)
