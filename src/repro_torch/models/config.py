"""Model configuration shared by all architecture families.

A copy of ``repro.models.config`` (field for field, the same analytic
parameter counts), except that ``activation_dtype`` is a ``torch.dtype``.
:class:`HybridMoeConfig` is the port's own: the ``hybrid_moe`` family
(Granite-4.0-H), which the JAX package does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int           # 0 for attention-free (rwkv6 time-mix heads below)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0      # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / RWKV ---
    ssm_state: int = 0     # Mamba2 d_state; RWKV uses head_dim-sized state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    rwkv_heads: int = 0    # rwkv6: d_model // 64 by convention
    # --- hybrid (zamba2) ---
    attn_every: int = 0    # apply the shared attention block every k SSM layers
    # --- enc-dec (seamless backbone) ---
    n_enc_layers: int = 0
    # --- vlm ---
    n_vis_tokens: int = 0  # stub patch embeddings prepended to the text
    # --- common ---
    rope_theta: float = 500000.0
    sliding_window: int = 0  # 0 = full causal attention
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # chunk size for sub-quadratic attention paths / SSD scan
    chunk_size: int = 512
    # long-seq attention implementation: "chunked" (lax.scan online
    # softmax) or "flash" (blockwise kernel; ring variant auto-selected
    # on a seq>1 activation mesh). Dense stays the short-seq /
    # non-divisible-shape fallback either way.
    attn_impl: str = "chunked"
    tie_embeddings: bool = False
    source: str = ""       # citation for the assigned config

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: dtype {self.dtype!r} is not a torch dtype")
        return dt

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def effective_cache_len(self, seq_len: int) -> int:
        """KV-cache length for decode: window-bounded if sliding window."""
        if self.sliding_window:
            return min(self.sliding_window, seq_len)
        return seq_len

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline terms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp = 3 * d * ff  # SwiGLU: gate, up, down
        if self.family == "moe":
            mlp = mlp * self.n_experts + d * self.n_experts  # + router
        norms = 2 * d
        per_layer = att + mlp + norms
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix
            tm = 6 * d * d + 8 * d  # r,k,v,g,o,w projections + mixing vectors
            cm = 2 * d * ff + d * d
            per_layer = tm + cm + norms
        if self.family == "hybrid":
            din = self.d_inner
            w_in = d * (2 * din + 2 * self.ssm_state + self.n_ssm_heads)
            per_layer = w_in + din * d + din + norms  # mamba block only;
            # the (single) shared attention+MLP block is added below.
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        total = self.n_layers * per_layer + emb + head
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            enc = self.n_enc_layers * (att + 3 * d * ff + norms)
            dec = self.n_layers * (2 * att + 3 * d * ff + 3 * d)
            total = enc + dec + emb + head
        if self.family == "hybrid" and self.attn_every:
            total += att + 3 * d * ff + 2 * d  # one shared attn+MLP block
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) parameters for MoE rooflines (6 N_active D)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_like = self.param_count() - self.n_layers * 3 * d * ff * self.n_experts
        return int(dense_like + self.n_layers * 3 * d * ff * self.top_k)


@dataclasses.dataclass(frozen=True)
class HybridMoeConfig(ModelConfig):
    """The ``hybrid_moe`` family (``granitemoehybrid``): every layer is a
    mixer (Mamba-2 or NoPE GQA attention, by ``layer_types``, each layer its
    own weights), then a top-k MoE of ``d_ff``-wide SwiGLU experts beside
    one shared SwiGLU expert of width ``shared_ff``. The router has
    ``n_experts`` outputs; the layer holds experts ``experts_held`` = (lo,
    hi) of them (all when empty) and computes their part of the result.
    Routing drops no token. The multipliers are the published ones: the
    embeddings times ``embedding_multiplier``, each residual branch times
    ``residual_multiplier``, attention scores times
    ``attention_multiplier`` (in place of 1/sqrt(hd)), logits divided by
    ``logits_scaling``."""
    layer_types: tuple = ()          # "mamba" | "attention", one per layer (at least n_layers)
    shared_ff: int = 0
    experts_held: tuple = ()
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    conv_bias: bool = True

    @property
    def held(self) -> tuple[int, int]:
        """(lo, hi): the experts this layer holds."""
        return tuple(self.experts_held) if self.experts_held else (0, self.n_experts)

    @property
    def n_held(self) -> int:
        lo, hi = self.held
        return hi - lo

    @property
    def kinds(self) -> tuple:
        """The mixer of each of the ``n_layers`` layers."""
        return tuple(self.layer_types[:self.n_layers])

    def param_count(self) -> int:
        """Every parameter held: the layers (mixer, norms, router, held
        experts, shared expert) and the tied vocabulary table."""
        d, hd, din, n = self.d_model, self.hd, self.d_inner, self.ssm_state
        h_ssm = self.n_ssm_heads
        conv_ch = din + 2 * n
        mamba = (d * (2 * din + 2 * n + h_ssm) + 4 * conv_ch + (conv_ch if self.conv_bias else 0)
                 + 3 * h_ssm + din + din * d)
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        ffn = d * self.n_experts + self.n_held * 3 * d * self.d_ff + 3 * d * self.shared_ff
        total = sum((mamba if k == "mamba" else attn) + ffn + 2 * d for k in self.kinds)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total + emb + d)

    def active_param_count(self) -> int:
        """Parameters a token's matrix products read: the held experts at
        the share of the top-k picks that land on them (k n_held / E
        expert passes a token), the embedding table as the unembedding."""
        d = self.d_model
        routed = self.n_held * 3 * d * self.d_ff
        passes = self.top_k * self.n_held / self.n_experts
        return int(self.param_count() - len(self.kinds) * routed
                   + len(self.kinds) * passes * 3 * d * self.d_ff)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    # small train shape for the per-arch fl-round wire-ratio sweep (full
    # arch weights dominate the uplink bytes; a short sequence keeps the
    # 2x compile per arch affordable in the scheduled job)
    "train_512": InputShape("train_512", 512, 64, "train"),
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
