"""Serving path in torch: cache construction, prefill and one-token decode.

The port of ``repro.models.decode`` for the attention families (dense,
moe, vlm, encdec). The cache keeps the JAX package's layout: k/v ring
buffers (L, B, Lc, KV, hd) in the activation dtype, ``slot_pos`` (Lc,)
int32 holding each slot's absolute position (-1 = empty), and ``pos``,
the next position (a Python int here). ``Lc = cfg.effective_cache_len(seq_len)``
is bounded by the sliding window when the config sets one. RoPE is
applied to keys at write time with absolute positions, so ring overwrites
need no re-rotation. The encdec cache adds the encoder's cross-attention
k/v, ``mem_k``/``mem_v`` (L, B, S_src, KV, hd), ``None`` until
:func:`encode`; its ring holds the decoder's (target) positions. The vlm
family's positions count its patch tokens first.

Unlike the JAX functions, which return a new cache, :func:`decode_step`
and :func:`encode` update the cache in place (and return the same dict):
at Llama-3-8B's size a copy of the cache per token would cost 2.2 GB of
traffic for nothing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    Params, _cross_attention, _forward_encoder, _merge_heads, _proj_heads, _self_attention,
    embed_inputs, ffn, layer_params, lm_head, require_served,
)

Cache = dict


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Empty cache sized for ``seq_len`` positions, in the activation
    dtype, on ``device`` (``cuda`` unless asked otherwise)."""
    require_served(cfg, "init_cache")
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    lc = cfg.effective_cache_len(seq_len)
    shape = (cfg.n_layers, batch_size, lc, cfg.n_kv_heads, cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "slot_pos": torch.full((lc,), -1, dtype=torch.int32, device=dev),
        "pos": 0,
    }
    if cfg.family == "encdec":
        cache["mem_k"] = None      # filled by encode(), sized for the source length
        cache["mem_v"] = None
    return cache


def cache_spec(cfg: ModelConfig, batch_size: int, seq_len: int, src_len: int = 0) -> Cache:
    """The cache's tensors on the ``meta`` device (shapes and dtypes, no
    storage): the counterpart of the JAX package's ``eval_shape`` spec.
    The encdec family's cross k/v are sized for ``src_len`` (default
    ``seq_len``) source positions."""
    cache = init_cache(cfg, batch_size, seq_len, device="meta")
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch_size, src_len or seq_len, cfg.n_kv_heads, cfg.hd)
        cache["mem_k"] = torch.empty(shape, dtype=cfg.activation_dtype, device="meta")
        cache["mem_v"] = torch.empty(shape, dtype=cfg.activation_dtype, device="meta")
    return cache


def encode(cfg: ModelConfig, params: Params, cache: Cache, src_embeds: torch.Tensor) -> Cache:
    """The encdec family's encoder side: the encoder over ``src_embeds``
    (B, S_src, D), then each decoder layer's cross-attention k/v of its
    output, written into ``cache["mem_k"]``/``cache["mem_v"]`` (the cache,
    returned)."""
    mem = _forward_encoder(cfg, params, src_embeds.to(cfg.activation_dtype))
    b, s = mem.shape[:2]
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
    mem_k = torch.empty(shape, dtype=mem.dtype, device=mem.device)
    mem_v = torch.empty_like(mem_k)
    for i in range(cfg.n_layers):
        xp = layer_params(params, i)["xattn"]
        mem_k[i] = _proj_heads(mem, xp["wk"])
        mem_v[i] = _proj_heads(mem, xp["wv"])
    cache["mem_k"], cache["mem_v"] = mem_k, mem_v
    return cache


def _attn_cache_step(cfg: ModelConfig, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step of a cached self-attention. x: (B, D). Writes this
    position's k/v into slot ``pos % Lc`` of the layer's cache views and
    marks the slot in ``slot_pos``, in place."""
    lc = k_cache.shape[1]
    q = _proj_heads(x, p["wq"])[:, None]                 # (B, 1, H, hd)
    k = _proj_heads(x, p["wk"])[:, None]
    v = _proj_heads(x, p["wv"])[:, None]
    posf = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    q = layers.apply_rope(q, posf, cfg.rope_theta)
    k = layers.apply_rope(k, posf, cfg.rope_theta)
    slot = pos % lc
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    slot_pos[slot] = pos
    o = layers.decode_attention(q, k_cache, v_cache, slot_pos)
    return _merge_heads(o[:, 0], p["wo"])


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor) -> tuple[torch.Tensor, Cache]:
    """One token for every sequence in the batch. tokens: (B,) int.
    Returns (logits (B, V) fp32, the cache, updated in place). The moe
    family routes with ``capacity_factor = n_experts``: no drops at S = 1."""
    require_served(cfg, "decode_step")
    encdec = cfg.family == "encdec"
    if encdec and cache["mem_k"] is None:
        raise ValueError("decode_step: the encdec cache has no cross k/v; run encode() first")
    pos = cache["pos"]
    h = layers.embed(params["embed"], tokens, cfg.activation_dtype)   # (B, D)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = h + _attn_cache_step(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], cache["slot_pos"], pos,
        )
        if encdec:
            c = _cross_attention(cfg, lp["xattn"],
                                 layers.rmsnorm(lp["ln_x"], h, cfg.norm_eps)[:, None, :],
                                 cache["mem_k"][i], cache["mem_v"][i])
            h = h + c[:, 0, :]
        y = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
        m, _ = ffn(cfg, lp, y[:, None, :], capacity_factor=float(cfg.n_experts))
        h = h + m[:, 0, :]
    cache["pos"] = pos + 1
    h = layers.rmsnorm(params["final_norm"], h[:, None, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :], cache


def prefill(cfg: ModelConfig, params: Params, batch: dict,
            seq_len: int) -> tuple[torch.Tensor, Cache]:
    """Run the context through the model, build a cache for ``seq_len``
    positions and return the last logits (B, V) fp32.

    ``batch`` holds ``tokens`` (B, S), with ``vis_embeds`` (B, n_vis, D)
    for vlm (its positions come first); for encdec it holds
    ``src_embeds`` (B, S_src, D) and the prefill is :func:`encode`
    followed by one :func:`decode_step` of BOS = 0, as in the JAX package.

    Each layer ring-writes the RoPE'd k/v of its last ``min(Lc, S)``
    positions into slots ``(S - m_keep + arange(m_keep)) % Lc``. Attention
    over the context goes through ``model._self_attention``, so a long
    context with ``attn_impl="flash"`` runs the flash kernel once per layer.
    """
    require_served(cfg, "prefill")
    if cfg.family == "encdec":
        src = batch["src_embeds"]
        b = src.shape[0]
        cache = encode(cfg, params, init_cache(cfg, b, seq_len, device=src.device), src)
        bos = torch.zeros((b,), dtype=torch.int64, device=src.device)
        return decode_step(cfg, params, cache, bos)
    h = embed_inputs(cfg, params, batch)
    b, s = h.shape[:2]
    dev = h.device
    cache = init_cache(cfg, b, seq_len, device=dev)
    lc = cache["slot_pos"].shape[0]
    m_keep = min(lc, s)
    kept = torch.arange(s - m_keep, s, device=dev)
    slots = kept % lc
    positions = torch.arange(s, device=dev)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        a, k, v = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=True, positions=positions,
        )
        h = h + a
        m, _ = ffn(cfg, lp, layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
        h = h + m
        cache["k"][i][:, slots] = k[:, s - m_keep:]
        cache["v"][i][:, slots] = v[:, s - m_keep:]
    cache["slot_pos"][slots] = kept.to(torch.int32)
    cache["pos"] = s
    h = layers.rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :], cache
