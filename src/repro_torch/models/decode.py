"""Serving path in torch: cache construction, prefill and one-token decode.

The port of ``repro.models.decode`` for the dense family. The cache keeps
the JAX package's layout: k/v ring buffers (L, B, Lc, KV, hd) in the
activation dtype, ``slot_pos`` (Lc,) int32 holding each slot's absolute
position (-1 = empty), and ``pos``, the next position (a Python int here).
``Lc = cfg.effective_cache_len(seq_len)`` is bounded by the sliding window
when the config sets one. RoPE is applied to keys at write time with
absolute positions, so ring overwrites need no re-rotation.

Unlike the JAX functions, which return a new cache, :func:`decode_step`
updates the cache's tensors in place (and returns the same dict): at
Llama-3-8B's size a copy of the cache per token would cost 2.2 GB of
traffic for nothing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    Params, _merge_heads, _proj_heads, _self_attention, layer_params, lm_head, require_dense,
)

Cache = dict


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Empty cache sized for a context of ``seq_len`` tokens, in the
    activation dtype, on ``device`` (``cuda`` unless asked otherwise)."""
    require_dense(cfg, "init_cache")
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    lc = cfg.effective_cache_len(seq_len)
    shape = (cfg.n_layers, batch_size, lc, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "slot_pos": torch.full((lc,), -1, dtype=torch.int32, device=dev),
        "pos": 0,
    }


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
    Returns (logits (B, V) fp32, the cache, updated in place)."""
    require_dense(cfg, "decode_step")
    pos = cache["pos"]
    h = layers.embed(params["embed"], tokens, cfg.activation_dtype)   # (B, D)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = h + _attn_cache_step(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], cache["slot_pos"], pos,
        )
        y = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + layers.swiglu(lp["mlp"], y[:, None, :])[:, 0, :]
    cache["pos"] = pos + 1
    h = layers.rmsnorm(params["final_norm"], h[:, None, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :], cache


def prefill(cfg: ModelConfig, params: Params, batch: dict,
            seq_len: int) -> tuple[torch.Tensor, Cache]:
    """Run the context ``batch["tokens"]`` (B, S) through the model, build a
    cache for ``seq_len`` positions and return the last logits (B, V) fp32.

    Each layer ring-writes the RoPE'd k/v of its last ``min(Lc, S)``
    positions into slots ``(S - m_keep + arange(m_keep)) % Lc``. Attention
    over the context goes through ``model._self_attention``, so a long
    context with ``attn_impl="flash"`` runs the flash kernel once per layer.
    """
    require_dense(cfg, "prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, seq_len, device=dev)
    lc = cache["slot_pos"].shape[0]
    m_keep = min(lc, s)
    kept = torch.arange(s - m_keep, s, device=dev)
    slots = kept % lc
    positions = torch.arange(s, device=dev)
    h = layers.embed(params["embed"], tokens, cfg.activation_dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        a, k, v = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=True, positions=positions,
        )
        h = h + a
        h = h + layers.swiglu(lp["mlp"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
        cache["k"][i][:, slots] = k[:, s - m_keep:]
        cache["v"][i][:, slots] = v[:, s - m_keep:]
    cache["slot_pos"][slots] = kept.to(torch.int32)
    cache["pos"] = s
    h = layers.rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :], cache
