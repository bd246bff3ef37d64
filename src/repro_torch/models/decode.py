"""Serving path in torch: cache construction, prefill and one-token decode.

The port of ``repro.models.decode``, with its cache layouts:
  dense/moe/vlm : k/v ring buffers (L, B, Lc, KV, hd) in the activation
                  dtype, ``slot_pos`` (Lc,) int32 holding each slot's
                  absolute position (-1 = empty), ``pos`` the next
                  position (a Python int here);
  encdec        : the same decoder ring, plus the encoder's cross-attention
                  k/v ``mem_k``/``mem_v`` (L, B, S_src, KV, hd), ``None``
                  until :func:`encode`;
  ssm (rwkv6)   : the WKV state ``s`` (L, B, H, N, N) fp32 and the two
                  token-shift carries ``x_tm``/``x_cm`` (L, B, D);
  hybrid        : each Mamba2 layer's ``ssm`` (L, B, H, N, P) fp32 and
                  ``conv`` (L, B, CONV_K - 1, C) states, and one k/v ring
                  per shared-attention *application* (n_super, B, Lc, KV,
                  hd) with one shared ``slot_pos``; its ``Lc`` is
                  ``min(sliding_window or 4096, seq_len)``.
``Lc = cfg.effective_cache_len(seq_len)`` elsewhere: bounded by the
sliding window when the config sets one. RoPE is applied to keys at write
time with absolute positions, so ring overwrites need no re-rotation. The
vlm family's positions count its patch tokens first.

Under a sequence-parallel plan (``models.model``'s docstring) the
:func:`prefill` of every family runs each rank's shard of the context and
leaves every rank with the whole cache (its positions are never sharded,
as the JAX package's ``cache_seq`` rule says): each layer's k/v ring
takes the context's last positions from the seq group (broadcast from the
last rank where its shard holds them all, else gathered), the recurrent
states and carries and the last logits come from the last seq rank, and
decoding runs replicated. The encdec family's :func:`encode` runs the
source's shard through the ring and gathers the encoder memory over
``seq`` once, so every rank builds the whole cross k/v; its BOS step runs
whole on every rank.

Under a tensor-parallel serve plan (``make_plan(mesh, mode="serve")``,
``params`` placed as DTensors) each rank runs its heads, SwiGLU columns,
experts, RWKV6 or Mamba2 heads; its cache holds its part as the JAX
package's ``_CACHE_DIMS`` lays it out (``cache_seq`` is never sharded):
the k/v rings (the hybrid family's shared-attention rings and encdec's
cross k/v too) its KV/m heads where KV divides the ``model`` axis, else
every KV head; RWKV6's ``s`` and Mamba2's ``ssm`` its heads; the shift
carries and the conv carry whole. The vocab table is gathered at use, so
every rank leaves with the same logits.

Unlike the JAX functions, which return a new cache, :func:`decode_step`
and :func:`encode` update the cache in place (and return the same dict):
at Llama-3-8B's size a copy of the cache per token would cost 2.2 GB of
traffic for nothing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import collectives, parallel
from repro_torch.models import layers, mamba2, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    _SEQ_SHARD, Params, _cross_attention, _holding, _mamba_block, _merge_heads, _positions,
    _proj_heads, _rwkv_block, _self_attention, _shared_attn_block, attention_mode,
    cross_memory, embed_inputs, embed_table, encode_memory, expand_local_kv, ffn,
    final_norm, from_last_shard, head_table, layer_params, mlp, rwkv_heads, rwkv_state,
    seq_shard, shared_window, tail_of_sequence,
)

Cache = dict


def _on_rank(n: int, path: tuple, dim: int) -> int:
    """``n`` heads, or the rank's n/m when the leaf at ``path`` is sharded
    on ``model`` along ``dim``."""
    return n // parallel.current().model if parallel.on_model(path, dim) else n


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Empty cache sized for ``seq_len`` positions (the module's layouts),
    on ``device`` (``cuda`` unless asked otherwise)."""
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    b = batch_size
    if cfg.family == "ssm":
        n = cfg.d_model // cfg.rwkv_heads
        heads = _on_rank(cfg.rwkv_heads, ("layers", "tm", "wr"), 2)
        return {
            "s": torch.zeros((cfg.n_layers, b, heads, n, n), dtype=torch.float32, device=dev),
            "x_tm": torch.zeros((cfg.n_layers, b, cfg.d_model), dtype=dt, device=dev),
            "x_cm": torch.zeros((cfg.n_layers, b, cfg.d_model), dtype=dt, device=dev),
            "pos": 0,
        }
    if cfg.family == "hybrid":
        lc = min(shared_window(cfg), seq_len)
        n_super = cfg.n_layers // cfg.attn_every
        ring = (n_super, b, lc, _on_rank(cfg.n_kv_heads, ("shared_attn", "attn", "wk"), 1),
                cfg.hd)
        heads = _on_rank(cfg.n_ssm_heads, ("layers", "mamba", "w_out"), 1)
        return {
            "ssm": torch.zeros((cfg.n_layers, b, heads, cfg.ssm_state, cfg.ssm_head_dim),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.n_layers, b, mamba2.CONV_K - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state), dtype=dt, device=dev),
            "k": torch.zeros(ring, dtype=dt, device=dev),
            "v": torch.zeros(ring, dtype=dt, device=dev),
            "slot_pos": torch.full((lc,), -1, dtype=torch.int32, device=dev),
            "pos": 0,
        }
    lc = cfg.effective_cache_len(seq_len)
    shape = (cfg.n_layers, b, lc, _on_rank(cfg.n_kv_heads, ("layers", "attn", "wk"), 2), cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "slot_pos": torch.full((lc,), -1, dtype=torch.int32, device=dev),
        "pos": 0,
    }
    if cfg.family == "encdec":
        cache["mem_k"] = None      # filled by encode(), sized for the source length
        cache["mem_v"] = None
    elif cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(cfg.family)
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
    returned). Under a sequence-parallel plan that cuts the source, each
    rank runs its shard (the ring, non-causal) and the memory is gathered
    over ``seq`` once: every rank leaves with the whole cross k/v."""
    view, params, _ = parallel.enter(cfg, params)
    with parallel.holding(view):
        return _encode(cfg, params, cache, src_embeds)


def _encode(cfg: ModelConfig, params: Params, cache: Cache, src_embeds: torch.Tensor) -> Cache:
    shards, batch = seq_shard(cfg, {"src_embeds": src_embeds})
    mem = encode_memory(cfg, params, batch["src_embeds"].to(cfg.activation_dtype), shards)
    kv = [cross_memory(cfg, parallel.layer(layer_params(params, i))["xattn"], mem)
          for i in range(cfg.n_layers)]
    cache["mem_k"] = torch.stack([k for k, _ in kv])
    cache["mem_v"] = torch.stack([v for _, v in kv])
    return cache


def _attn_cache_step(cfg: ModelConfig, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step of a cached self-attention. x: (B, D). Writes this
    position's k/v into slot ``pos % Lc`` of the layer's cache views and
    marks the slot in ``slot_pos``, in place."""
    lc = k_cache.shape[1]
    mode, p = attention_mode(cfg, p)
    if mode != "whole":
        x = collectives.copy_to_model(x)
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
    o = layers.decode_attention(q, *expand_local_kv(cfg, mode, k_cache, v_cache, q.shape[2]),
                                slot_pos)
    out = _merge_heads(o[:, 0], p["wo"])
    return out if mode == "whole" else collectives.reduce_from_model(out)


def _rwkv_step(cfg: ModelConfig, params: Params, cache: Cache, h: torch.Tensor) -> torch.Tensor:
    """The ssm family's layers at one token: ``time_mix_step`` (the
    sequential WKV at T = 1) and the channel mix, carries and states
    written back into the cache."""
    for i in range(cfg.n_layers):
        lp = parallel.layer(layer_params(params, i))
        a, tm_carry, s_new = rwkv6.time_mix_step(
            lp["tm"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps), cache["x_tm"][i],
            cache["s"][i], cfg.rwkv_heads)
        h = h + a
        c, cm_carry = rwkv6.channel_mix_apply(
            lp["cm"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)[:, None, :], cache["x_cm"][i],
            d_ff=cfg.d_ff)
        h = h + c[:, 0, :]
        cache["s"][i] = s_new
        cache["x_tm"][i] = tm_carry
        cache["x_cm"][i] = cm_carry
    return h


def _hybrid_step(cfg: ModelConfig, params: Params, cache: Cache, h: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """The hybrid family's layers at one token: each Mamba2 layer's step
    on its states, then each shared-attention application on its own ring;
    every application writes slot ``pos % Lc`` of the one ``slot_pos``."""
    shared = parallel.tree(params["shared_attn"], "shared_attn")
    for j in range(cfg.n_layers // cfg.attn_every):
        for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
            lp = parallel.layer(layer_params(params, i))
            a, st = mamba2.mamba2_step(
                lp["mamba"], layers.rmsnorm(lp["ln"], h, cfg.norm_eps),
                {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                d_inner=cfg.d_inner, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
            h = h + a
            cache["ssm"][i] = st["ssm"]
            cache["conv"][i] = st["conv"]
        h = h + _attn_cache_step(
            cfg, shared["attn"], layers.rmsnorm(shared["ln"], h, cfg.norm_eps),
            cache["k"][j], cache["v"][j], cache["slot_pos"], pos)
        y = layers.rmsnorm(shared["ln2"], h, cfg.norm_eps)
        h = h + mlp(cfg, shared["mlp"], y[:, None, :])[:, 0, :]
    return h


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor) -> tuple[torch.Tensor, Cache]:
    """One token for every sequence in the batch. tokens: (B,) int.
    Returns (logits (B, V) fp32, the cache, updated in place). The moe
    family routes with ``capacity_factor = n_experts``: no drops at S = 1."""
    view, params, _ = parallel.enter(cfg, params)
    with parallel.holding(view):
        return _decode_step(cfg, params, cache, tokens)


def _decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                 tokens: torch.Tensor) -> tuple[torch.Tensor, Cache]:
    encdec = cfg.family == "encdec"
    if encdec and cache["mem_k"] is None:
        raise ValueError("decode_step: the encdec cache has no cross k/v; run encode() first")
    pos = cache["pos"]
    h = layers.embed(embed_table(params), tokens, cfg.activation_dtype)   # (B, D)
    if cfg.family == "ssm":
        return _finish_step(cfg, params, cache, _rwkv_step(cfg, params, cache, h))
    if cfg.family == "hybrid":
        return _finish_step(cfg, params, cache, _hybrid_step(cfg, params, cache, h, pos))
    for i in range(cfg.n_layers):
        lp = parallel.layer(layer_params(params, i))
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
    return _finish_step(cfg, params, cache, h)


def _finish_step(cfg: ModelConfig, params: Params, cache: Cache,
                 h: torch.Tensor) -> tuple[torch.Tensor, Cache]:
    """Advance ``pos``; the logits (B, V) fp32 of the last hidden h (B, D)."""
    cache["pos"] += 1
    return _logits(cfg, params, h[:, None, :]), cache


def _logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits (B, V) of the final norm of h (B, 1, D)."""
    return layers.unembed(head_table(cfg, params), final_norm(cfg, params, h))[:, 0, :]


def prefill(cfg: ModelConfig, params: Params, batch: dict,
            seq_len: int) -> tuple[torch.Tensor, Cache]:
    """Run the context through the model, build a cache for ``seq_len``
    positions and return the last logits (B, V) fp32.

    ``batch`` holds ``tokens`` (B, S), with ``vis_embeds`` (B, n_vis, D)
    for vlm (its positions come first); for encdec it holds
    ``src_embeds`` (B, S_src, D) and the prefill is :func:`encode`
    followed by one :func:`decode_step` of BOS = 0, as in the JAX package.
    Under a tensor-parallel serve plan every rank passes the whole batch
    (module docstring).

    Each attention layer ring-writes the RoPE'd k/v of its last
    ``m_keep = min(Lc, S)`` positions into slots ``(S - m_keep +
    arange(m_keep)) % Lc`` (the hybrid family: each shared-attention
    application into its own ring). Attention over the context goes
    through ``model._self_attention``, so a long context with
    ``attn_impl="flash"`` runs the flash kernel once per attention layer.
    The recurrent families keep each layer's final states, from the
    chunked scans when S is a multiple of their chunk.
    """
    view, params, batch = parallel.enter(cfg, params, batch)
    with parallel.holding(view):
        return _prefill(cfg, params, batch, seq_len)


def _prefill(cfg: ModelConfig, params: Params, batch: dict,
             seq_len: int) -> tuple[torch.Tensor, Cache]:
    if cfg.family == "encdec":          # encode cuts the source; BOS runs whole on every rank
        src = batch["src_embeds"]
        b = src.shape[0]
        cache = encode(cfg, params, init_cache(cfg, b, seq_len, device=src.device), src)
        bos = torch.zeros((b,), dtype=torch.int64, device=src.device)
        return decode_step(cfg, params, cache, bos)
    shard, batch = seq_shard(cfg, batch)
    with _holding(shard):
        return _prefill_decoder(cfg, params, batch, seq_len)


def _prefill_decoder(cfg: ModelConfig, params: Params, batch: dict,
                     seq_len: int) -> tuple[torch.Tensor, Cache]:
    """:func:`prefill` of every family but encdec. In a sequence-parallel
    prefill ``batch`` holds this rank's shard of the context and the
    active ``_SEQ_SHARD`` says which: the k/v rings take the context's
    last positions from the shards that hold them, the recurrent states
    and carries come from the last shard, and every rank leaves with the
    whole cache."""
    shard = _SEQ_SHARD.get()
    h = embed_inputs(cfg, params, batch)
    b, s = h.shape[:2]
    positions = _positions(h)
    if shard is not None:
        s *= shard.n                       # the context's length
    dev = h.device
    cache = init_cache(cfg, b, seq_len, device=dev)
    cache["pos"] = s
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            lp = parallel.layer(layer_params(params, i))
            x_prev, s0 = rwkv_state(cfg, b, dev, rwkv_heads(cfg, lp))
            h, cache["x_tm"][i], cache["x_cm"][i], cache["s"][i] = _rwkv_block(
                cfg, lp, h, x_prev, x_prev, s0)
        _states_from_last(cache, ("s", "x_tm", "x_cm"), shard)
        return from_last_shard(_logits(cfg, params, h[:, -1:, :]), shard), cache
    lc = cache["slot_pos"].shape[0]
    m_keep = min(lc, s)
    kept = torch.arange(s - m_keep, s, device=dev)
    slots = kept % lc
    cache["slot_pos"][slots] = kept.to(torch.int32)
    if cfg.family == "hybrid":
        for j in range(cfg.n_layers // cfg.attn_every):
            for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
                h, st = _mamba_block(cfg, parallel.layer(layer_params(params, i)), h)
                cache["ssm"][i], cache["conv"][i] = st["ssm"], st["conv"]
            h, k, v = _shared_attn_block(cfg, parallel.tree(params["shared_attn"], "shared_attn"),
                                         h, positions)
            cache["k"][j][:, slots] = tail_of_sequence(k, m_keep, shard)
            cache["v"][j][:, slots] = tail_of_sequence(v, m_keep, shard)
        _states_from_last(cache, ("ssm", "conv"), shard)
        return from_last_shard(_logits(cfg, params, h[:, -1:, :]), shard), cache
    for i in range(cfg.n_layers):
        lp = parallel.layer(layer_params(params, i))
        a, k, v = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=True, positions=positions,
        )
        h = h + a
        m, _ = ffn(cfg, lp, layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
        h = h + m
        cache["k"][i][:, slots] = tail_of_sequence(k, m_keep, shard)
        cache["v"][i][:, slots] = tail_of_sequence(v, m_keep, shard)
    return from_last_shard(_logits(cfg, params, h[:, -1:, :]), shard), cache


def _states_from_last(cache: Cache, names: tuple, shard) -> None:
    """The recurrent states and carries a sequence-parallel prefill leaves:
    the last shard's (the sequence's end), broadcast once a cache leaf."""
    if shard is not None:
        for name in names:
            cache[name] = from_last_shard(cache[name], shard)
