"""Model factory in torch: init and the serving forward for all families.

The port of ``repro.models.model``: dense (Llama, Yi, StarCoder2,
Phi-3), moe (Granite, Grok-1: ``models/moe.py`` in place of the SwiGLU),
vlm (InternVL2: projected patch embeddings prepended to the text), encdec
(SeamlessM4T: a non-causal encoder over frame embeddings, a decoder with
cross-attention), ssm (RWKV6: ``models/rwkv6.py`` time mix and channel
mix) and hybrid (Zamba2: ``models/mamba2.py`` blocks with one
weight-shared, window-bounded attention + MLP block applied every
``attn_every`` layers). Layers are stacked on a leading L axis, as in the
JAX package, so its parameter pytree carries over leaf for leaf
(:func:`params_from_numpy`); the layer loop is a Python loop over views of
the stacked tensors (no remat: this is the serving forward).
:func:`init_params` holds the matrices in ``cfg.activation_dtype``, cast
once, where the JAX package keeps fp32 masters and casts them at every
use: the same numbers. The vectors the JAX code reads in fp32 (norms, the
RWKV decay LoRA, bonus and mixing vectors, the Mamba2 ``a_log``,
``d_skip`` and ``dt_bias``) stay fp32. The forward still casts at use, so
the fp32 parameters of :func:`params_from_numpy` run too.

``forward_train`` and the ring variant of the flash dispatch are not
ported yet (ROADMAP Queue 1, items 8 and 9).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.models import layers, mamba2, moe, rwkv6
from repro_torch.models.config import ModelConfig

Params = dict
DENSE_ATTN_MAX_SEQ = 2048  # above this, use the chunked online-softmax path
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
RWKV_CHUNK = 64            # the chunked WKV's chunk and gate, fixed as in the JAX code


# =====================================================================
# init
# =====================================================================

def _dense_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    p = {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": layers.attention_params(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype),
    }
    if cfg.family == "moe":
        p["moe"] = moe.moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers, dtype)
    else:
        p["mlp"] = layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype)
    return p


def _rwkv_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "tm": rwkv6.time_mix_params(gen, cfg.d_model, cfg.rwkv_heads, cfg.n_layers, dtype),
        "cm": rwkv6.channel_mix_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def _mamba_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln": layers.rmsnorm_params(cfg.d_model, gen.device),
        "mamba": mamba2.mamba2_params(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                      cfg.ssm_head_dim, cfg.n_layers, dtype),
    }


def _encdec_dec_layer_params(cfg: ModelConfig, gen: torch.Generator,
                             dtype: torch.dtype) -> dict:
    def attn() -> dict:
        return layers.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                       dtype)

    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln_x": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": attn(),
        "xattn": attn(),
        "mlp": layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def _stack_layers(layer_fn, cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
                  n: int) -> dict:
    """``n`` layers of ``layer_fn`` stacked on a leading axis, drawn one at a
    time into the stacked tensors, so a full-size model never has its fp32
    draws all at once."""
    layer = layer_fn(cfg, gen, dtype)
    stacked = tree_util.map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
    for i in range(n):
        if i:
            layer = layer_fn(cfg, gen, dtype)
        for dst, src in zip(tree_util.leaves(stacked), tree_util.leaves(layer)):
            dst[i] = src
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random parameters from ``seed``, made on ``device`` (``cuda`` unless
    asked otherwise) by a generator there, in the JAX package's tree,
    shapes and scales. Matrices are drawn in fp32 and stored in
    ``cfg.activation_dtype``; norm scales and the vectors the recurrent
    families read in fp32 (RWKV6's decay LoRA, bonus, mixing vectors and
    group-norm affine; Mamba2's ``a_log``, ``d_skip``, ``dt_bias``) stay
    fp32.
    torch's generator cannot replay ``jax.random``: carry the JAX package's
    weights over with :func:`params_from_numpy`."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params: Params = {
        "embed": layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": layers.rmsnorm_params(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype)
    fam = cfg.family
    if fam == "encdec":
        params["enc_layers"] = _stack_layers(_dense_layer_params, cfg, gen, dtype,
                                             cfg.n_enc_layers)
        params["layers"] = _stack_layers(_encdec_dec_layer_params, cfg, gen, dtype,
                                         cfg.n_layers)
        params["enc_norm"] = layers.rmsnorm_params(cfg.d_model, dev)
    elif fam == "ssm":
        params["layers"] = _stack_layers(_rwkv_layer_params, cfg, gen, dtype, cfg.n_layers)
    elif fam == "hybrid":
        params["layers"] = _stack_layers(_mamba_layer_params, cfg, gen, dtype, cfg.n_layers)
        params["shared_attn"] = {
            "ln": layers.rmsnorm_params(cfg.d_model, dev),
            "ln2": layers.rmsnorm_params(cfg.d_model, dev),
            "attn": layers.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                            cfg.hd, dtype),
            "mlp": layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
        }
    else:
        params["layers"] = _stack_layers(_dense_layer_params, cfg, gen, dtype, cfg.n_layers)
    if fam == "vlm":
        params["vis_proj"] = {"w": layers.dense_init((cfg.d_model, cfg.d_model), 0.02, gen,
                                                     dtype)}
    return params


def params_from_numpy(tree: dict,
                      device: Optional[Union[str, torch.device]] = None) -> Params:
    """The JAX package's parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) -> this module's
    parameters, same layouts (stacked L axis included), fp32 copies on
    ``device``."""
    dev = resolve_device(device)
    return tree_util.map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), tree)


def layer_params(params: Params, i: int, stack: str = "layers") -> dict:
    """Layer ``i`` of the stacked ``params[stack]`` (views, no copy):
    ``"layers"``, or the encdec family's ``"enc_layers"``."""
    return tree_util.map(lambda t: t[i], params[stack])


# =====================================================================
# attention block helpers
# =====================================================================

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul, in x's dtype."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one matmul, in o's dtype."""
    h, k, d = w.shape
    return torch.matmul(o.reshape(o.shape[:-2] + (h * k,)), w.to(o.dtype).reshape(h * k, d))


def _flash_dispatch(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int) -> torch.Tensor:
    """``attn_impl="flash"``: single-device blockwise flash attention. The
    kernel picks its own tiles, so the config's chunk size only gates the
    dispatch (``s % chunk_size == 0``). The ring variant on a sequence-sharded mesh is ROADMAP Queue 1 item 9."""
    return layers.flash_attention(q, k, v, causal=causal, window=window)


def _self_attention(
    cfg: ModelConfig, p: dict, x: torch.Tensor, *, causal: bool, positions: torch.Tensor,
    window_override: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out, k_rope, v) — k/v for optional cache building.
    Short or non-divisible sequences take dense attention, long ones flash
    (``attn_impl="flash"``) or chunked attention, as in the JAX package.
    ``window_override`` replaces the config's window (the hybrid family's
    shared attention). The chunked path's ``causal_skip`` belongs to
    training (ROADMAP Queue 1 item 8)."""
    window = cfg.sliding_window if window_override is None else window_override
    q = layers.apply_rope(_proj_heads(x, p["wq"]), positions, cfg.rope_theta)
    k = layers.apply_rope(_proj_heads(x, p["wk"]), positions, cfg.rope_theta)
    v = _proj_heads(x, p["wv"])
    s = x.shape[1]
    if s <= DENSE_ATTN_MAX_SEQ or s % cfg.chunk_size != 0:
        o = layers.dense_attention(q, k, v, causal=causal, window=window)
    elif cfg.attn_impl == "flash":
        o = _flash_dispatch(cfg, q, k, v, causal=causal, window=window)
    else:
        o = layers.chunked_attention(q, k, v, chunk=cfg.chunk_size, causal=causal,
                                     window=window)
    return _merge_heads(o, p["wo"]), k, v


def ffn(cfg: ModelConfig, p: dict, y: torch.Tensor, *,
        capacity_factor: Optional[float] = None) -> tuple[torch.Tensor, dict]:
    """The layer's feed-forward of y (B, S, D): the MoE (with its aux
    values) for the moe family, else the SwiGLU (no aux).
    ``capacity_factor`` overrides the config's (decode passes n_experts:
    no drops at S = 1)."""
    if cfg.family == "moe":
        cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
        return moe.moe_apply(p["moe"], y, top_k=cfg.top_k, capacity_factor=cf)
    return layers.swiglu(p["mlp"], y), {}


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, _ = _self_attention(
        cfg, p["attn"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps),
        causal=True, positions=positions,
    )
    x = x + h
    m, aux = ffn(cfg, p, layers.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + m, aux


def _forward_dense(cfg: ModelConfig, params: Params,
                   x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The decoder stack of the dense, moe and vlm families; the aux
    values averaged over the layers (none for dense and vlm)."""
    auxs = []
    for i in range(cfg.n_layers):
        x, aux = _dense_block(cfg, layer_params(params, i), x)
        auxs.append(aux)
    return x, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def _rwkv_block(cfg: ModelConfig, p: dict, x: torch.Tensor, x_tm: torch.Tensor,
                x_cm: torch.Tensor, s0: torch.Tensor):
    """One RWKV6 layer over x (B, T, D) from the carries ``x_tm``, ``x_cm``
    (B, D) and the WKV state ``s0``; the chunked WKV when T is a multiple
    of 64 above 1. Returns (x, tm carry, cm carry, state)."""
    t = x.shape[1]
    h, tm_carry, s_new = rwkv6.time_mix_apply(
        p["tm"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps), x_tm, s0, cfg.rwkv_heads,
        chunked=t % RWKV_CHUNK == 0 and t > 1, chunk=RWKV_CHUNK,
    )
    x = x + h
    c, cm_carry = rwkv6.channel_mix_apply(p["cm"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps),
                                          x_cm)
    return x + c, tm_carry, cm_carry, s_new


def _mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 state: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    t = x.shape[1]
    chunk = min(cfg.chunk_size, 128)       # the SSD scan's chunk
    h, new_state = mamba2.mamba2_apply(
        p["mamba"], layers.rmsnorm(p["ln"], x, cfg.norm_eps),
        d_inner=cfg.d_inner, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        state=state, chunk=chunk, chunked=t % chunk == 0 and t > 1,
    )
    return x + h, new_state


def rwkv_state(cfg: ModelConfig, b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's zero token-shift carry (B, D) and WKV state (B, H, N, N) fp32."""
    n = cfg.d_model // cfg.rwkv_heads
    return (torch.zeros((b, cfg.d_model), dtype=cfg.activation_dtype, device=device),
            torch.zeros((b, cfg.rwkv_heads, n, n), dtype=torch.float32, device=device))


def _forward_rwkv(cfg: ModelConfig, params: Params, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    x_prev, s0 = rwkv_state(cfg, x.shape[0], x.device)
    for i in range(cfg.n_layers):
        x, _, _, _ = _rwkv_block(cfg, layer_params(params, i), x, x_prev, x_prev, s0)
    return x, {}


def shared_window(cfg: ModelConfig) -> int:
    """The hybrid family's shared-attention window: bounded even without a
    configured one, so long-context serving stays O(window)."""
    return cfg.sliding_window or 4096


def _shared_attn_block(cfg: ModelConfig, shared: dict, h: torch.Tensor,
                       positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hybrid family's shared attention + MLP over h (B, S, D);
    returns (h, k_rope, v)."""
    a, k, v = _self_attention(
        cfg, shared["attn"], layers.rmsnorm(shared["ln"], h, cfg.norm_eps),
        causal=True, positions=positions, window_override=shared_window(cfg),
    )
    h = h + a
    return h + layers.swiglu(shared["mlp"], layers.rmsnorm(shared["ln2"], h, cfg.norm_eps)), k, v


def _forward_hybrid(cfg: ModelConfig, params: Params,
                    x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``n_layers // attn_every`` super-blocks: ``attn_every`` Mamba2
    layers, then the shared attention block."""
    positions = torch.arange(x.shape[1], device=x.device)
    for j in range(cfg.n_layers // cfg.attn_every):
        for i in range(j * cfg.attn_every, (j + 1) * cfg.attn_every):
            x, _ = _mamba_block(cfg, layer_params(params, i), x)
        x, _, _ = _shared_attn_block(cfg, params["shared_attn"], x, positions)
    return x, {}


def _forward_encoder(cfg: ModelConfig, params: Params, src: torch.Tensor) -> torch.Tensor:
    """The encdec family's encoder: non-causal self-attention over the
    source frames, then ``enc_norm``."""
    positions = torch.arange(src.shape[1], device=src.device)
    h = src
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params, i, "enc_layers")
        a, _, _ = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=False, positions=positions,
        )
        h = h + a
        h = h + layers.swiglu(lp["mlp"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    return layers.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def _cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, mem_k: torch.Tensor,
                     mem_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) attends, without a mask or RoPE, to the encoder's k/v
    (B, S_src, KV, hd); dense attention, as in the JAX package."""
    q = _proj_heads(x, p["wq"])
    o = layers.dense_attention(q, mem_k, mem_v, causal=False)
    return _merge_heads(o, p["wo"])


def _forward_encdec(cfg: ModelConfig, params: Params, src: torch.Tensor,
                    tgt: torch.Tensor) -> tuple[torch.Tensor, dict]:
    mem = _forward_encoder(cfg, params, src)
    positions = torch.arange(tgt.shape[1], device=tgt.device)
    h = tgt
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        a, _, _ = _self_attention(
            cfg, lp["attn"], layers.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            causal=True, positions=positions,
        )
        h = h + a
        xp = lp["xattn"]
        h = h + _cross_attention(cfg, xp, layers.rmsnorm(lp["ln_x"], h, cfg.norm_eps),
                                 _proj_heads(mem, xp["wk"]), _proj_heads(mem, xp["wv"]))
        h = h + layers.swiglu(lp["mlp"], layers.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    return h, {}


def embed_inputs(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """The decoder input (B, S, D) of every family but encdec: the
    embedded ``batch["tokens"]``, and for vlm the projected
    ``batch["vis_embeds"]`` (B, n_vis, D) in front of them."""
    dtype = cfg.activation_dtype
    x = layers.embed(params["embed"], batch["tokens"], dtype)
    if cfg.family == "vlm":
        vis = torch.matmul(batch["vis_embeds"].to(dtype), params["vis_proj"]["w"].to(dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def lm_head(cfg: ModelConfig, params: Params) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward_logits(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Last-position logits (B, V) fp32 of ``batch``: ``tokens`` (B, S),
    with ``vis_embeds`` (B, n_vis, D) for vlm, or ``src_embeds``
    (B, S_src, D) and the target ``tokens`` for encdec."""
    fam = cfg.family
    if fam == "encdec":
        src = batch["src_embeds"].to(cfg.activation_dtype)
        tgt = layers.embed(params["embed"], batch["tokens"], cfg.activation_dtype)
        h, _ = _forward_encdec(cfg, params, src, tgt)
    elif fam == "ssm":
        h, _ = _forward_rwkv(cfg, params, embed_inputs(cfg, params, batch))
    elif fam == "hybrid":
        h, _ = _forward_hybrid(cfg, params, embed_inputs(cfg, params, batch))
    else:
        h, _ = _forward_dense(cfg, params, embed_inputs(cfg, params, batch))
    h = layers.rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :]
