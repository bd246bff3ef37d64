"""Transformer model in torch: init and the serving forward, dense family.

The port of ``repro.models.model`` for the dense decoder (Llama, Yi,
StarCoder2, Phi-3). Layers are stacked on a leading L axis, as in the JAX
package, so its parameter pytree carries over leaf for leaf
(:func:`params_from_numpy`); the layer loop is a Python loop over views
of the stacked tensors (no remat: this is the serving forward).
:func:`init_params` holds the matrices in ``cfg.activation_dtype``, cast
once, where the JAX package keeps fp32 masters and casts them at every
use: the same numbers. The forward still casts at use, so the fp32
parameters of :func:`params_from_numpy` run too.

Other families (moe, vlm, ssm, hybrid, encdec), ``forward_train`` and the
ring variant of the flash dispatch are not ported yet (ROADMAP Queue 1,
items 8 and 9).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict
DENSE_ATTN_MAX_SEQ = 2048  # above this, use the chunked online-softmax path


def require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the {cfg.family!r} family ({cfg.name}) is not ported yet "
            "(ROADMAP Queue 1, item 8); the port runs the dense family")


# =====================================================================
# init
# =====================================================================

def _dense_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> dict:
    return {
        "ln1": layers.rmsnorm_params(cfg.d_model, gen.device),
        "ln2": layers.rmsnorm_params(cfg.d_model, gen.device),
        "attn": layers.attention_params(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype),
        "mlp": layers.swiglu_params(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Random parameters from ``seed``, made on ``device`` (``cuda`` unless
    asked otherwise) by a generator there, in the JAX package's shapes and
    scales. Matrices are drawn in fp32 and stored in
    ``cfg.activation_dtype``; norm scales stay fp32. Layers are drawn one
    at a time into the stacked tensors, so a full-size model never has its
    fp32 draws all at once.
    torch's generator cannot replay ``jax.random``: carry the JAX package's
    weights over with :func:`params_from_numpy`."""
    require_dense(cfg, "init_params")
    dev = resolve_device(device)
    dtype = cfg.activation_dtype
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params: Params = {
        "embed": layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": layers.rmsnorm_params(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.embedding_params(gen, cfg.vocab, cfg.d_model, dtype)
    layer = _dense_layer_params(cfg, gen, dtype)
    stacked = tree_util.map(lambda t: t.new_empty((cfg.n_layers,) + tuple(t.shape)), layer)
    for i in range(cfg.n_layers):
        if i:
            layer = _dense_layer_params(cfg, gen, dtype)
        for dst, src in zip(tree_util.leaves(stacked), tree_util.leaves(layer)):
            dst[i] = src
    params["layers"] = stacked
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


def layer_params(params: Params, i: int) -> dict:
    """Layer ``i`` of the stacked ``params["layers"]`` (views, no copy)."""
    return tree_util.map(lambda t: t[i], params["layers"])


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out, k_rope, v) — k/v for optional cache building.
    Short or non-divisible sequences take dense attention, long ones flash
    (``attn_impl="flash"``) or chunked attention, as in the JAX package;
    the chunked path's ``causal_skip`` and the hybrid family's window
    override belong to training and that family (ROADMAP Queue 1 item 8)."""
    window = cfg.sliding_window
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


def _dense_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, _ = _self_attention(
        cfg, p["attn"], layers.rmsnorm(p["ln1"], x, cfg.norm_eps),
        causal=True, positions=positions,
    )
    x = x + h
    return x + layers.swiglu(p["mlp"], layers.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _forward_dense(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    for i in range(cfg.n_layers):
        x = _dense_block(cfg, layer_params(params, i), x)
    return x


def lm_head(cfg: ModelConfig, params: Params) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward_logits(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Last-position logits (B, V) fp32 of ``batch["tokens"]`` (B, S)."""
    require_dense(cfg, "forward_logits")
    x = layers.embed(params["embed"], batch["tokens"], cfg.activation_dtype)
    h = _forward_dense(cfg, params, x)
    h = layers.rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    return layers.unembed(lm_head(cfg, params), h)[:, 0, :]
