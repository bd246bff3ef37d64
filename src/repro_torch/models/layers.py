"""Shared transformer layers in torch: norms, RoPE, GQA attention, SwiGLU.

The port of ``repro.models.layers``, with its conventions and layouts:

  * params are plain nested dicts of tensors; ``wq`` is (d, H, hd),
    ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d);
  * the forward casts matrices to the activation dtype at use (a no-op for
    matrices a caller already holds in that dtype) and keeps softmax and
    normalization sums in fp32. Where the JAX code asks for fp32 results
    of bf16 operands (``preferred_element_type=float32``) the operands are
    widened to fp32 first, which is exact;
  * attention comes in four flavours: ``dense_attention`` (full S x T
    scores), ``chunked_attention`` (online softmax over KV chunks),
    ``flash_attention`` (the blockwise kernel of
    ``repro_torch.kernels.flash_attention``) and ``decode_attention`` (one
    query against a ring-buffer KV cache). ``q_offset`` places the
    queries at global positions against the keys of a whole sequence (a
    sequence shard's queries against K and V gathered over ``seq``);
    ``head_map`` gives each query head's K/V head where it is not ``h //
    (H // KV)`` (a tensor-parallel rank's heads over whole K/V).

The JAX code's ``shard_act`` annotations have no counterpart: the port's
sequence and model parallelism is explicit per-rank code
(``models.model``, ``dist.parallel``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.flash_attention import NEG_INF, kv_block_range

# ----------------------------------------------------------------- init

_TRUNC_LO = math.erf(-2.0 / math.sqrt(2.0))
_TRUNC_HI = math.erf(2.0 / math.sqrt(2.0))


def dense_init(shape: tuple[int, ...], scale: float, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2] (inverse-CDF
    sampling, as ``jax.random.truncated_normal`` does), drawn in fp32 on the
    generator's device and stored in ``dtype``. torch's generator cannot
    replay ``jax.random``, so the numbers differ from the JAX package's.
    A stand-in generator on the ``meta`` device gives storage-less tensors
    (``model.abstract_params``)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    u = torch.rand(shape, generator=generator, device=generator.device)
    x = math.sqrt(2.0) * torch.erfinv(_TRUNC_LO + u * (_TRUNC_HI - _TRUNC_LO))
    return (scale * x.clamp_(-2.0, 2.0)).to(dtype)


def embed_init(shape: tuple[int, ...], generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return dense_init(shape, 1.0 / (shape[-1] ** 0.5), generator, dtype)


# ----------------------------------------------------------------- norms

def rmsnorm_params(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def layernorm_params(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(x.dtype)


# ----------------------------------------------------------------- RoPE

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    # true fp32 divisions by tensors: torch may multiply by the reciprocal
    # of a Python scalar divisor
    f32 = dict(dtype=torch.float32, device=device)
    exps = torch.arange(0, hd, 2, **f32) / torch.tensor(float(hd), **f32)
    return torch.ones((), **f32) / torch.pow(torch.tensor(theta, **f32), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T). The head
    splits in halves (not interleaved pairs), as in the JAX package."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention_params(generator: torch.Generator, d: int, n_heads: int, n_kv: int, hd: int,
                     dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wq": dense_init((d, n_heads, hd), 0.02, generator, dtype),
        "wk": dense_init((d, n_kv, hd), 0.02, generator, dtype),
        "wv": dense_init((d, n_kv, hd), 0.02, generator, dtype),
        "wo": dense_init((n_heads, hd, d), 0.02, generator, dtype),
    }


def _expand_kv(k: torch.Tensor, n_heads: int,
               head_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV head G times,
    or by ``head_map`` (H,), each query head's K/V head."""
    if head_map is not None:
        return k.index_select(2, head_map)
    g = n_heads // k.shape[2]
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=2)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max) divided (not multiplied by the
    reciprocal) by its sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0,
    q_positions: Optional[torch.Tensor] = None,
    k_positions: Optional[torch.Tensor] = None,
    q_offset: int = 0, head_map: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-materialization attention. q: (B,S,H,hd), k/v: (B,T,KV,hd);
    query i at ``q_offset + i`` unless ``q_positions`` says otherwise;
    scores times ``scale`` (default 1/sqrt(hd))."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    t = k.shape[1]
    k = _expand_kv(k, h, head_map)
    v = _expand_kv(v, h, head_map)
    scale = hd ** -0.5 if scale is None else scale
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    qp = (q_positions if q_positions is not None
          else torch.arange(q_offset, q_offset + s, device=q.device))
    kp = k_positions if k_positions is not None else torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = _softmax(scores).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    chunk: int, causal: bool = True, window: int = 0,
    causal_skip: bool = False, q_offset: int = 0,
    head_map: Optional[torch.Tensor] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, O(S * chunk) live memory;
    scores times ``scale`` (default 1/sqrt(hd)).

    ``causal_skip`` visits each query chunk's ``kv_block_range`` only;
    without it every chunk scans all KV chunks (masked ones included), as
    the JAX package's rectangular baseline does. K/V stay in their KV heads
    and each chunk is expanded to H heads at its step. The T keys must
    divide into chunks; the S queries (at ``q_offset + i``) go in blocks
    of ``chunk``, or of ``gcd(S, chunk)`` where S does not divide (each
    query row's sums are the same in any block).
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    if t % chunk:
        raise ValueError(f"chunked_attention: T={t} is not a multiple of chunk={chunk}")
    nk = t // chunk
    qc = chunk if s % chunk == 0 else math.gcd(s, chunk)
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    outs = []
    for qi in range(s // qc):
        if causal_skip and (causal or window):
            lo, hi = kv_block_range(qi, block_q=qc, block_k=chunk, nk=nk,
                                    causal=causal, window=window, q_offset=q_offset)
        else:
            lo, hi = 0, nk
        q_blk = q[:, qi * qc:(qi + 1) * qc].float()
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, h, qc), NEG_INF, device=dev)
        l = torch.zeros((b, h, qc), device=dev)
        acc = torch.zeros((b, h, qc, hd), device=dev)
        for kj in range(lo, hi):
            k_blk = _expand_kv(k[:, kj * chunk:(kj + 1) * chunk], h, head_map).float()
            v_blk = _expand_kv(v[:, kj * chunk:(kj + 1) * chunk], h, head_map).float()
            k_pos = kj * chunk + torch.arange(chunk, device=dev)
            sc = torch.einsum("bshd,bthd->bhst", q_blk, k_blk) * scale
            mask = torch.ones((qc, chunk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            sc = torch.where(mask[None, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, v_blk)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))                  # (b, chunk, h, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
) -> torch.Tensor:
    """Blockwise flash attention (``repro_torch.kernels.flash_attention``):
    the CUDA kernel for tensors on the card, its plain version on the CPU.
    Never builds an (S x T) score tensor and never expands K/V to H heads."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(
    q: torch.Tensor,               # (B, 1, H, hd) — already RoPE'd at abs position
    k_cache: torch.Tensor,         # (B, Lc, KV, hd) — RoPE'd at write time
    v_cache: torch.Tensor,         # (B, Lc, KV, hd)
    slot_positions: torch.Tensor,  # (Lc,) absolute positions, -1 = empty
) -> torch.Tensor:
    h, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k_cache, h)
    v = _expand_kv(v_cache, h)
    scores = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * hd ** -0.5
    valid = slot_positions >= 0
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = _softmax(scores).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", probs, v)


# ----------------------------------------------------------------- MLP

def swiglu_params(generator: torch.Generator, d: int, f: int, n_layers: int = 1,
                  dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wg": dense_init((d, f), 0.02, generator, dtype),
        "wu": dense_init((d, f), 0.02, generator, dtype),
        "wd": dense_init((f, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5), generator, dtype),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Stays in the activation dtype throughout, as the JAX code does."""
    dtype = x.dtype
    g = torch.matmul(x, params["wg"].to(dtype))
    u = torch.matmul(x, params["wu"].to(dtype))
    return torch.matmul(F.silu(g) * u, params["wd"].to(dtype))


# ----------------------------------------------------------------- embedding

def embedding_params(generator: torch.Generator, vocab: int, d: int,
                     dtype: torch.dtype = torch.float32) -> dict:
    return {"table": embed_init((vocab, d), generator, dtype)}


def embed(params: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same numbers as casting the whole table first
    return params["table"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 for a stable softmax-cross-entropy: the table is
    rounded to the activation dtype, then both operands widen to fp32."""
    return torch.matmul(x.float(), params["table"].to(x.dtype).float().T)
