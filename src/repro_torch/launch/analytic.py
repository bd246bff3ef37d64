"""Analytic FLOP/byte models per (arch x shape): the port's own copy of
``repro.launch.analytic`` (plain arithmetic, the same numbers).

Closed-form compute and memory terms of a train step, a prefill and a
decode step, used to put a measured step beside its model FLOP/s.

Conventions: totals are *global*; callers divide by device count.
Backward = 2x forward; remat re-forward = +1x (every layer is recomputed
in backward under ``remat``).
"""
from __future__ import annotations

from repro_torch.launch.inputs import encdec_tgt_len
from repro_torch.models.config import InputShape, ModelConfig


def _attn_flops(b: int, s_q: int, s_kv: int, n_heads: int, hd: int,
                causal_skip: bool = False) -> float:
    """QK^T + PV for one layer, forward."""
    factor = 0.5 if causal_skip else 1.0
    return 4.0 * b * s_q * s_kv * n_heads * hd * factor


def _matmul_params(cfg: ModelConfig) -> float:
    """Active parameters that participate in matmuls (embedding lookup
    excluded; LM head included)."""
    return float(cfg.active_param_count() - cfg.vocab * cfg.d_model)


def train_flops(cfg: ModelConfig, shape: InputShape, *, causal_skip: bool = False) -> float:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        st = encdec_tgt_len(s)
        tokens_dec, tokens_enc = b * st, b * s
        # split matmul params ~ evenly by layer counts; good to ~10%.
        n_mm = _matmul_params(cfg)
        frac_enc = cfg.n_enc_layers / (cfg.n_enc_layers + 2 * cfg.n_layers)
        mm = 2.0 * (tokens_enc * n_mm * frac_enc + tokens_dec * n_mm * (1 - frac_enc))
        attn = cfg.n_enc_layers * _attn_flops(b, s, s, cfg.n_heads, cfg.hd)
        attn += cfg.n_layers * (
            _attn_flops(b, st, st, cfg.n_heads, cfg.hd, causal_skip)
            + _attn_flops(b, st, s, cfg.n_heads, cfg.hd)
        )
        fwd = mm + attn
        return 4.0 * fwd  # fwd + bwd(2x) + remat re-fwd(1x)
    tokens = b * s
    n_mm = _matmul_params(cfg)
    fwd = 2.0 * tokens * n_mm
    skv = min(s, cfg.sliding_window) if cfg.sliding_window else s
    if cfg.family in ("dense", "moe", "vlm"):
        fwd += cfg.n_layers * _attn_flops(b, s, skv, cfg.n_heads, cfg.hd, causal_skip)
    elif cfg.family == "ssm":
        n = cfg.d_model // cfg.rwkv_heads
        # chunked WKV: intra-chunk (C x C x N per head, 2 matmuls) + state IO
        c = 64
        intra = 4.0 * b * s * c * cfg.rwkv_heads * n
        inter = 4.0 * b * s * cfg.rwkv_heads * n * n / c
        fwd += cfg.n_layers * (intra + inter)
    elif cfg.family == "hybrid":
        c = min(cfg.chunk_size, 128)
        h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        intra = 2.0 * b * s * c * (n + h * p)      # CB^T + scores@x
        inter = 4.0 * b * s * h * n * p / c * c    # chunk state read/write
        fwd += cfg.n_layers * (intra + inter)
        n_attn = cfg.n_layers // cfg.attn_every
        w = cfg.sliding_window or 4096
        fwd += n_attn * _attn_flops(b, s, min(s, w), cfg.n_heads, cfg.hd, causal_skip)
    return 4.0 * fwd


def prefill_flops(cfg: ModelConfig, shape: InputShape) -> float:
    return train_flops(cfg, shape) / 4.0  # forward only


def decode_flops(cfg: ModelConfig, shape: InputShape) -> float:
    b, s = shape.global_batch, shape.seq_len
    n_mm = _matmul_params(cfg)
    fl = 2.0 * b * n_mm
    lc = cfg.effective_cache_len(s)
    if cfg.family in ("dense", "moe", "vlm"):
        fl += cfg.n_layers * 4.0 * b * lc * cfg.n_heads * cfg.hd
    elif cfg.family == "encdec":
        fl += cfg.n_layers * 4.0 * b * (lc + s) * cfg.n_heads * cfg.hd
    elif cfg.family == "ssm":
        n = cfg.d_model // cfg.rwkv_heads
        fl += cfg.n_layers * 4.0 * b * cfg.rwkv_heads * n * n
    elif cfg.family == "hybrid":
        h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        fl += cfg.n_layers * 4.0 * b * h * n * p
        w = min(cfg.sliding_window or 4096, s)
        fl += (cfg.n_layers // cfg.attn_every) * 4.0 * b * w * cfg.n_heads * cfg.hd
    return fl


def train_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    """HBM traffic, global: optimizer state dominates (fp32 master + Adam
    moments: read p,m,v + write p,m,v + grads r/w ~= 32 bytes/param) plus
    activation traffic ~6 passes of the residual stream per layer."""
    n = float(cfg.param_count())
    b, s = shape.global_batch, shape.seq_len
    st = encdec_tgt_len(s) if cfg.family == "encdec" else s
    opt = 32.0 * n
    layers = cfg.n_layers + getattr(cfg, "n_enc_layers", 0)
    acts = 6.0 * 2.0 * b * st * cfg.d_model * layers
    return opt + acts


def decode_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    """Params (bf16) + cache read/write per token."""
    n = float(cfg.param_count())
    b, s = shape.global_batch, shape.seq_len
    lc = cfg.effective_cache_len(s)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        n_par = float(cfg.active_param_count())
        cache = cfg.n_layers * 2.0 * b * lc * cfg.n_kv_heads * cfg.hd * 2.0
        if cfg.family == "encdec":
            cache += cfg.n_layers * 2.0 * b * s * cfg.n_kv_heads * cfg.hd * 2.0
    elif cfg.family == "ssm":
        nn = cfg.d_model // cfg.rwkv_heads
        cache = cfg.n_layers * b * cfg.rwkv_heads * nn * nn * 4.0 * 2.0
        n_par = n
    else:  # hybrid
        cache = cfg.n_layers * b * cfg.n_ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4.0 * 2.0
        w = min(cfg.sliding_window or 4096, s)
        cache += (1) * 2.0 * b * w * cfg.n_kv_heads * cfg.hd * 2.0
        n_par = n
    return 2.0 * n_par + cache


def analytic_record(cfg: ModelConfig, shape: InputShape, kind: str,
                    n_chips: int, *, causal_skip: bool = False,
                    dp_size: int = 16) -> dict:
    """Per-device terms. FLOPs divide by all chips (matmuls are 2D-sharded);
    parameter/optimizer traffic divides by all chips (FSDP+TP shards both
    dims); activation traffic divides by the data-parallel size only
    (activations are replicated across the model axis)."""
    if kind == "train":
        fl = train_flops(cfg, shape, causal_skip=causal_skip)
        n = float(cfg.param_count())
        opt = 32.0 * n
        by_dev = opt / n_chips + (train_bytes(cfg, shape) - opt) / dp_size
    elif kind == "prefill":
        fl = prefill_flops(cfg, shape)
        n = float(cfg.param_count())
        acts = (train_bytes(cfg, shape) - 32.0 * n) / 4.0  # fwd only, bf16
        by_dev = 2.0 * n / n_chips + acts / dp_size
    else:
        fl = decode_flops(cfg, shape)
        n_par = 2.0 * float(cfg.active_param_count())
        cache = decode_bytes(cfg, shape) - n_par
        by_dev = n_par / n_chips + cache / dp_size
    return {
        "analytic_flops_per_device": fl / n_chips,
        "analytic_bytes_per_device": by_dev,
        "model_flops_total": fl,
    }
