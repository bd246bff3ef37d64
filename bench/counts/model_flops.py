"""Parameter, operation and byte counts of a granitemoehybrid model round
(``drivers/model_round.py``), from the configuration's published keys
alone. A multiply-add is two operations; norms, activations, the conv,
softmaxes and the loss are left out.

A client's local step trains one sequence of T tokens: 3 x the forward's
operations (the forward, and a backward of twice its products). The
forward of a token reads each held matrix once:

- a Mamba-2 mixer: in_proj D x (2 Din + 2 N + H) and out_proj Din x D;
  its SSD at chunk C: C.B within a chunk (2 C N), the decayed scores on x
  (2 C H P), each chunk's state write and read (2 H N P each);
- an attention mixer: q, k, v, o (2 D Hq hd + 2 D Hkv hd), and QK^T and PV
  over every key (4 T Hq hd), the causal mask not counted off;
- every layer's MoE: the router D x E, the top-k picks' held share of the
  experts, k n / E passes of 3 D F a token, and the shared expert 3 D Fs;
- the tied unembedding D x V.
"""
from __future__ import annotations


def _kinds(cfg: dict) -> list[str]:
    return cfg["layer_types"][:cfg["num_hidden_layers"]]


def param_count(cfg: dict) -> int:
    """Every parameter the chip holds: the layers and the tied table."""
    d, n, h, p = (cfg["hidden_size"], cfg["mamba_d_state"], cfg["mamba_n_heads"],
                  cfg["mamba_d_head"])
    din = h * p
    conv_ch = din + 2 * n
    mamba = (d * (2 * din + 2 * n + h) + cfg["mamba_d_conv"] * conv_ch
             + (conv_ch if cfg["mamba_conv_bias"] else 0) + 3 * h + din + din * d)
    hd = d // cfg["num_attention_heads"]
    attn = 2 * d * cfg["num_attention_heads"] * hd + 2 * d * cfg["num_key_value_heads"] * hd
    ffn = (d * cfg["router_experts"] + cfg["num_local_experts"] * 3 * d * cfg["intermediate_size"]
           + 3 * d * cfg["shared_intermediate_size"])
    layers = sum((mamba if k == "mamba" else attn) + ffn + 2 * d for k in _kinds(cfg))
    return layers + cfg["vocab_size"] * d + d


def forward_flops(cfg: dict, seq: int) -> float:
    """Forward operations of one sequence of ``seq`` tokens."""
    d, n, h, p = (cfg["hidden_size"], cfg["mamba_d_state"], cfg["mamba_n_heads"],
                  cfg["mamba_d_head"])
    din, c = h * p, cfg["mamba_chunk_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // hq
    mamba = seq * (2 * d * (2 * din + 2 * n + h) + 2 * din * d
                   + 2 * c * n + 2 * c * h * p + 4 * h * n * p)
    attn = seq * (2 * d * hq * hd * 2 + 2 * d * hkv * hd * 2) + 4 * seq * seq * hq * hd
    passes = cfg["num_experts_per_tok"] * cfg["num_local_experts"] / cfg["router_experts"]
    ffn = seq * (2 * d * cfg["router_experts"] + passes * 6 * d * cfg["intermediate_size"]
                 + 6 * d * cfg["shared_intermediate_size"])
    layers = sum((mamba if k == "mamba" else attn) + ffn for k in _kinds(cfg))
    return layers + seq * 2 * d * cfg["vocab_size"]


def round_flops(cfg: dict, traffic: dict) -> float:
    """One round: every client's local step on its sequences."""
    seqs = traffic["clients"] * traffic["batch_per_client"]
    return seqs * 3 * forward_flops(cfg, traffic["seq_len"])


# the grouped expert products (kernels.moe_grouped) of one routed slot, in
# units of 2 D F: a client step runs the forward's 3 (gate, up, down) twice
# (the forward and its recompute under remat) and the backward's 3 (the
# down's and both input products) as moe_rows_gemm, and the backward's 3
# weight gradients as moe_wgrad_gemm
ROWS_PRODUCTS = 9
WGRAD_PRODUCTS = 3


def grouped_flops(cfg: dict, routed_slots: float, products: int) -> float:
    """Operations of ``products`` grouped products over ``routed_slots``
    (token, expert) rows, each a D x F product."""
    return products * 2.0 * routed_slots * cfg["hidden_size"] * cfg["intermediate_size"]


def grouped_bytes(cfg: dict, routed_slots: float, products: int, layers: int) -> float:
    """Bytes those products need at least: each product reads its rows (D
    or F wide) and the held experts' (D, F) matrices once, and writes its
    output once; a row on average (D + F) / 2 wide in and out."""
    d, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_local_experts"]
    per_product = 4.0 * (routed_slots * (d + f)) + 4.0 * n * d * f * layers
    return products * per_product
