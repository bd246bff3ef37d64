"""Mixture-of-Experts layer in torch (Grok-1 8 experts top-2, Granite 32 top-8).

The port of ``repro.models.moe``: GShard/Switch capacity-based dispatch
with static shapes. Each token's router picks its top-k experts; a
(token, slot) pair takes the next free position of its expert's queue, in
(s, k) order, and is dropped when the queue holds ``capacity`` pairs. The
dispatch and combine are products with a one-hot (token, expert, position)
tensor; the experts run as batched matmuls over their queues. The expert
products stay ``torch.einsum`` (the JAX package leaves them to XLA too).

Where the JAX code builds the (B, S*K, E, C) one-hot of every routing slot
and sums it over the K slots, this module scatters each token's K slots
into (B, S, E*C) directly: top-k picks distinct experts, so a (token,
expert) pair holds at most one slot and the JAX sum adds one value to
zeros. The numbers are the same; the (B, S*K, E, C) temporary (~84 M fp32
values per 512-token chunk of Granite at B = 4) is never made. A position
past capacity is clamped and zeroed by ``keep`` (``jax.nn.one_hot`` of an
out-of-range position is a zero row; ``torch.nn.functional.one_hot``
would raise). The one-hots are comparisons: ``one_hot`` checks its
indices' range on the host, a device sync in every layer of a decode step.

The router's logits are fp32 products of the activation-dtype operands
(``preferred_element_type=float32`` in JAX): bf16 operands widen to fp32
first, which is exact, so top-k sees the reference's logits.

Aux losses: load balance (Switch eq. 4), router z-loss and the dropped
fraction. The JAX code's ``shard_act`` and ``expert_dispatch_active`` are
identities on one device and have no counterpart here.

Expert parallelism (``experts=(lo, hi)``, the rank's experts under a
``model`` axis): every rank routes every token alike and runs the dispatch
slots of its experts only; the output is the rank's partial sum, which the
caller all-reduces over ``model`` (the JAX package moves the dispatched
tokens with an all-to-all; here they are already on every rank). Under a
model-parallel plan the aux losses are of the global batch
(``dist.parallel.batch_mean``) and their gradient enters on one model rank
(``dist.parallel.aux_grad_gate``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import parallel
from repro_torch.models import layers


ROUTE_CHUNK = 512   # tokens a routing group holds, each with its own capacity


def moe_params(generator: torch.Generator, d: int, f: int, n_experts: int, n_layers: int = 1,
               dtype: torch.dtype = torch.float32) -> dict:
    return {
        "router": layers.dense_init((d, n_experts), 0.02, generator, dtype),
        "wg": layers.dense_init((n_experts, d, f), 0.02, generator, dtype),
        "wu": layers.dense_init((n_experts, d, f), 0.02, generator, dtype),
        "wd": layers.dense_init((n_experts, f, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5),
                                generator, dtype),
    }


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              route_chunk: int = ROUTE_CHUNK, experts: Optional[tuple] = None
              ) -> tuple[torch.Tensor, dict]:
    """Capacity-based top-k MoE of x (B, S, D). A sequence longer than
    ``route_chunk`` and a multiple of it is routed chunk by chunk, each
    chunk with its own capacity; the aux values are averaged over the
    chunks. Only one chunk's dispatch tensors are alive at a time (without
autograd)."""
    b, s, d = x.shape
    if s > route_chunk and s % route_chunk == 0:
        outs, auxs = [], []
        for c0 in range(0, s, route_chunk):
            out, aux = _moe_apply_dense(
                params, x[:, c0:c0 + route_chunk], top_k=top_k, capacity_factor=capacity_factor,
                experts=experts)
            outs.append(out)
            auxs.append(aux)
        # concatenated, not written into slices of one buffer: under autograd
        # slice assignment would chain in-place copies
        return torch.cat(outs, dim=1), {k: torch.stack([a[k] for a in auxs]).mean()
                                        for k in auxs[0]}
    return _moe_apply_dense(params, x, top_k=top_k, capacity_factor=capacity_factor,
                            experts=experts)


def _local_top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim as k argmax-and-mask passes, as the JAX
    package computes it. ``torch.argmax`` returns the first maximal index
    on the CPU and on the card, so equal values surface in index order, as
    in ``lax.top_k``."""
    idxs = []
    x = probs
    for _ in range(k):
        i = torch.argmax(x, dim=-1)
        idxs.append(i)
        x = x.scatter(-1, i[..., None], float("-inf"))
    gate_idx = torch.stack(idxs, dim=-1)                           # (B,S,K)
    return torch.gather(probs, -1, gate_idx), gate_idx


def _router(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 router logits and probabilities (B, S, E) of x's dtype operands."""
    logits = torch.matmul(x.float(), params["router"].to(x.dtype).float())
    return logits, layers._softmax(logits)


def _queue_positions(flat_sel: torch.Tensor) -> torch.Tensor:
    """Position of each routing slot in its expert's queue, by (s, k) order:
    the count of earlier slots sent to the same expert. flat_sel: (B, S*K, E)
    one-hot -> (B, S*K) fp32. The counts run along the last dim of an
    expert-major copy: torch's scan along dim 1 is its slow path on the
    card. Integer sums in fp32 are exact in any order."""
    sel_e = flat_sel.transpose(1, 2).contiguous()                  # (B,E,S*K)
    return ((torch.cumsum(sel_e, dim=-1) - sel_e) * sel_e).sum(1)


def _moe_apply_dense(params: dict, x: torch.Tensor, *, top_k: int,
                     capacity_factor: float = 1.25,
                     experts: Optional[tuple] = None) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    e = params["router"].shape[-1]
    dtype = x.dtype
    logits, probs = _router(params, x)

    # --- top-k routing with renormalized gates -------------------------
    gate_vals, gate_idx = _local_top_k(probs, top_k)              # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(capacity_factor * s * top_k / e), 1)

    expert_ids = torch.arange(e, device=x.device)
    sel = (gate_idx[..., None] == expert_ids).float()                 # (B,S,K,E) one-hot
    pos_in_expert = _queue_positions(sel.reshape(b, s * top_k, e))
    keep = pos_in_expert < capacity                                # drop overflow
    keepf = keep.float()
    slot = (gate_idx.reshape(b, s * top_k) * capacity
            + pos_in_expert.long().clamp(max=capacity - 1)).reshape(b, s, top_k)
    keepf = keepf.reshape(b, s, top_k)
    disp_tokens = torch.zeros((b, s, e * capacity), dtype=torch.float32, device=x.device)
    disp_tokens.scatter_(-1, slot, keepf)                          # (B,S,E*C)
    combine_tok = torch.zeros_like(disp_tokens).scatter_(-1, slot, gate_vals * keepf)

    # --- expert computation (the rank's experts' slots) -----------------
    lo, hi = (0, e) if experts is None else experts
    if experts is not None:
        disp_tokens = disp_tokens[..., lo * capacity:hi * capacity]
        combine_tok = combine_tok[..., lo * capacity:hi * capacity]
    xe = torch.matmul(disp_tokens.to(dtype).transpose(1, 2), x).reshape(b, hi - lo, capacity, d)
    g = torch.einsum("becd,edf->becf", xe, params["wg"].to(dtype))
    u = torch.einsum("becd,edf->becf", xe, params["wu"].to(dtype))
    y = torch.einsum("becf,efd->becd", F.silu(g) * u, params["wd"].to(dtype))
    out = torch.matmul(combine_tok.to(dtype), y.reshape(b, (hi - lo) * capacity, d))

    # --- aux losses ------------------------------------------------------
    # load balance: E * sum_e (fraction of tokens to e) * (mean router prob e)
    logits, probs = parallel.aux_grad_gate(logits), parallel.aux_grad_gate(probs)
    frac = parallel.batch_mean(sel.sum(2).mean(dim=(0, 1)))
    mean_prob = parallel.batch_mean(probs.mean(dim=(0, 1)))
    lb_loss = e * torch.sum(frac / top_k * mean_prob)
    z_loss = parallel.batch_mean(torch.mean(torch.logsumexp(logits, dim=-1) ** 2))
    dropped = 1.0 - parallel.batch_mean(keepf.mean())
    return out, {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}


def moe_apply_dense_fallback(params: dict, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Oracle: every expert on every token, combined with the top-k gates.
    E / top_k times the expert FLOPs; equal to the dispatch path when
    capacity is unbounded. Its top-k is a stable descending sort (equal
    values in index order, as ``lax.top_k``), independent of
    :func:`_local_top_k`."""
    dtype = x.dtype
    _, probs = _router(params, x)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros_like(probs).scatter(-1, gate_idx, gate_vals)
    g = torch.einsum("bsd,edf->bsef", x, params["wg"].to(dtype))
    u = torch.einsum("bsd,edf->bsef", x, params["wu"].to(dtype))
    y = torch.einsum("bsef,efd->bsed", F.silu(g) * u, params["wd"].to(dtype))
    return torch.einsum("bse,bsed->bsd", gates.to(dtype), y)
