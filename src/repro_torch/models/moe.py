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
fraction. The JAX code's ``shard_act`` is an identity on one device and
has no counterpart here.

Expert parallelism (the rank holds ``e_loc`` of the E experts on an axis
of m ranks, ``model`` under the default rules): every rank routes every
token alike, and the output is the rank's partial sum, which the caller
all-reduces over ``model`` (``models.model.ffn``). :func:`expert_route`
picks the one route ``moe_apply`` takes, by the JAX package's rule, no
switch of its own:

  * **all-to-all** (:class:`GroupExchange`) where the JAX package lowers
    its dispatch to one: the active plan shards the expert axis
    (``expert_dispatch_active``) and resolves ``moe_capacity`` for the
    group's capacity C to that same axis (``shard_act(xe, "becd_cap")``,
    then ``"becd"``). Rank r builds the dispatch of its capacity slots
    ``[r C/m, (r + 1) C/m)`` of every expert, (B, E, C/m, D) (JAX's
    ``becd_cap``); an all-to-all over the axis (split E, concatenate C)
    makes it (B, E/m, C, D), the rank's experts' whole queues (JAX's
    ``becd``), bit for bit the tensor the other route builds, since each
    dispatched element is one token's value times a one-hot; the experts
    run; the reverse all-to-all gives back (B, E, C/m, D), and the combine
    of the rank's capacity columns is its partial. Two all-to-alls a
    routing group;
  * **all-reduce** (:class:`ExpertSlots`) everywhere else: the rank runs
    the dispatch slots of its own experts, whole queues, and its partial
    is their combine. That is where C does not divide the axis (decode's C
    = top_k on 16 ranks: JAX's ``becd_cap`` leaves C whole and it gathers
    y), and under a plan whose ``moe_capacity`` rule is overridden (say
    ``make_plan(mesh, overrides={"moe_capacity": (None,)})``). Where E does
    not divide the axis (Grok-1's 8 experts on 16 ranks) every rank holds
    every expert, the route is None and no expert collective runs, as in
    JAX.

The exchange is a seam with two implementations, as ``dist.ring``'s:
:class:`GroupExchange`, the counted ``dist.collectives.all_to_all`` over
the mesh axis, and :class:`LocalExchange`, the m ranks emulated in one
process (the whole parameters, each rank's experts sliced; the partials
summed in rank order), which holds the route at full width on one card.

Under a model-parallel plan the aux losses are of the global batch
(``dist.parallel.batch_mean``) and their gradient enters on one model rank
(``dist.parallel.aux_grad_gate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, parallel
from repro_torch.dist.activations import current_activation_plan, expert_dispatch_active
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
              route_chunk: int = ROUTE_CHUNK, route: "Route" = None) -> tuple[torch.Tensor, dict]:
    """Capacity-based top-k MoE of x (B, S, D). A sequence is routed in
    groups of :func:`group_length` tokens, each with its own capacity; the
    aux values are averaged over the groups. Only one group's dispatch
    tensors are alive at a time (without autograd). ``route``: the expert
    parallel route (:func:`expert_route`; None: every expert here)."""
    b, s, d = x.shape
    g = group_length(s, route_chunk)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, route=route)
    if g < s:
        outs, auxs = [], []
        for c0 in range(0, s, g):
            out, aux = _moe_apply_dense(params, x[:, c0:c0 + g], **kw)
            outs.append(out)
            auxs.append(aux)
        # concatenated, not written into slices of one buffer: under autograd
        # slice assignment would chain in-place copies
        return torch.cat(outs, dim=1), {k: torch.stack([a[k] for a in auxs]).mean()
                                        for k in auxs[0]}
    return _moe_apply_dense(params, x, **kw)


def group_length(s: int, route_chunk: int = ROUTE_CHUNK) -> int:
    """The tokens of each routing group of an S-token sequence:
    ``route_chunk`` where S is a longer multiple of it, else S."""
    return route_chunk if s > route_chunk and s % route_chunk == 0 else s


def group_capacity(s_group: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """The queue length C of every expert in a routing group of
    ``s_group`` tokens."""
    return max(int(capacity_factor * s_group * top_k / n_experts), 1)


# =====================================================================
# expert exchange (the all-to-all route)
# =====================================================================

def expert_block(params: dict, n: int, r: int) -> dict:
    """Rank r's experts of n, as its expert leaves hold them under expert
    parallelism: rows ``[r E/n, (r + 1) E/n)`` of ``wg``, ``wu``, ``wd``."""
    e_loc = params["wg"].shape[0] // n
    return dict(params, **{k: params[k][r * e_loc:(r + 1) * e_loc] for k in ("wg", "wu", "wd")})


class GroupExchange:
    """The all-to-all route over the mesh axis ``axis`` of the active
    plan: this process is its rank ``idx`` of ``n``, holding its experts'
    leaves; every exchange is ``collectives.all_to_all`` (counted)."""

    def __init__(self, axis: str, n: int, idx: int):
        self.axis, self.n, self.ranks = axis, n, (idx,)

    def experts(self, params: dict, r: int) -> dict:
        return params

    def exchange(self, xs: list, split_dim: int, concat_dim: int) -> list:
        return [collectives.all_to_all(xs[0], self.axis, split_dim=split_dim,
                                       concat_dim=concat_dim)]

    def join(self, outs: list) -> torch.Tensor:
        return outs[0]


class LocalExchange:
    """The all-to-all route's n ranks emulated in one process: the whole
    parameters, each rank's experts sliced (:func:`expert_block`); the
    exchange moves blocks between the ranks' lists, and the output is the
    ranks' partials summed in rank order."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"LocalExchange needs n >= 1, got {n}")
        self.n, self.ranks = n, tuple(range(n))

    def experts(self, params: dict, r: int) -> dict:
        return expert_block(params, self.n, r)

    def exchange(self, xs: list, split_dim: int, concat_dim: int) -> list:
        parts = [torch.chunk(x, self.n, dim=split_dim) for x in xs]
        return [torch.cat([p[j] for p in parts], dim=concat_dim) for j in self.ranks]

    def join(self, outs: list) -> torch.Tensor:
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out


@dataclasses.dataclass(frozen=True)
class ExpertSlots:
    """The all-reduce route: the rank runs the dispatch slots of its
    experts ``[lo, hi)`` of E, whole queues; its output is their combine."""
    lo: int
    hi: int


Route = Optional[Union[ExpertSlots, GroupExchange, LocalExchange]]


def expert_route(n_experts: int, e_local: int, s: int, top_k: int, capacity_factor: float,
                 route_chunk: int = ROUTE_CHUNK) -> Route:
    """The route of an S-token sequence on a rank whose expert leaves hold
    ``e_local`` of ``n_experts`` (module docstring): None where it holds
    them all; the all-to-all route's exchange where the active plan shards
    the expert axis and resolves ``moe_capacity`` for the routing groups'
    capacity to that same axis; else the rank's :class:`ExpertSlots`."""
    experts = parallel.local_experts(n_experts, e_local)
    if experts is None:
        return None
    plan = current_activation_plan()
    c = group_capacity(group_length(s, route_chunk), top_k, n_experts, capacity_factor)
    if expert_dispatch_active(n_experts):
        axis = plan.resolve(n_experts, "expert")
        if plan.resolve(c, "moe_capacity") == axis:
            return GroupExchange(axis, plan.axis_size(axis), plan.mesh.get_local_rank(axis))
    return ExpertSlots(*experts)


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
                     capacity_factor: float = 1.25, route: Route = None
                     ) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    e = params["router"].shape[-1]
    dtype = x.dtype
    logits, probs = _router(params, x)

    # --- top-k routing with renormalized gates -------------------------
    gate_vals, gate_idx = _local_top_k(probs, top_k)              # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    capacity = group_capacity(s, top_k, e, capacity_factor)

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

    # --- expert computation ---------------------------------------------
    if isinstance(route, (GroupExchange, LocalExchange)):
        out = _alltoall_route(params, x, disp_tokens, combine_tok, capacity, route)
    else:                              # the rank's experts' slots (all of them unsharded)
        lo, hi = (0, e) if route is None else (route.lo, route.hi)
        if route is not None:
            disp_tokens = disp_tokens[..., lo * capacity:hi * capacity]
            combine_tok = combine_tok[..., lo * capacity:hi * capacity]
        xe = torch.matmul(disp_tokens.to(dtype).transpose(1, 2), x).reshape(
            b, hi - lo, capacity, d)
        y = _experts(params, xe)
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


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts of ``params`` on their queues xe (B, e, C, D)."""
    dtype = xe.dtype
    g = torch.einsum("becd,edf->becf", xe, params["wg"].to(dtype))
    u = torch.einsum("becd,edf->becf", xe, params["wu"].to(dtype))
    return torch.einsum("becf,efd->becd", F.silu(g) * u, params["wd"].to(dtype))


def _alltoall_route(params: dict, x: torch.Tensor, disp_tokens: torch.Tensor,
                    combine_tok: torch.Tensor, capacity: int, ex) -> torch.Tensor:
    """The all-to-all route (module docstring) of one routing group over
    ``ex``: each rank's capacity block of every expert dispatched, moved
    to the experts' ranks, run, moved back and combined; ``ex.join`` of
    the ranks' partials (B, S, D)."""
    b, s, d = x.shape
    e, n = params["router"].shape[-1], ex.n
    if capacity % n or e % n:
        raise ValueError(f"the all-to-all route over {n} ranks needs E ({e}) and C ({capacity}) "
                         "to divide")
    cb = capacity // n

    def block(t, r):                   # rank r's capacity columns of every expert, (B, S, E C/n)
        return t.view(b, s, e, capacity)[..., r * cb:(r + 1) * cb].reshape(b, s, e * cb).to(x.dtype)

    xe_cap = [torch.matmul(block(disp_tokens, r).transpose(1, 2), x).reshape(b, e, cb, d)
              for r in ex.ranks]                                   # JAX's becd_cap
    xes = ex.exchange(xe_cap, split_dim=1, concat_dim=2)           # becd: (B, E/n, C, D)
    ys = [_experts(ex.experts(params, r), xe) for r, xe in zip(ex.ranks, xes)]
    y_cap = ex.exchange(ys, split_dim=2, concat_dim=1)             # becd_cap: (B, E, C/n, D)
    return ex.join([torch.matmul(block(combine_tok, r), y.reshape(b, e * cb, d))
                    for r, y in zip(ex.ranks, y_cap)])


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
