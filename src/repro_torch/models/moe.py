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

The dropless route (:func:`dropless_apply`, the ``hybrid_moe`` family):
the router takes the top-k of its E logits and softmaxes those k (the
published ``granitemoehybrid`` gating); every (token, slot) pair whose
expert the layer holds is computed, none dropped. The layer holds experts
``[lo, hi)`` of E (a share of an expert-parallel deployment, or all of
them) and returns their part of the result. The pairs are sorted by held
expert on the device (:func:`dropless_route`) and the experts run as
grouped products over their rows (``kernels.moe_grouped``: one launch a
product on the card, the counts never read by the host); the combine and
the backward's sums are gathers over fixed slots, so a call's numbers do
not depend on the schedule.

Under a model-parallel plan the aux losses are of the global batch
(``dist.parallel.batch_mean``) and their gradient enters on one model rank
(``dist.parallel.aux_grad_gate``).

Routing groups across sequence shards. Under sequence parallelism
(``moe_apply(..., seq=)``, a ``dist.seq`` transport) the groups are those
of the whole sequence, S = n S_loc, as the JAX package forms them before
GSPMD cuts S over ``seq``. Where each shard holds whole groups (S_loc a
multiple of the group length), each routes its own, as without ``seq``.
Elsewhere (S_loc below 512, or one group of the whole S) a group crosses
a shard's edge, and shard i (positions ``[i S_loc, (i + 1) S_loc)``) holds
a piece of each group it touches (:func:`group_pieces`). The pieces of a
group route as the unsharded group does, with no approximation
(:func:`_moe_apply_pieces`):

  * **one queue**: each shard counts its pieces' routing slots to each
    expert, (G, B, E) integers in fp32; the counts are gathered over
    ``seq`` (``seq.exchange``), and a piece's queue positions start after
    the slots of its group's pieces on the shards before it (JAX's
    cumulative sum across the shards). Positions and ``keep`` are those
    of the unsharded layer, against the whole group's capacity C;
  * **one dispatched tensor**: each shard builds its pieces' partials of
    the group's dispatch, in the route's layout (the rank's capacity
    block (B, E, C/m, D) under the all-to-all route, its experts' queues
    (B, e, C, D) under the all-reduce route, (B, E, C, D) without expert
    parallelism), and the partials are summed over the shards
    (``seq.sum_pieces``). Every element has one non-zero term, so the sum
    is exact and bit-equal to the unsharded dispatch. On a process group
    the sum is one all-reduce over ``seq`` of the (G, m', B, E', C', D)
    stack (zeros for the groups the shard does not touch) a layer, and one
    more of its gradient in the backward (every shard reads the whole
    group's expert outputs): G B E C D / m elements in the activation
    dtype under the all-to-all route of m ranks (Granite train_512 on
    2x8x2x16: 1 x 4 x 32 x 10 x 1,024 bf16, 2,621,440 B), three times a
    layer of a train step under full remat. The summed tensor then takes
    the route unchanged;
  * **the experts on every shard of the group**: the JAX package's
    ``becd`` leaves C whole on ``seq``, so each of the group's shards runs
    the group's experts (the expert FLOPs repeated on each ``seq`` rank)
    and combines only its own tokens' slots;
  * **the whole group's aux values**: each shard's sums over its pieces
    (slots to each expert, router probabilities, squared log-normalizers,
    kept slots) are summed over the shards (``seq.exchange``, (G, 2E + 2)
    fp32, differentiable: reduce-scatter backward), so ``lb_loss``'s two
    means, ``z_loss`` and ``dropped_frac`` are the group's, then averaged
    over the groups. Every shard returns the same values; the train
    forward's mean over ``seq`` (identity backward) and the sum's backward
    count their gradient once.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, parallel
from repro_torch.dist.activations import current_activation_plan, expert_dispatch_active
from repro_torch.kernels import moe_grouped
from repro_torch.models import layers
from repro_torch.obs.profile import ranged, scope


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
              route_chunk: int = ROUTE_CHUNK, route: "Route" = None,
              seq=None) -> tuple[torch.Tensor, dict]:
    """Capacity-based top-k MoE of x (B, S, D). A sequence is routed in
    groups of :func:`group_length` tokens, each with its own capacity; the
    aux values are averaged over the groups. Only one group's dispatch
    tensors are alive at a time (without autograd). ``route``: the expert
    parallel route (:func:`expert_route`; None: every expert here).
    ``seq``: the sequence shards x runs as (a ``dist.seq`` transport: the
    active shard's ``GroupSeq``, x its shard; ``LocalSeq(n)``, x the whole
    sequence; module docstring), the groups taken from the whole length:
    where each shard holds whole groups, x's own groups are those."""
    if seq is not None:
        xs = seq.split(x)
        g = group_length(seq.n * xs[0].shape[1], route_chunk)
        if xs[0].shape[1] % g:
            outs, aux = _moe_apply_pieces(params, xs, seq, g, top_k=top_k,
                                          capacity_factor=capacity_factor, route=route)
            return seq.join(outs), aux
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


class Routed(NamedTuple):
    """A group's (or a piece's) routing: fp32 logits and probabilities
    (B, S, E), the renormalized top-k gates and their experts (B, S, K),
    and the one-hot of each routing slot's expert (B, S, K, E)."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    sel: torch.Tensor


def _route(params: dict, x: torch.Tensor, top_k: int) -> Routed:
    """Top-k routing of x's tokens with renormalized gates."""
    logits, probs = _router(params, x)
    gate_vals, gate_idx = _local_top_k(probs, top_k)              # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    expert_ids = torch.arange(params["router"].shape[-1], device=x.device)
    sel = (gate_idx[..., None] == expert_ids).float()             # (B,S,K,E) one-hot
    return Routed(logits, probs, gate_vals, gate_idx, sel)


def _slots(rt: Routed, capacity: int, offset: Optional[torch.Tensor] = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each routing slot's queue position (B, S*K) and ``keep`` (B, S, K),
    and the dispatch and combine weights (B, S, E*C) of capacity C.
    ``offset`` (B, E): the slots of the same group that earlier shards send
    to each expert, added to the shard's own counts (integers, exact in
    fp32)."""
    b, s, k, e = rt.sel.shape
    pos_in_expert = _queue_positions(rt.sel.reshape(b, s * k, e))
    if offset is not None:
        pos_in_expert = pos_in_expert + torch.gather(offset, 1, rt.gate_idx.reshape(b, s * k))
    keep = pos_in_expert < capacity                                # drop overflow
    keepf = keep.float()
    slot = (rt.gate_idx.reshape(b, s * k) * capacity
            + pos_in_expert.long().clamp(max=capacity - 1)).reshape(b, s, k)
    keepf = keepf.reshape(b, s, k)
    disp_tokens = torch.zeros((b, s, e * capacity), dtype=torch.float32, device=rt.sel.device)
    disp_tokens.scatter_(-1, slot, keepf)                          # (B,S,E*C)
    combine_tok = torch.zeros_like(disp_tokens).scatter_(-1, slot, rt.gate_vals * keepf)
    return pos_in_expert, keepf, disp_tokens, combine_tok


def _is_exchange(route: Route) -> bool:
    return isinstance(route, (GroupExchange, LocalExchange))


def _expert_range(route: Route, e: int) -> tuple[int, int]:
    return (0, e) if route is None else (route.lo, route.hi)


def _cap_block(t: torch.Tensor, capacity: int, n: int, r: int, dtype: torch.dtype
               ) -> torch.Tensor:
    """Rank r's capacity columns of every expert of t (B, S, E*C): (B, S,
    E*C/n) in ``dtype``."""
    b, s = t.shape[:2]
    e, cb = t.shape[-1] // capacity, capacity // n
    return t.view(b, s, e, capacity)[..., r * cb:(r + 1) * cb].reshape(b, s, e * cb).to(dtype)


def _dispatch(x: torch.Tensor, disp_tokens: torch.Tensor, capacity: int, route: Route) -> list:
    """The dispatched tensors of x's tokens: under the all-to-all route each
    emulated rank's capacity block of every expert (B, E, C/n, D) (JAX's
    ``becd_cap``), else the rank's experts' whole queues (B, e, C, D)."""
    b, s, d = x.shape
    e = disp_tokens.shape[-1] // capacity
    if _is_exchange(route):
        n = route.n
        if capacity % n or e % n:
            raise ValueError(f"the all-to-all route over {n} ranks needs E ({e}) and C "
                             f"({capacity}) to divide")
        return [torch.matmul(_cap_block(disp_tokens, capacity, n, r, x.dtype).transpose(1, 2),
                             x).reshape(b, e, capacity // n, d) for r in route.ranks]
    lo, hi = _expert_range(route, e)
    if route is not None:
        disp_tokens = disp_tokens[..., lo * capacity:hi * capacity]
    return [torch.matmul(disp_tokens.to(x.dtype).transpose(1, 2), x).reshape(
        b, hi - lo, capacity, d)]


def _expert_outputs(params: dict, xes: list, route: Route) -> list:
    """The experts on the dispatched tensors of :func:`_dispatch`: under
    the all-to-all route moved to the experts' ranks (JAX's ``becd``: (B,
    E/n, C, D)), run, and moved back (``becd_cap``)."""
    if _is_exchange(route):
        xs = route.exchange(xes, split_dim=1, concat_dim=2)
        ys = [_experts(route.experts(params, r), xe) for r, xe in zip(route.ranks, xs)]
        return route.exchange(ys, split_dim=2, concat_dim=1)
    return [_experts(params, xes[0])]


def _combine(combine_tok: torch.Tensor, ys: list, capacity: int, route: Route,
             dtype: torch.dtype) -> torch.Tensor:
    """The combine of the tokens of ``combine_tok`` (B, S, E*C) from the
    expert outputs of :func:`_expert_outputs`; under the all-to-all route
    ``route.join`` of the ranks' partials."""
    b, s = combine_tok.shape[:2]
    e = combine_tok.shape[-1] // capacity
    if _is_exchange(route):
        cb = capacity // route.n
        return route.join([torch.matmul(_cap_block(combine_tok, capacity, route.n, r, dtype),
                                        y.reshape(b, e * cb, y.shape[-1]))
                           for r, y in zip(route.ranks, ys)])
    lo, hi = _expert_range(route, e)
    if route is not None:
        combine_tok = combine_tok[..., lo * capacity:hi * capacity]
    y = ys[0]
    return torch.matmul(combine_tok.to(dtype), y.reshape(b, (hi - lo) * capacity, y.shape[-1]))


def _moe_apply_dense(params: dict, x: torch.Tensor, *, top_k: int,
                     capacity_factor: float = 1.25, route: Route = None
                     ) -> tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    e = params["router"].shape[-1]
    rt = _route(params, x, top_k)
    capacity = group_capacity(s, top_k, e, capacity_factor)
    _pos, keepf, disp_tokens, combine_tok = _slots(rt, capacity)

    # --- expert computation ---------------------------------------------
    ys = _expert_outputs(params, _dispatch(x, disp_tokens, capacity, route), route)
    out = _combine(combine_tok, ys, capacity, route, x.dtype)

    # --- aux losses ------------------------------------------------------
    # load balance: E * sum_e (fraction of tokens to e) * (mean router prob e)
    logits, probs = parallel.aux_grad_gate(rt.logits), parallel.aux_grad_gate(rt.probs)
    frac = parallel.batch_mean(rt.sel.sum(2).mean(dim=(0, 1)))
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


# =====================================================================
# routing groups across sequence shards
# =====================================================================

def group_pieces(idx: int, s_loc: int, g: int) -> list:
    """Shard ``idx``'s pieces of the routing groups of ``g`` tokens, the
    shard holding global positions ``[idx S_loc, (idx + 1) S_loc)``: each
    group j it touches, the positions of its piece in the shard and the
    piece's first position in the group."""
    a, b = idx * s_loc, (idx + 1) * s_loc
    return [(j, slice(max(j * g, a) - a, min((j + 1) * g, b) - a), max(j * g, a) - j * g)
            for j in range(a // g, (b - 1) // g + 1)]


def _piece_route(params: dict, xp: torch.Tensor, g: int, a: int, top_k: int) -> Routed:
    """The routing of a group's piece xp (B, s, D), the group's tokens ``[a,
    a + s)``: run on xp placed at those rows of a zero (B, g, D) operand,
    the group's own shape, then cut back to the piece. A product's kernel,
    and the order of its sums, follow its shape: on an H100, Granite's
    router on 4 x 256 rows gave other last bits than the same rows of its
    4 x 512-row product in most logits, which can move a top-k pick at a
    near tie. At the group's shape the logits, picks and gates are the
    unsharded group's, bit for bit."""
    s = xp.shape[1]
    if s == g:
        return _route(params, xp, top_k)
    rt = _route(params, F.pad(xp, (0, 0, a, g - a - s)), top_k)
    return Routed(*(t[:, a:a + s] for t in rt))


def _earlier(stacks: list, idx: int) -> torch.Tensor:
    """The sum of the shards' parts before shard ``idx`` (an exchange
    function)."""
    return stacks[0][:idx].sum(0)


def _every(stacks: list, idx: int) -> torch.Tensor:
    """The sum of every shard's part (an exchange function)."""
    return stacks[0].sum(0)


def _moe_apply_pieces(params: dict, xs: list, seq, g: int, *, top_k: int,
                      capacity_factor: float, route: Route) -> tuple[list, dict]:
    """The MoE of the held shards ``xs`` of ``seq`` whose routing groups of
    ``g`` tokens cross the shards' edges (module docstring): one queue, one
    capacity, one dispatched tensor and one set of aux values per group.
    Returns each held shard's output and the aux values, alike on every
    shard."""
    b, s_loc, _d = xs[0].shape
    e = params["router"].shape[-1]
    n_groups = seq.n * s_loc // g
    capacity = group_capacity(g, top_k, e, capacity_factor)
    # each piece's routing; each shard's slots to each expert, by group and row
    held, counts = [], []
    for r, x in zip(seq.ranks, xs):
        pieces = [(j, x[:, sl], _piece_route(params, x[:, sl], g, a, top_k))
                  for j, sl, a in group_pieces(r, s_loc, g)]
        cnt = x.new_zeros((n_groups, b, e), dtype=torch.float32)
        for j, _xp, rt in pieces:
            cnt[j] = rt.sel.sum(dim=(1, 2))
        held.append(pieces)
        counts.append(cnt)
    # a piece's queue starts after the slots its group's earlier pieces hold
    offsets = seq.exchange([(c,) for c in counts], _earlier)
    slots, partials = [], []
    for pieces, off in zip(held, offsets):
        own_slots, own_parts = [], {}
        for j, xp, rt in pieces:
            _pos, keepf, disp_tokens, combine_tok = _slots(rt, capacity, off[j])
            own_parts[j] = torch.stack(_dispatch(xp, disp_tokens, capacity, route))
            own_slots.append((j, keepf, combine_tok))
        slots.append(own_slots)
        partials.append(own_parts)
    # each group's dispatched tensor: its pieces' partials summed over the
    # shards (one non-zero term an element: exact); every shard of the group
    # runs its experts (in one process: once a group)
    sums = seq.sum_pieces(partials, n_groups)
    ys, outs = {}, []
    for own_slots, own_sums in zip(slots, sums):
        parts = []
        for j, _keepf, combine_tok in own_slots:
            if j not in ys:
                ys[j] = _expert_outputs(params, list(own_sums[j].unbind(0)), route)
            parts.append(_combine(combine_tok, ys[j], capacity, route, xs[0].dtype))
        outs.append(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])
    # aux values of the whole groups, from each group's sums over its tokens
    # on every shard: slots to each expert, router probabilities, squared
    # log-normalizers, kept slots
    local = []
    for pieces, own_slots in zip(held, slots):
        rows = {}
        for (j, _xp, rt), (_j, keepf, _c) in zip(pieces, own_slots):
            logits, probs = parallel.aux_grad_gate(rt.logits), parallel.aux_grad_gate(rt.probs)
            rows[j] = torch.cat([rt.sel.sum(dim=(0, 1, 2)), probs.sum(dim=(0, 1)),
                                 (torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
                                 keepf.sum()[None]])
        zero = torch.zeros_like(next(iter(rows.values())))
        local.append(torch.stack([rows.get(j, zero) for j in range(n_groups)]))
    totals = seq.exchange([(t,) for t in local], _every)[0]        # (G, 2E + 2)
    means = parallel.batch_mean(totals / (b * g))
    frac, mean_prob = means[:, :e], means[:, e:2 * e]
    return outs, {"lb_loss": (e * torch.sum(frac / top_k * mean_prob, dim=-1)).mean(),
                  "z_loss": means[:, 2 * e].mean(),
                  "dropped_frac": (1.0 - means[:, 2 * e + 1] / top_k).mean()}


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


# =====================================================================
# the dropless route over a share of the experts
# =====================================================================

def share_params(generator: torch.Generator, d: int, f: int, n_experts: int,
                 held: tuple[int, int], n_layers: int = 1,
                 dtype: torch.dtype = torch.float32) -> dict:
    """A layer's router over all ``n_experts`` and the ``held`` = (lo, hi)
    experts' SwiGLU weights, at :func:`moe_params`' scales."""
    n = held[1] - held[0]
    return {
        "router": layers.dense_init((d, n_experts), 0.02, generator, dtype),
        "wg": layers.dense_init((n, d, f), 0.02, generator, dtype),
        "wu": layers.dense_init((n, d, f), 0.02, generator, dtype),
        "wd": layers.dense_init((n, f, d), 0.02 / max(1.0, (2 * n_layers) ** 0.5),
                                generator, dtype),
    }


class DroplessRoute(NamedTuple):
    """The routing of T tokens onto the held experts: the top-k gates (T, K)
    fp32 with 0 where the slot's expert is not held; each sorted row's slot
    (t k + j) and token t (R,); the rows' offsets by held expert ``seg``
    (n + 1,); each slot's sorted row ``pos`` (T, K), R (a zero row) where
    its expert is not held; the held experts' loads (n,)."""
    gates: torch.Tensor
    slots: torch.Tensor
    rows: torch.Tensor
    seg: torch.Tensor
    pos: torch.Tensor
    loads: torch.Tensor


def dropless_route(router: torch.Tensor, x: torch.Tensor, top_k: int,
                   held: tuple[int, int]) -> DroplessRoute:
    """Route x (T, D): fp32 logits of x's operands, the top-k logits
    softmaxed, the held experts' slots sorted by expert (stable: token
    order within an expert). R = T min(k, n) rows hold every held slot
    whatever the loads; rows past the last held slot are never read."""
    lo, hi = held
    n = hi - lo
    t = x.shape[0]
    logits = torch.matmul(x.float(), router.to(x.dtype).float())
    vals, idx = torch.topk(logits, top_k, dim=-1)
    gates = layers._softmax(vals)
    mine = (idx >= lo) & (idx < hi)
    key = torch.where(mine, idx - lo, n).reshape(-1)
    order = torch.sort(key, stable=True).indices
    loads = (key[:, None] == torch.arange(n, device=x.device)).sum(0)
    seg = F.pad(torch.cumsum(loads, 0), (1, 0))
    r = t * min(top_k, n)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                  device=x.device))
    pos = torch.where(mine, inv.view(t, top_k), r)
    slots = order[:r]
    return DroplessRoute(gates * mine, slots, torch.div(slots, top_k, rounding_mode="floor"),
                         seg, pos, loads)


class _GroupedSwiGLU(torch.autograd.Function):
    """The held experts' SwiGLU over their sorted rows and the combine,
    ``out[t] = sum_k gates[t, k] y[pos[t, k]]`` (fp32). Backward: the
    combine's gather read backwards through ``slots`` (each sorted row is
    one slot), the products' transposes and weight gradients as grouped
    products, and x's gradient as the gather-sum of its slots' rows."""

    @staticmethod
    def forward(ctx, x, gates, wg, wu, wd, slots, rows, seg, pos):
        r = rows.shape[0]
        f, d = wg.shape[2], x.shape[1]
        dev = x.device
        g = moe_grouped.rows_gemm(x, rows, wg, seg, torch.empty((r, f), device=dev))
        u = moe_grouped.rows_gemm(x, rows, wu, seg, torch.empty((r, f), device=dev))
        h = F.silu(g) * u
        y = torch.empty((r + 1, d), device=dev)
        y[r].zero_()
        moe_grouped.rows_gemm(h, None, wd, seg, y)
        out = (gates[..., None] * y[pos]).sum(1)
        ctx.save_for_backward(x, gates, wg, wu, wd, slots, rows, seg, pos, g, u, h, y)
        return out

    @staticmethod
    def backward(ctx, dout):
        with scope("moe_experts"):
            x, gates, wg, wu, wd, slots, rows, seg, pos, g, u, h, y = ctx.saved_tensors
            r, d = rows.shape[0], x.shape[1]
            dev = x.device
            dout = dout.float()
            dgates = (dout[:, None, :] * y[pos]).sum(-1)
            # each sorted row is one slot: its gate times its token's gradient
            # (0 past the held slots, whose gates are 0)
            dy = gates.reshape(-1)[slots][:, None] * dout[rows]
            dwd = moe_grouped.wgrad_gemm(h, None, dy, seg)
            dh = moe_grouped.rows_gemm(dy, None, wd, seg, torch.empty_like(g),
                                       transpose_b=True)
            sg = torch.sigmoid(g)
            du = dh * (g * sg)
            dg = dh * u * (sg * (1 + g * (1 - sg)))
            dwg = moe_grouped.wgrad_gemm(x, rows, dg, seg)
            dwu = moe_grouped.wgrad_gemm(x, rows, du, seg)
            dxs = torch.empty((r + 1, d), device=dev)
            dxs[r].zero_()
            moe_grouped.rows_gemm(dg, None, wg, seg, dxs, transpose_b=True)
            moe_grouped.rows_gemm(du, None, wu, seg, dxs, transpose_b=True, accumulate=True)
            dx = dxs[pos].sum(1)
        return dx, dgates, dwg, dwu, dwd, None, None, None, None


def dropless_apply(params: dict, x: torch.Tensor, *, top_k: int, held: tuple[int, int]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the dropless top-k MoE of x (B, S, D), in
    x's dtype, and the held experts' loads (n,) (routed slots, fp32)."""
    b, s, d = x.shape
    xr = x.reshape(b * s, d)
    rt = ranged("moe_route", lambda z: dropless_route(params["router"], z, top_k, held), xr)
    with scope("moe_experts"):
        out = _GroupedSwiGLU.apply(xr.float(), rt.gates, params["wg"].float(),
                                   params["wu"].float(), params["wd"].float(), rt.slots, rt.rows,
                                   rt.seg, rt.pos)
    return out.reshape(b, s, d).to(x.dtype), rt.loads.float()
