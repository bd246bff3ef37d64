"""What a sequence shard takes from the shards before it: the recurrent
families' halos and state fold, over a process group or emulated in one
process.

Under sequence parallelism (``models.model``'s docstring) rank ``idx`` of
n holds positions ``[idx S_loc, (idx + 1) S_loc)``. Attention reaches the
other shards through the ring (``dist.ring``) or a gather of K and V; a
recurrence needs only what crosses each shard's left edge:

  * a **halo**: the previous shard's last rows (RWKV6's token shifts take
    one, a (B, D) row; Mamba2's causal conv K - 1 rows of its input).
    Shard 0 takes the sequence's own carry (zeros, as the unsharded layer
    starts from);
  * the **state** entering the shard. A chunked scan is a linear map of its
    start state: S_out = A ⊙ S_in + B, with A the product of the shard's
    chunk decays and B the state it reaches from zero. Each shard runs its
    scan from zero to get its pair (A_j, B_j); the pairs are gathered, and
    shard i folds the ones before it in order: S_in(i) = fold_{j<i} (A_j ⊙
    S + B_j) from the sequence's start state (:func:`fold`). The shard then
    runs its chunk-state scan again from S_in(i).

Both go through :meth:`exchange`, one all-gather of each shard's part and a
function of the gathered stack. A MoE routing group that crosses the
shards' edges (``models.moe``) takes its queue offsets and its aux sums
through :meth:`exchange` too, and sums its pieces' partials of the
group's dispatch with :meth:`sum_pieces`. Two transports run the one layer
code:

  * :class:`GroupSeq`, this rank's shard over a ``torch.distributed`` group
    (the ``seq`` axis of the active plan): the gather is an all-gather, its
    backward a reduce-scatter of the stack's gradient (each shard gets the
    sum of what the later shards' outputs sent back). The function runs
    inside one autograd node, so every rank runs the backward's collective,
    shard 0 too (whose output does not read the stack);
  * :class:`LocalSeq`, the n shards in one process: the layer splits its
    whole input, runs each shard's part in turn, and the stack is a
    ``torch.stack``. The harness that holds the halos and the fold at full
    width on one card against the unsharded layer.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.dist import collectives


class _Exchange(torch.autograd.Function):
    """``f(stack, idx)`` of the parts all-gathered over ``group``, with a
    reduce-scatter backward (module docstring)."""

    @staticmethod
    def forward(ctx, f, idx, group, axis, *parts):
        ctx.f, ctx.idx, ctx.group, ctx.axis = f, idx, group, axis
        stacks = [collectives.gather_raw(p[None], group, axis) for p in parts]
        ctx.save_for_backward(*stacks)
        return f(stacks, idx)

    @staticmethod
    def backward(ctx, g):
        stacks = [s.detach().requires_grad_(True) for s in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.f(stacks, ctx.idx)
            grads = (torch.autograd.grad(out, stacks, g, allow_unused=True) if out.requires_grad
                     else [None] * len(stacks))
        grads = [torch.zeros_like(s) if d is None else d for s, d in zip(stacks, grads)]
        return (None, None, None, None,
                *[collectives.reduce_scatter_raw(d, ctx.group, ctx.axis)[0] for d in grads])


class GroupSeq(NamedTuple):
    """This rank's part of a sequence-parallel forward: shard ``idx`` of
    ``n`` over the process group ``group``, counted on mesh axis ``axis``."""
    n: int
    idx: int
    group: object
    axis: str = "seq"

    @property
    def ranks(self) -> tuple:
        return (self.idx,)

    def split(self, x: torch.Tensor) -> list:
        return [x]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def exchange(self, parts: Sequence[tuple], f: Callable) -> list:
        """``[f(stacks, idx)]``: ``stacks`` holds, for each tensor of this
        shard's tuple ``parts[0]``, every shard's in shard order, stacked
        on a new leading dim."""
        return [_Exchange.apply(f, self.idx, self.group, self.axis, *parts[0])]

    def sum_pieces(self, parts: Sequence[dict], n_keys: int) -> list:
        """``[{key: sum}]``: for each key of this shard's ``parts[0]``
        ({key: partial}, keys in ``range(n_keys)``), the sum of every
        shard's partial of that key. One all-reduce (sum) over the group of
        the (n_keys, ...) stack, zeros for the keys the shard does not
        hold; its backward all-reduces the gradient too, since every shard
        reads the whole sum."""
        own = parts[0]
        zero = torch.zeros_like(next(iter(own.values())))
        total = collectives.sum_both(torch.stack([own.get(j, zero) for j in range(n_keys)]),
                                     self.group, self.axis)
        return [{j: total[j] for j in own}]


class LocalSeq:
    """The n shards of a sequence in one process (module docstring): the
    layer takes the whole sequence, :meth:`split` cuts it into n shards
    along dim 1 and :meth:`join` concatenates their outputs."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"LocalSeq needs n >= 1, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def split(self, x: torch.Tensor) -> list:
        if x.shape[1] % self.n:
            raise ValueError(f"LocalSeq({self.n}): sequence length {x.shape[1]} does not "
                             "divide into its shards")
        return list(torch.chunk(x, self.n, dim=1))

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)

    def exchange(self, parts: Sequence[tuple], f: Callable) -> list:
        stacks = [torch.stack(list(col)) for col in zip(*parts)]
        return [f(stacks, i) for i in self.ranks]

    def sum_pieces(self, parts: Sequence[dict], n_keys: int) -> list:
        """:meth:`GroupSeq.sum_pieces` of the n shards: each key's partials
        added in shard order, only those of the shards that hold it; the
        shards of a key share its one sum."""
        totals: dict = {}
        for own in parts:
            for j, t in own.items():
                totals[j] = t if j not in totals else totals[j] + t
        return [{j: totals[j] for j in own} for own in parts]


def fold(s0: torch.Tensor, expand: Callable) -> Callable:
    """The exchange function of a state fold from the start state ``s0``:
    ``(stacks = [A, B], idx) -> S_in(idx)``, each step ``expand(A_j) * S +
    B_j`` in shard order (``expand`` lines A up with the state's dims).
    Shard 0 gets a copy of ``s0``: an exchange's output is always a new
    tensor."""
    def run(stacks: list, idx: int) -> torch.Tensor:
        a, b = stacks
        s = s0
        for j in range(idx):
            s = expand(a[j]) * s + b[j]
        return s if idx else s0.clone()

    return run


def halo(seq, xs: Sequence[torch.Tensor], rows: int, first: torch.Tensor) -> list:
    """Each held shard's halo: the previous shard's last ``rows`` rows of
    its (B, S_loc, ...) input (one row comes back as (B, ...)); shard 0
    gets a copy of ``first``, the sequence's own carry. Every shard must
    read its halo: over a group it is an exchange's output."""
    def tail(x):
        return x[:, -1] if rows == 1 else x[:, x.shape[1] - rows:]

    def previous(stacks: list, idx: int) -> torch.Tensor:
        return first.to(stacks[0].dtype).clone() if idx == 0 else stacks[0][idx - 1]

    return seq.exchange([(tail(x),) for x in xs], previous)

