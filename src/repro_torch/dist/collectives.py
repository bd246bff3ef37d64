"""Every collective the port issues, over a named axis of the active mesh,
and their accounting (the port's counterpart of the collectives GSPMD
inserts and of the HLO accounting in the JAX package's
``dist/hlo_analysis.py``).

The model-parallel forward is explicit per-rank code on local tensors
(``dist.parallel``); these are its collectives, differentiable where the
forward needs a backward:

  * :func:`gather_fsdp`: all-gather of a leaf's FSDP-sharded dim over the
    data axes; its backward is a reduce-scatter (sum), FSDP's gradient.
    Over ``seq`` it gathers a sequence shard's K and V;
    Over ``model`` it gathers a tensor whose parts the ranks then use
    differently (the Mamba2 in-projection's output): each rank's gradient
    of the whole is a partial, and the reduce-scatter sums them;
  * :func:`gather_model`: all-gather over ``model`` of a leaf every model
    rank then uses whole (the vocab tables, ``vis_proj``): every rank's
    gradient of the whole is the same, so the backward keeps the rank's
    own slice;
  * :func:`copy_to`/:func:`copy_to_model`: the identity, with an
    all-reduce (sum) backward (Megatron's *f*; over the data axes, the
    gradient of a leaf the data ranks hold whole);
  * :func:`reduce_over`/:func:`reduce_from_model`: an all-reduce (sum),
    with an identity backward (Megatron's *g*);
  * :func:`sum_over_model`: an all-reduce (sum) over ``model`` both ways,
    for a sum of rank partials whose downstream is rank-local (the gated
    RMSNorm's sum of squares); :func:`sum_both` the same over an explicit
    group (a MoE routing group's dispatch summed over its ``seq`` shards);
  * :func:`all_to_all`: block j of ``split_dim`` to group rank j, the
    received blocks concatenated along ``concat_dim`` in group-rank order;
    its backward is the reverse all-to-all (the MoE's expert dispatch and
    combine, ``models.moe``);
  * :func:`all_gather_clients`: a plain all-gather over the client axis
    (the federated uplink), no gradient;
  * :func:`gather_raw` and :func:`reduce_scatter_raw`, the two raw ops
    over an explicit process group, for ``dist.seq``'s halo and state
    exchange;
  * :func:`all_reduce`, :func:`all_gather`, :func:`broadcast` and
    :func:`send_recv` over an explicit process group, for the ring
    (``dist.ring.GroupRing``), the sequence-parallel prefill and the
    client-sharded fleet.

Every buffer a collective writes into comes from :func:`recv_buffer`
(zeros under torch's fake process group, which moves no data). Each call
records into every open :class:`CollectiveCounter`: the kind
(``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
``broadcast``, ``send/recv``), the mesh axis, the dtype, the bytes and the
group size. Bytes follow ``hlo_analysis._result_bytes``: the op's *result*
bytes (an all-gather's gathered tensor, a reduce-scatter's shard, an
all-reduce's whole tensor, an all-to-all's concatenated blocks, a
broadcast's tensor, a receive's buffer). The counters are
process-wide, not thread-local: on the card autograd runs a backward on
its own device thread, and the backward's reduce-scatters and
all-reduces must be counted too.

A group of one rank, or no active plan, makes every function the identity
on its input without calling ``torch.distributed``: a world of one is
bit-equal to the unsharded code.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.activations import current_activation_plan

@dataclasses.dataclass(frozen=True)
class Record:
    """One collective: its kind, mesh axis, dtype, result bytes, group size
    and a caller's tag (the uplink's ``"uplink"``, say)."""
    kind: str
    axis: str
    dtype: str
    bytes: int
    group_size: int
    tag: str = ""


_LOCK = threading.Lock()
_OPEN: list = []


class CollectiveCounter:
    """Records every collective issued while it is open (``with
    CollectiveCounter() as c:``), from any thread, in issue order
    (``c.log``)."""

    def __init__(self):
        self.log: list[Record] = []

    def __enter__(self) -> "CollectiveCounter":
        with _LOCK:
            _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _LOCK:
            _OPEN.remove(self)

    def totals(self, tag: Optional[str] = None) -> dict:
        """``{axis: {kind: {"count": n, "bytes": b}}}``, of the records
        with ``tag`` when one is given."""
        out: dict = collections.defaultdict(dict)
        for r in self.log:
            if tag is not None and r.tag != tag:
                continue
            slot = out[r.axis].setdefault(r.kind, {"count": 0, "bytes": 0})
            slot["count"] += 1
            slot["bytes"] += r.bytes
        return {a: dict(k) for a, k in out.items()}

    def bytes(self, axis: Optional[str] = None, kind: Optional[str] = None,
              tag: Optional[str] = None) -> int:
        return sum(r.bytes for r in self.log
                   if (axis is None or r.axis == axis) and (kind is None or r.kind == kind)
                   and (tag is None or r.tag == tag))

    def signature(self) -> list:
        """The log as plain tuples: what every rank must issue alike."""
        return [dataclasses.astuple(r) for r in self.log]


def _record(kind: str, axis: str, result: torch.Tensor, group_size: int, tag: str = "") -> None:
    rec = Record(kind, axis, str(result.dtype).removeprefix("torch."),
                 result.numel() * result.element_size(), group_size, tag)
    with _LOCK:
        for c in _OPEN:
            c.log.append(rec)


# ------------------------------------------------------------ raw ops

def recv_buffer(like: torch.Tensor, shape, group) -> torch.Tensor:
    """The buffer a collective over ``group`` writes into, of ``like``'s
    dtype and device: uninitialized, or zeros under torch's fake process
    group, which moves no data (a dry run's rank then reads zeros for the
    other ranks' parts, not whatever memory the allocator handed back)."""
    if dist.get_backend(group) == "fake":
        return like.new_zeros(shape)
    return like.new_empty(shape)


def _ag(x: torch.Tensor, group, axis: str, dim: int, tag: str = "") -> torch.Tensor:
    """All-gather x's blocks along ``dim`` in group-rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = recv_buffer(x, (n * x.shape[0],) + tuple(x.shape[1:]), group)
    with warnings.catch_warnings():   # deprecated in some torch versions, in all of them
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    if dim != 0:
        out = torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)
    _record("all-gather", axis, out, n, tag)
    return out


def _rs(g: torch.Tensor, group, axis: str, dim: int) -> torch.Tensor:
    """Reduce-scatter (sum) of g along ``dim``: the rank's block of the sum."""
    n = dist.get_world_size(group)
    parts = torch.stack(torch.chunk(g, n, dim=dim))
    out = recv_buffer(g, parts.shape[1:], group)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, parts.reshape((-1,) + tuple(out.shape[1:])), group=group)
    _record("reduce-scatter", axis, out, n)
    return out


def _ar(x: torch.Tensor, group, axis: str, op=dist.ReduceOp.SUM, tag: str = "") -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _record("all-reduce", axis, out, dist.get_world_size(group), tag)
    return out


def _a2a(x: torch.Tensor, group, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Block j of x along ``split_dim`` to group rank j; the blocks
    received, concatenated along ``concat_dim`` in group-rank order."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not divide "
                         f"into {n} blocks")
    send = torch.stack(torch.chunk(x, n, dim=split_dim))
    recv = recv_buffer(send, send.shape, group)
    dist.all_to_all_single(recv, send, group=group)
    out = torch.cat(recv.unbind(0), dim=concat_dim)
    _record("all-to-all", axis, out, n)
    return out


def _own_block(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return torch.chunk(g, n, dim=dim)[r].contiguous()


# ------------------------------------------------------ plan axes

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(plan, axes) -> tuple:
    """The axes of ``axes`` with more than one rank (none without a plan)."""
    if plan is None:
        return ()
    return tuple(a for a in _axes(axes) if plan.axis_size(a) > 1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, dim, backward):
        ctx.group, ctx.axis, ctx.dim, ctx.backward = group, axis, dim, backward
        return _ag(x, group, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "reduce-scatter":
            return _rs(g, ctx.group, ctx.axis, ctx.dim), None, None, None, None
        return _own_block(g, ctx.group, ctx.dim), None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group, ctx.axis), None, None


class _ReduceOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return _ar(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _ar(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, split_dim, concat_dim):
        ctx.group, ctx.axis, ctx.split_dim, ctx.concat_dim = group, axis, split_dim, concat_dim
        return _a2a(x, group, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.axis, ctx.concat_dim, ctx.split_dim), None, None, None, None


def gather_fsdp(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """All-gather of ``dim`` over the FSDP ``axes`` (major to minor, as a
    spec entry names them): the minor axis first, so the blocks land in
    ``plan.local_slice`` order. Backward: reduce-scatter (sum) of the
    gradient, the major axis first."""
    plan = current_activation_plan()
    for a in reversed(_live(plan, axes)):
        x = _Gather.apply(x, plan.mesh.get_group(a), a, dim, "reduce-scatter")
    return x


def gather_raw(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """All-gather of dim 0 over ``group``, no gradient."""
    return _ag(x, group, axis, 0)


def reduce_scatter_raw(g: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Reduce-scatter (sum) of dim 0 over ``group``: the rank's block, no
    gradient."""
    return _rs(g, group, axis, 0)


def gather_replicated(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """All-gather of ``dim`` over ``axis`` for a leaf every rank of the axis
    uses whole on the same inputs; the backward keeps the rank's block of
    the (rank-identical) gradient, with no collective."""
    plan = current_activation_plan()
    if not _live(plan, axis):
        return x
    return _Gather.apply(x, plan.mesh.get_group(axis), axis, dim, "slice")


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`gather_replicated` over ``model``: the vocab tables."""
    return gather_replicated(x, "model", dim)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over ``model``, and all-reduce of the gradient in
    backward: each rank's partial gradient of the sum is summed."""
    plan = current_activation_plan()
    if not _live(plan, "model"):
        return x
    return _ReduceBoth.apply(x, plan.mesh.get_group("model"), "model")


def sum_both(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """All-reduce (sum) of x over ``group``, and of the gradient in
    backward: a sum of partials that every rank then reads whole (a MoE
    routing group's dispatch over its ``seq`` shards)."""
    if dist.get_world_size(group) == 1:
        return x
    return _ReduceBoth.apply(x, group, axis)


def copy_to(x: torch.Tensor, axes) -> torch.Tensor:
    """The identity; backward all-reduces (sums) the gradient over ``axes``."""
    plan = current_activation_plan()
    for a in _live(plan, axes):
        x = _CopyTo.apply(x, plan.mesh.get_group(a), a)
    return x


def reduce_over(x: torch.Tensor, axes) -> torch.Tensor:
    """All-reduce (sum) over ``axes``; the backward is the identity."""
    plan = current_activation_plan()
    for a in _live(plan, axes):
        x = _ReduceOver.apply(x, plan.mesh.get_group(a), a)
    return x


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: the identity, all-reduce over ``model`` in backward."""
    return copy_to(x, ("model",))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g*: all-reduce over ``model``, the identity in backward."""
    return reduce_over(x, ("model",))


def all_to_all(x: torch.Tensor, axis: str, *, split_dim: int, concat_dim: int) -> torch.Tensor:
    """All-to-all over ``axis``: block j of ``split_dim`` goes to rank j of
    the axis, and the blocks received are concatenated along ``concat_dim``
    in rank order. Backward: the reverse all-to-all (the two dims
    swapped)."""
    plan = current_activation_plan()
    if not _live(plan, axis):
        return x
    return _AllToAll.apply(x, plan.mesh.get_group(axis), axis, split_dim, concat_dim)


@torch.no_grad()
def all_gather_clients(x: torch.Tensor, axis: str, tag: str = "uplink") -> torch.Tensor:
    """Every rank's x on the client ``axis``, stacked on a new leading dim
    in client order; no gradient."""
    plan = current_activation_plan()
    if not _live(plan, axis):
        return x[None]
    return _ag(x[None], plan.mesh.get_group(axis), axis, 0, tag)


@torch.no_grad()
def all_reduce_axes(x: torch.Tensor, axes, op: str = "sum", tag: str = "") -> torch.Tensor:
    """All-reduce of x over the plan's ``axes`` (``op`` sum, max or min);
    no gradient. ``max`` is ``torch.amax``'s over the ranks' values: a NaN
    on any rank makes it NaN (it travels as a flag beside the value, in
    the same all-reduce)."""
    plan = current_activation_plan()
    live = _live(plan, axes)
    if not live:
        return x
    if op == "max":
        nan = torch.isnan(x)
        v = torch.stack([torch.where(nan, torch.full_like(x, -float("inf")), x),
                         nan.to(x.dtype)])
        for a in live:
            v = _ar(v, plan.mesh.get_group(a), a, dist.ReduceOp.MAX, tag)
        return torch.where(v[1] > 0, torch.full_like(v[0], float("nan")), v[0])
    rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
    for a in live:
        x = _ar(x, plan.mesh.get_group(a), a, rop, tag)
    return x


# ------------------------------------------------- explicit groups

def all_reduce(x: torch.Tensor, group, axis: str, tag: str = "") -> torch.Tensor:
    """In-place all-reduce (sum) of x over ``group`` (the fleet's gather)."""
    if dist.get_world_size(group) == 1:
        return x
    dist.all_reduce(x, group=group)
    _record("all-reduce", axis, x, dist.get_world_size(group), tag)
    return x


def all_gather(x: torch.Tensor, group, axis: str, dim: int) -> torch.Tensor:
    """Every rank's x over ``group``, concatenated along ``dim``."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [recv_buffer(x, x.shape, group) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    _record("all-gather", axis, out, len(parts))
    return out


def broadcast(x: torch.Tensor, group_src: int, group, axis: str) -> torch.Tensor:
    """x as group rank ``group_src`` holds it, on every rank of ``group``."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, group_src), group=group)
    _record("broadcast", axis, x, dist.get_world_size(group))
    return x


def send_recv(sends: Sequence[torch.Tensor], recvs: Sequence[torch.Tensor], dst: int, src: int,
              group, axis: str) -> None:
    """Send each of ``sends`` to global rank ``dst`` and receive ``recvs``
    from ``src`` in one batch, every request waited on."""
    ops = ([dist.P2POp(dist.isend, t, dst, group) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, group) for t in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    n = dist.get_world_size(group)
    for t in recvs:
        _record("send/recv", axis, t, n)
