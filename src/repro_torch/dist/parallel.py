"""The per-rank view of a model-parallel forward: FSDP on the data axes,
tensor and expert parallelism on ``model`` (the port of what GSPMD does
for the JAX package under ``param_specs``/``make_opt_specs``).

Parameters are DTensors (``dist.placement``) with the plan's placements.
A forward under ``activation_mesh(plan)`` calls :func:`enter` once: each
DTensor leaf becomes its local tensor (``to_local()``, differentiable:
its gradient comes back as a DTensor with the leaf's placements) and its
spec is read off its placements; a plain tensor is a whole, replicated
leaf. A train forward keeps its rows of the global batch (the plan's
``batch`` rule; the rows must divide over those axes), so its FSDP axes
are the batch's axes. A forward that cuts the sequence over ``seq``
(``models.model.seq_shard``) holds the view with ``seq_axes = ("seq",)``
(:func:`holding_seq`): ``seq`` is not a batch-rows axis and shards no
leaf, but every rank computes with a part of the tokens, so the gradient
of every leaf is summed over it as over a batch axis, and the loss's sums
(:func:`batch_sum`) add over it too.

The model code then asks for each leaf at its use (:func:`layer`,
:func:`tree`, :func:`whole`):

  * a dim sharded over a batch axis is all-gathered, and the gradient
    reduce-scattered (``collectives.gather_fsdp``): FSDP, inside each
    layer's remat body, so the gathered copy dies with the layer and the
    recompute gathers it again;
  * a dim sharded over a data axis the batch is not split over is
    gathered with the rank's slice as its backward (every such rank
    computes the same gradient);
  * a batch axis the leaf is whole on, and ``seq`` when the sequence is
    cut, gets the identity with an all-reduce backward: the data-parallel
    gradient sum of a replicated leaf;
  * a dim on ``model`` stays local: the rank's heads, SwiGLU columns,
    experts, RWKV channels or Mamba2 heads (:func:`heads_mode`,
    :func:`local_experts`), which the model code wraps in
    ``copy_to_model``/``reduce_from_model``. The vocab tables and the vlm
    projection are gathered over ``model`` at use (:func:`whole`).

One rule places ``copy_to_model`` in every family. A replicated leaf or
activation (one every model rank holds alike) whose downstream on a rank
is that rank's part alone enters the rank-local region through
``copy_to_model``: its gradient on a rank is a partial, summed over
``model`` in backward. Slicing the rank's channels or heads out of a whole
``(d,)`` or ``(H,)`` leaf is the typical case (:func:`rank_part`). One
whose downstream is the same on every rank (RWKV's channel-mix gate) must
not: its gradient would be counted m times. A gather whose pieces the
ranks then use differently takes a reduce-scatter backward
(``collectives.gather_fsdp`` over ``model``: the Mamba2 in-projection's
output), not the rank's slice, which is right only where every rank uses
the whole alike (``collectives.gather_model``: the vocab tables,
``vis_proj``).

Without an active plan every function hands its input back unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.dist import collectives
from repro_torch.dist.activations import current_activation_plan
from repro_torch.dist.plan import MeshPlan, PartitionSpec as P, _entry_axes, mesh_coord

@dataclasses.dataclass(frozen=True)
class RankView:
    """One rank's part of a forward: the plan, each leaf's spec by key
    path, the mesh axes the batch rows are split over, the rank's place on
    ``model``, and the axes the sequence is cut over (empty, or
    ``("seq",)``)."""
    plan: MeshPlan
    specs: dict
    batch_axes: tuple
    model: int
    model_idx: int
    seq_axes: tuple = ()


_VIEW: contextvars.ContextVar[Optional[RankView]] = contextvars.ContextVar(
    "repro_torch_rank_view", default=None)


def current() -> Optional[RankView]:
    return _VIEW.get()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def spec_of(t) -> P:
    """A DTensor's spec, read off its placements (mesh axes per tensor dim,
    major to minor); a plain tensor's is all-replicated."""
    if not _is_dtensor(t):
        return P()
    names = t.device_mesh.mesh_dim_names
    entries: list = [[] for _ in range(t.ndim)]
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            entries[pl.dim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} of a parameter is not supported")
    return P(*[tuple(e) if e else None for e in entries])


def batch_axes(plan: MeshPlan, rows: int) -> tuple:
    """The non-``model`` mesh axes a global batch of ``rows`` is split over
    in a train forward; raises when the FSDP axes do not divide it (the
    rows would be replicated under sharded leaves)."""
    ent = plan.spec((rows,), ("batch",), align="left")[0]
    axes = tuple(a for a in _entry_axes(ent) if plan.axis_size(a) > 1)
    fsdp = tuple(a for a in _entry_axes(plan.rules["batch"][0]) if plan.axis_size(a) > 1)
    if set(fsdp) - set(axes):
        raise ValueError(f"a global batch of {rows} rows does not divide over the FSDP axes "
                         f"{fsdp} {[plan.axis_size(a) for a in fsdp]}")
    return axes


def _local_rows(plan: MeshPlan, batch: dict, axes: tuple) -> dict:
    if not axes:
        return batch
    coord = mesh_coord(plan.mesh)
    out = {}
    for name, v in batch.items():
        spec = P(axes if len(axes) > 1 else axes[0])
        out[name] = v[plan.local_slice(spec, v.shape[:1], coord) + (Ellipsis,)]
    return out


def enter(cfg, params, batch: Optional[dict] = None, *, train: bool = False):
    """``(view, local params, local batch)`` for a forward under the active
    plan; ``(None, params, batch)`` without one; the held view and the
    inputs as they are inside a forward that entered already. Raises for
    DTensor leaves without a plan."""
    held = _VIEW.get()
    if held is not None:               # an inner entry point: the leaves are local already
        return held, params, batch
    plan = current_activation_plan()
    leaves = tree_util.leaves(params)
    if plan is None:
        if any(_is_dtensor(t) for t in leaves):
            raise ValueError("DTensor parameters need an active plan "
                             "(dist.activations.activation_mesh)")
        return None, params, batch
    m = plan.axis_size("model")
    key_paths = tree_util.paths(params)
    specs = {p: spec_of(t) for p, t in zip(key_paths, leaves)}
    local = tree_util.from_leaves(key_paths, [t.to_local() if _is_dtensor(t) else t
                                              for t in leaves])
    axes = ()
    if train and batch is not None:
        rows = next(iter(batch.values())).shape[0]
        axes = batch_axes(plan, rows)
        batch = _local_rows(plan, batch, axes)
    idx = plan.mesh.get_local_rank("model") if "model" in plan.mesh.mesh_dim_names else 0
    return RankView(plan, specs, axes, m, idx), local, batch


@contextlib.contextmanager
def holding(view: Optional[RankView]):
    token = _VIEW.set(view)
    try:
        yield
    finally:
        _VIEW.reset(token)


@contextlib.contextmanager
def holding_seq(axis: Optional[str]):
    """The held view with the sequence cut over ``axis`` (module
    docstring); nothing changes for ``None`` or without a view."""
    view = _VIEW.get()
    if axis is None or view is None:
        yield
        return
    token = _VIEW.set(dataclasses.replace(view, seq_axes=(axis,)))
    try:
        yield
    finally:
        _VIEW.reset(token)


def bind(fn):
    """``fn`` run, wherever and whenever it is called (a remat body's
    recompute runs on autograd's thread on the card), inside the context
    variables of the call to ``bind``: the active plan, rank view and
    sequence shard."""
    ctx = contextvars.copy_context()

    def run(*args, **kwargs):
        return ctx.copy().run(fn, *args, **kwargs)

    return run


# ------------------------------------------------------------ leaves

def _use(t: torch.Tensor, spec: P, view: RankView) -> torch.Tensor:
    """The leaf as the rank computes with it: FSDP dims gathered, model
    dims local (module docstring)."""
    used = {a for ent in spec for a in _entry_axes(ent)}
    t = collectives.copy_to(t, tuple(a for a in view.batch_axes + view.seq_axes
                                     if a not in used))
    for d, ent in enumerate(spec):
        for a in reversed(_entry_axes(ent)):
            if a == "model":
                continue
            if a in view.batch_axes:
                t = collectives.gather_fsdp(t, a, d)
            else:
                t = collectives.gather_replicated(t, a, d)
    return t


def layer(lp: dict, stack: str = "layers") -> dict:
    """One layer's leaves (of ``params[stack]``, unstacked) as the rank
    computes with them."""
    view = _VIEW.get()
    if view is None:
        return lp
    key_paths = tree_util.paths(lp)
    return tree_util.from_leaves(key_paths, [
        _use(t, P(*view.specs[(stack,) + p][1:]), view)
        for p, t in zip(key_paths, tree_util.leaves(lp))])


def tree(sub: dict, top: str) -> dict:
    """An unstacked sub-tree ``params[top]`` (the hybrid family's shared
    block, the vlm projection) as the rank computes with it."""
    view = _VIEW.get()
    if view is None:
        return sub
    key_paths = tree_util.paths(sub)
    return tree_util.from_leaves(key_paths, [_use(t, view.specs[(top,) + p], view)
                                             for p, t in zip(key_paths, tree_util.leaves(sub))])


def whole(t: torch.Tensor, path: tuple) -> torch.Tensor:
    """A leaf every model rank uses whole (the (V, d) vocab tables, the
    vlm projection): its FSDP dims as any leaf's, and its dims on
    ``model`` gathered (``collectives.gather_model``: the backward keeps
    the rank's block)."""
    view = _VIEW.get()
    if view is None:
        return t
    spec = view.specs[path]
    t = _use(t, spec, view)
    for d, ent in enumerate(spec):
        if "model" in _entry_axes(ent):
            t = collectives.gather_model(t, d)
    return t


# --------------------------------------------------- tensor parallelism

def heads_mode(cfg, h_local: int, kv_local: int, *, ring: bool = False) -> str:
    """How the rank runs attention, from the heads its ``wq``/``wk`` hold:
    ``"whole"`` (every head: no model axis, or heads that do not divide
    it), ``"sharded"`` (H/m and KV/m heads), ``"expand"`` (H/m heads, KV
    not dividing m: each local q head takes its own K/V head, GQA expanded
    to g = 1 for the rank) or, under the ring (``ring``), ``"gather"``:
    heads stay replicated where either count does not divide m, as the JAX
    package's ring rule says, and the sharded query weights are
    gathered."""
    if h_local == cfg.n_heads:
        return "whole"
    if kv_local < cfg.n_kv_heads:
        return "sharded"
    return "gather" if ring else "expand"


def local_kv_index(cfg, h_local: int, device) -> torch.Tensor:
    """``"expand"`` mode: the K/V head of each of the rank's q heads."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo = _VIEW.get().model_idx * h_local
    return torch.arange(lo, lo + h_local, device=device) // g


def model_index() -> int:
    """The rank's place on ``model`` (0 without an active view)."""
    view = _VIEW.get()
    return 0 if view is None else view.model_idx


def rank_part(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """The rank's block of ``n`` along ``dim`` of a replicated leaf read in
    the rank-local region, behind ``copy_to_model`` (module docstring)."""
    return collectives.copy_to_model(t).narrow(dim, model_index() * n, n)


def on_model(path: tuple, dim: int) -> bool:
    """Whether the leaf at ``path`` is sharded on ``model`` along ``dim``."""
    view = _VIEW.get()
    if view is None or path not in view.specs:
        return False
    spec = view.specs[path]
    return dim < len(spec) and "model" in _entry_axes(spec[dim])


def local_experts(n_experts: int, e_local: int) -> Optional[tuple]:
    """The rank's expert range ``(lo, hi)`` when its expert leaves hold
    ``e_local`` of ``n_experts``; None when it holds them all."""
    if e_local == n_experts:
        return None
    view = _VIEW.get()
    return (view.model_idx * e_local, (view.model_idx + 1) * e_local)


class _GradOnFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def aux_grad_gate(x: torch.Tensor) -> torch.Tensor:
    """The identity; under expert parallelism, the gradient passes on
    model rank 0 only. The MoE's aux losses are computed alike on every
    model rank from the replicated router, whose gradient is then summed
    over ``model`` with the partial gradients of the rank's experts: the
    aux part enters that sum once."""
    view = _VIEW.get()
    if view is None or view.model == 1:
        return x
    return _GradOnFirst.apply(x, view.model_idx == 0)


def _mean_over(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    if not axes:
        return x
    return collectives.reduce_over(x, axes) / _VIEW.get().plan.axis_size(axes)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank batch mean over the batch-rows axes (equal
    rows a rank): the global batch's mean over the rank's positions.
    All-reduce forward, identity backward, then the division."""
    view = _VIEW.get()
    return x if view is None else _mean_over(x, view.batch_axes)


def seq_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the sequence's shards of a per-shard mean (equal
    positions a shard; the MoE's aux values, a mean over routing groups, or
    the whole sequence's on every shard where its groups cross the
    shards). All-reduce forward, identity backward, then the division."""
    view = _VIEW.get()
    return x if view is None else _mean_over(x, view.seq_axes)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A per-rank sum over its rows and positions, summed over the batch
    axes and the sequence's shards (identity backward)."""
    view = _VIEW.get()
    if view is None or not (view.batch_axes or view.seq_axes):
        return x
    return collectives.reduce_over(x, view.batch_axes + view.seq_axes)
