"""Step builders: a train step and a federated round (the port of
``repro.launch.steps``'s ``make_train_step`` and ``make_fl_round``).

The JAX builders take a mesh and return functions for ``jax.jit`` with
shardings. Here, without a mesh, a builder returns the step on one device;
with a ``DeviceMesh`` (``mesh=``), the step every rank runs on its part
(the train step: FSDP and TP on DTensor parameters and optimizer state,
``dist.parallel``; the round: one client a rank, below). Gradients are autograd's (``torch.autograd.grad``
of :func:`repro_torch.models.model.forward_train`), taken on detached
copies of the parameter leaves, so a step never writes a ``.grad`` and
returns tensors that carry no graph.

The federated round (the paper's technique on the model families): the K
clients' parameters are stacked on a leading dim; each client takes one
local SGD step on its slice of the batch; its model is quantized at its
level q_k against one global range (eq. 4); the server sums the K uploads
with the eq.-2 weights, theta = sum_k w_k Q_{q_k}(theta_k), and broadcasts
the aggregate as every client's next start point. The clients run one after
another in a Python loop, where the JAX round ``vmap``s them: the MoE
routing's scatter and cumsum do not batch over a client dim, and K is small
on one device. Every stochastic draw comes in as an argument (one fp32
uniform tensor per client per leaf for the uplink, one per leaf for the
downlink), or is drawn from the caller's generator in that order, uplink
before downlink, a gate that is off drawing nothing. Drawn, a client's
uplink uniforms are made just before its wire and dropped after it, so
one client's set is alive at a time (the same draws, in the same order,
as drawing every client's first).

With a mesh, the round puts one client on each rank of ``client_axis``,
as the JAX package's ``lower_fl_round`` lays it out: the client stack is
a DTensor sharded on the client axis (:func:`place_clients`), and the
mesh's other axes shard each client's model: ``data`` and ``seq`` are FSDP
and data parallelism within the client (``seq`` as the JAX round makes it,
an intra-client data axis: each rank takes its rows of the client's batch,
and the activations are not cut on the sequence, whose axis the rows
already use), ``model`` its TP. A rank takes its client's local step as a train step does
(``dist.parallel``: its rows of the client's batch, each layer gathered
inside its remat body, the gradient reduce-scattered), so it holds only
its shard of the model and the step's gradient. It quantizes its shard
with its client's uniforms cut to the shard; the client's range is a MAX
all-reduce over its shards. ``collectives.all_gather_clients`` then moves
exactly what the JAX round forces across the client axis (its
``replicate_over_clients``): the fp32 dequantized payloads, or with
``wire_packed`` the u8 index planes and packed sign planes, and each
client's fp32 range. Every rank sums the eq.-2 terms in client order and
runs the downlink and the screen on its shard. Where the client axis is
the only axis above 1, the round is bit-equal to the stacked round on the
same uniforms on the same device type; with intra-client axes the
gradient's sums run in another order, so the local step agrees to fp32
rounding and a stochastic rounding may land one level apart.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import tree as tree_util
from repro_torch.core.quantization import quantize_leaves, quantize_pytree
from repro_torch.dist import collectives
from repro_torch.dist.activations import activation_mesh
from repro_torch.dist.parallel import _is_dtensor, spec_of
from repro_torch.dist.plan import MeshPlan, PartitionSpec as P, make_plan, mesh_coord
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward_train
from repro_torch.obs.profile import scope
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm

Tree = Any

# The broadcast is one payload for every client, quantized at a fixed level
# so the index plane stays uint8 (u8 indexes + sign bitmap + one fp32 range).
DOWNLINK_Q_BITS = 8
DOWNLINK_MODES = ("off", "quant", "delta")
SIGN_PAD = 128   # the packed sign plane's last dim is padded to a multiple of this


def value_and_grad(cfg: ModelConfig, params: Tree, batch: dict,
                   **train_kw) -> tuple[torch.Tensor, dict, Tree]:
    """``forward_train``'s loss, metrics and the loss's gradient with
    respect to every leaf of ``params`` (zeros for a leaf the loss does not
    read, as ``jax.grad`` gives), all detached."""
    key_paths = tree_util.paths(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    with torch.enable_grad():
        loss, metrics = forward_train(cfg, tree_util.from_leaves(key_paths, leaves), batch,
                                      **train_kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for path, p, g in zip(key_paths, leaves, grads):
        if _is_dtensor(p) and (not _is_dtensor(g) or g.placements != p.placements):
            raise RuntimeError(f"the gradient of {'/'.join(path)} lost its parameter's "
                               f"placements {p.placements}")
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_util.from_leaves(key_paths, list(grads)))


# ------------------------------------------------------------ train

def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, mesh=None,
                    causal_skip: bool = False, remat: bool = True, clip_norm: float = 1.0,
                    remat_policy: str = "full") -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss's value and gradient, the gradient clipped to ``clip_norm``
    by its global norm, one optimizer update, applied. ``metrics`` holds
    ``forward_train``'s and the pre-clip ``grad_norm``.

    With a ``DeviceMesh``, every rank calls the step with its DTensor
    params and optimizer state (``dist.placement``) and the global batch;
    the forward and backward run under ``activation_mesh(make_plan(mesh))``
    (``dist.parallel``: FSDP on the data axes, TP/EP on ``model``; on a
    ``seq`` axis above 1 each rank keeps its S / n positions,
    ``models.model.seq_shard``), and the step returns DTensors with
    unchanged placements."""
    plan = None if mesh is None else make_plan(mesh)

    def train_step(params, opt_state, batch):
        with activation_mesh(plan) if plan is not None else contextlib.nullcontext():
            _, metrics, grads = value_and_grad(cfg, params, batch, causal_skip=causal_skip,
                                               remat=remat, remat_policy=remat_policy)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


# ------------------------------------------------------- federated round

def pack_signs(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} u8 leaf (..., d) -> (..., ceil(d'/8)) u8 bitmap, d' = d padded
    up to a multiple of 128, packed along the last axis only, LSB first."""
    d = bits.shape[-1]
    b = torch.nn.functional.pad(bits, (0, (-d) % SIGN_PAD)).reshape(bits.shape[:-1] + (-1, 8))
    weights = torch.ones(8, dtype=torch.int32, device=bits.device) << torch.arange(
        8, dtype=torch.int32, device=bits.device)
    return (b.to(torch.int32) * weights).sum(-1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: the first ``d`` bits of each row, u8."""
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (-1,))[..., :d].to(torch.uint8)


def _draw(shapes: Sequence[tuple], generator: Optional[torch.Generator],
          device: torch.device, what: str) -> list[torch.Tensor]:
    if generator is None:
        raise ValueError(f"fl_round: pass {what} or a generator to draw them from")
    return [torch.rand(s, generator=generator, device=device, dtype=torch.float32)
            for s in shapes]


def _levels(q: torch.Tensor) -> torch.Tensor:
    """fp32 2^q - 1 of an integer level tensor (exact)."""
    return torch.pow(torch.full_like(q, 2.0, dtype=torch.float32), q.to(torch.float32)) - 1.0


def _renormalized(weights: torch.Tensor, ok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The screen's weights: failed clients at 0, the survivors scaled to
    the round's total weight (an exact no-op when every client passes);
    and the count of failed clients, fp32."""
    okf = ok.to(torch.float32)
    w_eff = weights * okf
    w_use = w_eff * (torch.sum(weights) / torch.clamp(torch.sum(w_eff), min=1e-12))
    return w_use, torch.sum(1.0 - okf)


def _stacked_max_abs(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.amax(torch.stack([torch.amax(torch.abs(leaf)) for leaf in leaves]))


def fl_plan(mesh, client_axis: str = "pod") -> MeshPlan:
    """The round's plan (``lower_fl_round``'s): the client axis routes the
    ``clients`` logical axis, the mesh's other data axes shard each
    client's model."""
    names = tuple(mesh.mesh_dim_names)
    if client_axis not in names:
        raise ValueError(f"client axis {client_axis!r} is not an axis of the mesh {names}")
    intra = tuple(a for a in ("data", "seq") if a in names and a != client_axis)
    return make_plan(mesh, dp_override=intra, client_axis=client_axis)


def client_specs(plan: MeshPlan, stacked: Tree) -> Tree:
    """Specs of a (K, ...) client stack: the client axis, then each
    client's ``param_specs``."""
    from repro_torch.dist.sharding import param_specs

    k = tree_util.leaves(stacked)[0].shape[0]
    one = tree_util.map(lambda t: t[0], stacked)
    return tree_util.map(lambda s: plan.stack(s, "clients", k), param_specs(plan, one))


def place_clients(mesh, stacked: Tree, client_axis: str = "pod") -> Tree:
    """A (K, ...) client stack of whole tensors (every rank the same) as
    DTensors laid out for :func:`make_fl_round` on ``mesh``."""
    from repro_torch.dist.placement import place_tree

    plan = fl_plan(mesh, client_axis)
    return place_tree(plan, stacked, client_specs(plan, stacked))


def make_fl_round(cfg: ModelConfig, *, lr: float = 1e-3, wire_packed: bool = False,
                  downlink: str = "off", screen: bool = False, mesh=None,
                  client_axis: str = "pod") -> Callable:
    """One FL communication round (paper Fig. 1 steps 3-5) over K stacked
    clients: ``fl_round(client_params, batch, q_bits, weights, *,
    uniforms=None, downlink_uniforms=None, generator=None,
    client_metrics=None)``.

    ``client_params`` leaves are (K, ...); ``batch`` leaves (K, B_local,
    ...); ``q_bits`` (K,) integer levels; ``weights`` (K,) fp32 eq.-2
    weights w_k = D_k / D^n. ``uniforms[k]`` holds client k's fp32
    uniforms, one tensor per leaf in leaf order; ``downlink_uniforms`` one
    per leaf at the unstacked shape; either is drawn from ``generator``
    when not given. Returns ``(stacked params, mean local loss, theta_max
    (K,))``, and a trailing ``n_screened`` with ``screen``. A list passed as
    ``client_metrics`` gets each client's ``forward_train`` metrics,
    ``grad_norm`` (L,), each leaf's gradient norm, and ``update_norm``
    (L,), each leaf's norm of the step it took, new - start (leaf order),
    in client order, on the device.

    ``wire_packed``: the uplink carries u8 magnitude indexes, a sign bitmap
    (:func:`pack_signs`) and one fp32 range a client, q clamped to 8; the
    server dequantizes and sums them (the same numbers as the byte planes).
    ``downlink``: ``"off"`` broadcasts the fp32 aggregate; ``"quant"``
    quantizes it at DOWNLINK_Q_BITS with one range; ``"delta"`` quantizes
    the round's update ``agg - theta^{n-1}`` instead. ``screen``: a client
    with a non-finite range or payload, or a u8 plane above its 2^q - 1
    levels, is dropped from the sum and the survivors' weights are
    renormalized; when every client fails the round is a no-op.

    ``mesh``: one client a rank of ``client_axis`` (module docstring);
    ``client_params`` is then :func:`place_clients`' DTensor stack, the
    other arguments as above on every rank (the whole (K, ...) batch, all
    K clients' uniforms; B_local must divide over the intra-client data
    axes), and the returned params a DTensor stack with the same
    placements."""
    if downlink not in DOWNLINK_MODES:
        raise ValueError(f"downlink mode {downlink!r} not in {DOWNLINK_MODES}")

    def local_step(params, batch, norms=False):
        loss, metrics, grads = value_and_grad(cfg, params, batch, remat=True)
        with torch.no_grad():
            if norms:
                metrics = dict(metrics, grad_norm=_leaf_norms(tree_util.leaves(grads)))
            new = tree_util.map(lambda p, g: (p - lr * g.to(torch.float32)).to(p.dtype),
                                params, grads)
            if norms:
                metrics["update_norm"] = _leaf_norms(
                    n.float() - p.float()
                    for n, p in zip(tree_util.leaves(new), tree_util.leaves(params)))
        return new, loss, metrics

    if mesh is not None:
        return _fl_round_ranks(fl_plan(mesh, client_axis), client_axis, local_step,
                               wire_packed, downlink, screen)

    @torch.no_grad()
    def fl_round(client_params, batch, q_bits, weights, *, uniforms=None,
                 downlink_uniforms=None, generator: Optional[torch.Generator] = None,
                 client_metrics: Optional[list] = None):
        key_paths = tree_util.paths(client_params)
        c_leaves = tree_util.leaves(client_params)
        n_clients = c_leaves[0].shape[0]
        dev = c_leaves[0].device
        q_bits = torch.as_tensor(q_bits, device=dev).reshape(n_clients)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev).reshape(n_clients)
        shapes = [tuple(leaf.shape[1:]) for leaf in c_leaves]
        news, losses = [], []
        for k in range(n_clients):
            with scope("fl_local_step"):
                new, loss, metrics = local_step(tree_util.map(lambda t: t[k], client_params),
                                                {name: v[k] for name, v in batch.items()},
                                                norms=client_metrics is not None)
            news.append(tree_util.leaves(new))
            losses.append(loss)
            if client_metrics is not None:
                client_metrics.append(metrics)

        def uniforms_of(k):
            # drawn just before client k's wire: one client's set alive at a time
            return uniforms[k] if uniforms is not None else _draw(shapes, generator, dev,
                                                                  "uniforms")

        with scope("fl_uplink"):
            if wire_packed:
                agg, n_screened, theta_max = _packed_uplink(news, shapes, q_bits, weights,
                                                            uniforms_of, screen)
            else:
                agg, n_screened, theta_max = _fp32_uplink(news, key_paths, q_bits, weights,
                                                          uniforms_of, screen)
        if downlink == "off":
            stacked = [g[None].expand(c.shape).to(c.dtype) for g, c in zip(agg, c_leaves)]
        else:
            if downlink_uniforms is None:
                downlink_uniforms = _draw(shapes, generator, dev, "downlink_uniforms")
            stacked = _downlink(downlink, agg, c_leaves, downlink_uniforms)
        loss = torch.stack(losses).mean()
        if not screen:
            return tree_util.from_leaves(key_paths, stacked), loss, theta_max
        # every client screened: the round degrades to a no-op, the
        # start-of-round params carried forward
        any_ok = n_screened < float(n_clients)
        stacked = [torch.where(any_ok, s, c) for s, c in zip(stacked, c_leaves)]
        return tree_util.from_leaves(key_paths, stacked), loss, theta_max, n_screened

    return fl_round


def _fl_round_ranks(plan: MeshPlan, client_axis: str, local_step, wire_packed: bool,
                    downlink: str, screen: bool) -> Callable:
    """:func:`make_fl_round` with one client a rank of ``client_axis``
    (module docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = plan.mesh
    coord = mesh_coord(mesh)
    k_rank = coord[client_axis]
    intra = tuple(a for a in mesh.mesh_dim_names if a != client_axis and plan.axis_size(a) > 1)

    def client_leaf(c, t):
        """The rank's client as a DTensor on ``mesh``: the stack's
        placements without the client dim (the client axis replicates
        it: every rank of a client computes with that client alone)."""
        pls = tuple(Replicate() if p.is_shard() and p.dim == 0
                    else Shard(p.dim - 1) if p.is_shard() else p for p in t.placements)
        shape = t.shape[1:]
        return DTensor.from_local(c[0], mesh, pls, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    def ok_reduce(ok):
        return collectives.all_reduce_axes(ok.to(torch.float32), intra, "min") > 0

    @torch.no_grad()
    def fl_round(client_params, batch, q_bits, weights, *, uniforms=None,
                 downlink_uniforms=None, generator: Optional[torch.Generator] = None):
        key_paths = tree_util.paths(client_params)
        stacks = tree_util.leaves(client_params)
        n_clients = stacks[0].shape[0]
        if n_clients != plan.axis_size(client_axis):
            raise ValueError(f"fl_round: {n_clients} clients on a {client_axis} axis of "
                             f"{plan.axis_size(client_axis)}")
        dev = stacks[0].device
        q_bits = torch.as_tensor(q_bits, device=dev).reshape(n_clients)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev).reshape(n_clients)
        shapes = [tuple(t.shape[1:]) for t in stacks]
        specs = [P(*spec_of(t)[1:]) for t in stacks]
        cuts = [plan.local_slice(sp, shp, coord) for sp, shp in zip(specs, shapes)]
        c_loc = [t.to_local() for t in stacks]                   # (1, ...) the rank's shard
        with activation_mesh(plan):
            new, loss, _ = local_step(
                tree_util.from_leaves(key_paths, [client_leaf(c, t) for c, t in zip(c_loc, stacks)]),
                {name: v[k_rank] for name, v in batch.items()})
        new = [t.to_local() for t in tree_util.leaves(new)]
        if uniforms is None:
            uniforms = [_draw(shapes, generator, dev, "uniforms") for _ in range(n_clients)]
        mine = [u[c] for u, c in zip(uniforms[k_rank], cuts)]
        with activation_mesh(plan):
            tmax = collectives.all_reduce_axes(_stacked_max_abs(new).to(torch.float32), intra,
                                               "max")
            theta_max = collectives.all_gather_clients(tmax, client_axis)
            losses = collectives.all_gather_clients(loss.to(torch.float32), client_axis,
                                                    tag="loss")
            if wire_packed:
                levels = _levels(torch.clamp(q_bits, max=8))
                wire = _client_wire(new, mine, levels[k_rank], tmax)
                planes = [(collectives.all_gather_clients(i, client_axis),
                           collectives.all_gather_clients(sg, client_axis)) for i, sg in wire]
                wires = [[(i[k], sg[k]) for i, sg in planes] for k in range(n_clients)]
                agg, n_screened = _packed_sum(wires, [tuple(t.shape) for t in new], theta_max,
                                              levels, weights, screen, ok_reduce)
            else:
                xq = quantize_leaves(mine, new, int(q_bits[k_rank]), tmax)
                gathered = [collectives.all_gather_clients(x, client_axis) for x in xq]
                agg, n_screened = _fp32_sum([[g[k] for g in gathered] for k in range(n_clients)],
                                            theta_max, weights, screen, ok_reduce)
            if downlink == "off":
                out = [g[None].expand(c.shape).to(c.dtype) for g, c in zip(agg, c_loc)]
            else:
                if downlink_uniforms is None:
                    downlink_uniforms = _draw(shapes, generator, dev, "downlink_uniforms")
                axes = intra + ((client_axis,) if downlink == "delta" else ())
                out = _downlink(downlink, agg, c_loc, [u[c] for u, c in zip(downlink_uniforms, cuts)],
                                theta_reduce=lambda t: collectives.all_reduce_axes(
                                    t, axes, "max", tag="downlink"))
        loss = losses.mean()
        if screen:
            any_ok = n_screened < float(n_clients)
            out = [torch.where(any_ok, o, c) for o, c in zip(out, c_loc)]
        out = [DTensor.from_local(o.contiguous(), mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride()) for o, t in zip(out, stacks)]
        params = tree_util.from_leaves(key_paths, out)
        if not screen:
            return params, loss, theta_max
        return params, loss, theta_max, n_screened

    return fl_round


def _leaf_norms(tensors) -> torch.Tensor:
    """(L,) fp32: each tensor's 2-norm, one tensor alive at a time."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])


def _fp32_uplink(news, key_paths, q_bits, weights, uniforms_of, screen):
    """``core.quantization.quantize_pytree`` per client (the dequantized
    uploads; ``uniforms_of(k)``, client k's uniforms, asked for in client
    order), then the eq.-2 sum in client order."""
    quantized, tmaxes = [], []
    for k, leaves in enumerate(news):
        tq, tmax = quantize_pytree(uniforms_of(k), tree_util.from_leaves(key_paths, leaves),
                                   int(q_bits[k]))
        quantized.append(tree_util.leaves(tq))
        tmaxes.append(tmax)
    theta_max = torch.stack(tmaxes)
    with scope("fl_aggregate"):
        return _fp32_sum(quantized, theta_max, weights, screen) + (theta_max,)


def _fp32_sum(quantized, theta_max, weights, screen, ok_reduce=None):
    """The screen (a client with a non-finite range or payload leaves the
    sum; ``ok_reduce`` ANDs the flags over a client's shards) and the eq.-2
    sum of the dequantized uploads ``quantized[k]`` in client order.
    Returns ``(agg, n_screened)``."""
    n_screened = None
    w_use = weights
    if screen:
        ok = torch.isfinite(theta_max)
        for k, leaves in enumerate(quantized):
            for leaf in leaves:
                ok[k] = ok[k] & torch.isfinite(leaf.to(torch.float32)).all()
        if ok_reduce is not None:
            ok = ok_reduce(ok)
        w_use, n_screened = _renormalized(weights, ok)
        quantized = [[torch.where(ok[k], leaf, torch.zeros_like(leaf)) for leaf in leaves]
                     for k, leaves in enumerate(quantized)]
    agg = []
    for j in range(len(quantized[0])):
        acc = quantized[0][j].to(torch.float32) * w_use[0]
        for k in range(1, len(quantized)):
            acc = acc + quantized[k][j].to(torch.float32) * w_use[k]
        agg.append(acc.to(quantized[0][j].dtype))
    return agg, n_screened


def _client_wire(leaves, uniforms, level, tmax):
    """One client's wire planes: u8 indexes against its range ``tmax`` at
    ``level`` = 2^q - 1 levels, and the packed sign bitmaps."""
    safe = torch.where(tmax > 0, tmax, torch.ones_like(tmax))
    wire = []
    for u, leaf in zip(uniforms, leaves):
        scaled = torch.abs(leaf.to(torch.float32)) * (level / safe)
        lower = torch.floor(scaled)
        idx = lower + (u < scaled - lower).to(torch.float32)
        wire.append((torch.minimum(idx, level).to(torch.uint8),
                     pack_signs((leaf < 0).to(torch.uint8))))
    return wire


def _packed_uplink(news, shapes, q_bits, weights, uniforms_of, screen):
    """The wire format: per client u8 indexes against its global range and
    a packed sign bitmap (``uniforms_of(k)``, client k's uniforms, asked
    for in client order); the screen on the ranges and planes; the
    dequantize and eq.-2 sum of the unpacked planes, in client order."""
    levels = _levels(torch.clamp(q_bits, max=8))
    wires, tmaxes = [], []
    for k, leaves in enumerate(news):
        tmax = _stacked_max_abs(leaves).to(torch.float32)
        wires.append(_client_wire(leaves, uniforms_of(k), levels[k], tmax))
        tmaxes.append(tmax)
    theta_max = torch.stack(tmaxes)
    with scope("fl_aggregate"):
        return _packed_sum(wires, shapes, theta_max, levels, weights, screen) + (theta_max,)


def _packed_sum(wires, shapes, theta_max, levels, weights, screen, ok_reduce=None):
    """The screen on the ranges and the u8 planes (``ok_reduce`` ANDs the
    flags over a client's shards), then the dequantize and eq.-2 sum of the
    unpacked planes in client order. Returns ``(agg, n_screened)``."""
    n_screened = None
    if screen:
        ok = torch.isfinite(theta_max)
        for k, wire in enumerate(wires):
            for idx, _ in wire:
                ok[k] = ok[k] & (torch.amax(idx.to(torch.float32)) <= levels[k])
        if ok_reduce is not None:
            ok = ok_reduce(ok)
        w_use, n_screened = _renormalized(weights, ok)
        coef = w_use * torch.where(ok, theta_max, torch.zeros_like(theta_max)) / levels
    else:
        coef = weights * theta_max / levels
    agg = []
    for j, shape in enumerate(shapes):
        out = None
        for k, wire in enumerate(wires):
            idx, sgn = wire[j]
            mag = idx.to(torch.float32)
            bits = unpack_signs(sgn, shape[-1])
            term = coef[k] * torch.where(bits > 0, -mag, mag)
            out = term if out is None else out + term
        agg.append(out)
    return agg, n_screened


def _downlink(mode, agg, c_leaves, uniforms, theta_reduce=None):
    """The broadcast leg at DOWNLINK_Q_BITS: one range over the target (the
    aggregate for ``"quant"``, the stacked update ``agg - theta^{n-1}`` for
    ``"delta"``; ``theta_reduce`` takes it to the max over every rank's
    part) and one uniform tensor per leaf at the unstacked shape, so every
    client decodes the identical payload."""
    dl_levels = torch.full((), 2.0**DOWNLINK_Q_BITS - 1.0, dtype=torch.float32,
                           device=agg[0].device)
    if mode == "quant":
        target = [g.to(torch.float32) for g in agg]
    else:
        target = [g[None].to(torch.float32) - c.to(torch.float32) for g, c in zip(agg, c_leaves)]
    theta_d = _stacked_max_abs(target)
    if theta_reduce is not None:
        theta_d = theta_reduce(theta_d)
    safe_d = torch.where(theta_d > 0, theta_d, torch.ones_like(theta_d))
    stacked = []
    for u, tgt, c in zip(uniforms, target, c_leaves):
        scaled = torch.abs(tgt) * (dl_levels / safe_d)
        lower = torch.floor(scaled)
        if mode == "delta":
            u = u[None]
        idx = lower + (u < scaled - lower).to(torch.float32)
        deq = torch.sign(tgt) * torch.minimum(idx, dl_levels) * (safe_d / dl_levels)
        deq = torch.where(theta_d > 0, deq, torch.zeros_like(deq))
        if mode == "quant":
            stacked.append(deq[None].expand(c.shape).to(c.dtype))
        else:
            stacked.append((c.to(torch.float32) + deq).to(c.dtype))
    return stacked
