"""One rank of a multi-card step, for real, under torch's fake process
group: the memory and collective half of the JAX package's
``repro.launch.dryrun`` (which lowers a step on 512 fake host devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_4k [--multi-pod | --mesh-shape 2x2] [--fl-round] \\
        [--causal-skip] [--batch 2] [--seq 4096] [--steps 2] [--reduced] \\
        [--require-seq-sharded] [--require-alltoall] [--require-flash] \\
        [--out results.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_512 --wire-ratio [--downlink off|quant|delta]

The mesh is JAX's by default: 16x16 (``data`` x ``model``), 2x16x16
(``pod`` x ``data`` x ``model``) with ``--multi-pod`` or ``--wire-ratio``;
``--mesh-shape`` (rank 2-4 onto ``(pod, data, seq, model)``) overrides it.

The fake group (``torch.testing._internal.distributed.fake_pg``) stands
in for a world of ``prod(mesh shape)`` ranks, of which this process is
rank 0: every collective returns at once and MOVES NO DATA, so the
values the step computes (its loss above all) are not meaningful. What
the run does show is rank 0's real part of the step on its device: the
shapes of its shards, its peak memory, its time, and every collective it
issues, counted by ``dist.collectives.CollectiveCounter`` (kind, mesh
axis, result bytes).

The step goes through the normal entry points: ``dist.placement.
init_params_local`` places rank 0's shards (fp32 masters for a train
shape), then 1 warm-up, the gates' step when a gate is asked for, and
``--steps`` timed steps of the shape's step (``--batch`` cuts the
shape's global batch, ``--seq`` its length):

  * train: ``launch.steps.make_train_step(..., mesh=, causal_skip=)``
    with adamw and full remat on the global batch (on a ``seq`` axis above
    1 each rank keeps S / n positions);
  * prefill: ``models.decode.prefill`` under the serve plan on rank 0's
    rows of the batch (its block over the plan's batch axes, as JAX's
    ``in_shardings`` place it; the whole batch where the rows do not
    divide), flash;
  * decode (``decode_32k``; ``long_500k`` through
    ``configs.long_context_variant``): one ``models.decode.decode_step``
    of rank 0's rows under the serve plan, its cache rank 0's block of
    ``cache_specs_plan`` (rows over ``(pod, data)``, KV or state heads over
    ``model`` where they divide it; the encdec family's cross k/v for S
    source positions) standing for a full context: every slot marked,
    ``pos`` reset to S - 1 before each step, so each step reads every
    cached position and issues the same collectives;
  * ``--fl-round`` (a ``pod`` axis of 2 or more: clients = pods): rank 0
    of ``make_fl_round(cfg, mesh=)``, its block of client 0 in fp32 and the
    uniforms of that block only (the whole (K, ...) client stack is never
    built); q_bits and weights fixed from seed 0; the fp32 uplink, no
    downlink; analytic terms of a train step, as JAX's.

Weights and inputs are drawn from seed 0: every family's batch as
``launch.inputs.train_batch_spec`` lays it out (the encdec family's
source frames, the vlm family's patch embeddings).
The record (one JSON line) holds the mesh (and the seconds its creation
took), the global batch and the rows rank 0 holds (``batch_local``), the
per-rank parameter, gradient (as the optimizer update receives it) and
optimizer bytes (a decode: the cache's bytes and shapes), the
peak device memory (``torch.cuda.max_memory_allocated``, not measured on
the CPU: ``peak_gb`` over the run, ``fwd_bwd_peak_gb`` from a step's start
to its optimizer update: forward, backward and the clip), s/step of the
timed steps (``s_per_step``, ``step_seconds``), the gates' step's seconds
apart (``shape_log_step_s``), the counter's bytes and counts by axis and
kind for one timed step, the analytic count the port's code implies for
that step (:func:`analytic_collectives`, dense family, train), whether
every step issued the same collectives (the warm-up's and the gates'
included), and the three roofline terms with the H100's
constants (the collective term from :func:`wire_bytes`). On a ``seq`` axis
the counts hold its all-gathers (K and V in training, the recurrent
families' halos and state pairs), reduce-scatters (their backward),
all-reduces (the gradient sums, the loss's), broadcasts and the ring's
send/recv by kind; the analytic count stays the dense family's on
``{data, model}``. A moe family whose experts and capacity the plan puts
on ``model`` (``models.moe``) adds its all-to-alls there, by kind, gate or
not. JAX's field names come beside the port's (``step``,
``n_chips``, ``causal_skip``, the analytic terms, and the counter's bytes
and counts by kind as ``collective_bytes_per_device``,
``collective_breakdown``, ``collective_counts``). Without ``fake_pg`` it
raises: there is no other route.

Three gates, with the JAX dry run's names and meanings, read the shapes
one step materializes on the rank (``dist.shape_log``) and its
collectives.
That step runs after the warm-up, untimed and alone under the log (the
log's dispatch slows the step it logs), so no timed step runs
under it:

  * ``--require-seq-sharded``: no per-rank tensor of 2 B_loc S d_model
    bytes or more still carries the full sequence length (records
    ``seq_sharded_ok``, ``full_seq_intermediates``);
  * ``--require-alltoall``: the step issued an all-to-all on some axis
    (the counter's records of kind ``all-to-all``; JAX counts every
    all-to-all in its HLO): the MoE's expert dispatch where the plan
    shards the experts and their capacity on one axis (``models.moe``).
    Records ``alltoall_count``;
  * ``--require-flash``: ``attn_impl="flash"``, and no per-rank tensor of
    1 MiB or more carries O(S²) elements (``no_s2_scores_ok``,
    ``s2_offenders``); on a mesh whose ``seq`` axis is above 1 the ring
    must have run: seq-axis send/recv in the counter (``ring_p2p``, the
    counterpart of JAX's collective-permute count).

A gate that fails raises ``AssertionError``, as the JAX dry run's does
(the seq gate's carries every offender as ``offenders``).

``--wire-ratio`` runs the round twice, fp32 and ``wire_packed``, each with
``--downlink``, and records the inter-pod bytes of each
(:func:`run_wire_ratio`).

:func:`main` returns the record (``ok`` true), prints it, appends it to
``--out`` as one JSON line and mirrors it into the obs ledger
(``REPRO_LEDGER``) as a ``record`` event; it raises on any failure. The
command line (:func:`cli`) turns a failure into the JAX dry run's record
(``ok`` false, ``error``, ``traceback``), emitted the same way, and exits
1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import DOWNLINK_MODES

# H100 SXM constants (NVIDIA H100 data sheet; the same figures as chip_smoke.py)
PEAK_FLOPS = 989e12        # bf16 dense tensor cores
HBM_BW = 3.35e12           # bytes/s device memory
NVLINK_BW = 450e9          # bytes/s one direction per GPU (NVLink 4: 900 GB/s bidirectional)

NOT_HELD = "fake process group: no data moved, values not meaningful"
SEED = 0


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _nbytes(tree) -> int:
    from repro_torch import tree as tree_util

    total = 0
    for t in tree_util.leaves(tree):
        local = t.to_local() if type(t).__name__ == "DTensor" else t
        total += local.numel() * local.element_size()
    return total


def wire_bytes(records) -> int:
    """The bytes a rank moves over its links for the counter's ``records``
    (result bytes R, group size n), by NCCL's ring bus-bandwidth factors
    (nccl-tests' PERFORMANCE.md): an all-gather (n-1)/n R, a reduce-scatter
    (n-1) R (its input is n R), an all-reduce 2 (n-1)/n R (a reduce-scatter
    then an all-gather), an all-to-all (n-1)/n R (the block a rank keeps
    does not move), a broadcast or send/recv R."""
    factor = {"all-gather": lambda n: (n - 1) / n, "reduce-scatter": lambda n: n - 1,
              "all-reduce": lambda n: 2 * (n - 1) / n, "all-to-all": lambda n: (n - 1) / n}
    return round(sum(r.bytes * factor.get(r.kind, lambda n: 1)(r.group_size)
                     for r in records))


class _Peaks:
    """Peak device memory by part of a train step (CUDA only): ``fwd_bwd``
    from a step's start to its optimizer update, ``all`` over the run.
    Each read restarts the device's peak counter."""

    def __init__(self, dev: torch.device):
        self.dev, self.fwd_bwd, self.all = dev, 0, 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def read(self) -> int:
        if self.dev.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.dev)
        self.all = max(self.all, peak)
        torch.cuda.reset_peak_memory_stats(self.dev)
        return peak

    def gb(self, nbytes: int) -> Optional[float]:
        return nbytes / 1e9 if self.dev.type == "cuda" else None


def _probed(opt, peaks: _Peaks, probe: dict):
    """``opt`` with an update that first reads what the forward and
    backward left: the gradient's bytes and the peak so far."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params):
        probe["grad_bytes"] = _nbytes(grads)
        peaks.fwd_bwd = max(peaks.fwd_bwd, peaks.read())
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def analytic_collectives(cfg, axis_sizes: dict, batch: int, seq: int) -> dict:
    """The collectives one ``make_train_step(..., mesh=)`` step issues on a
    rank, as ``{axis: {kind: {"count", "bytes"}}}`` (result bytes), for the
    dense family on a ``(data, model)`` mesh with full remat, fp32 masters:

      * each layer leaf, in the forward and again in the remat recompute:
        an all-gather over ``data`` of its FSDP dim (result: the leaf with
        its model dims local); in the backward a reduce-scatter (result:
        its shard). A leaf whole on ``data`` (the norms): an all-reduce of
        its gradient over ``data``;
      * each layer: two all-reduces over ``model`` of the (B/data, S, d)
        activations (attention and SwiGLU outputs) in the forward, one in
        the recompute (non-reentrant checkpoint stops recomputing once it
        has every tensor the backward saved, before the SwiGLU's), two in
        the backward (their inputs' gradients); ``"expand"`` heads
        (KV not dividing ``model``): wk's and wv's gradients all-reduced
        over ``model`` too;
      * the embedding and the unembedding table, once each: an all-gather
        over ``data`` and one over ``model`` (when the vocab divides it),
        and a reduce-scatter over ``data``; the final norm's gradient: an
        all-reduce over ``data``;
      * the loss: two fp32 scalars all-reduced over ``data``;
      * the gradient norm: per set of mesh axes sharding some leaves, one
        all-reduce per axis of their partial sums (fp32, one a leaf).
    """
    from repro_torch.dist.plan import PartitionSpec as P, _entry_axes, make_plan
    from repro_torch.dist.sharding import param_specs
    from repro_torch import tree as tree_util
    from repro_torch.models import model

    if cfg.family != "dense" or set(axis_sizes) - {"data", "model"}:
        raise ValueError("analytic_collectives: the dense family on a (data, model) mesh")
    plan = make_plan(axis_sizes)
    n_d, n_m = axis_sizes.get("data", 1), axis_sizes.get("model", 1)
    out: dict = {}

    def add(axis, kind, nbytes, count=1):
        if (n_d if axis == "data" else n_m) == 1 or count == 0:
            return
        slot = out.setdefault(axis, {}).setdefault(kind, {"count": 0, "bytes": 0})
        slot["count"] += count
        slot["bytes"] += int(nbytes) * count

    def local(shape, spec, axes):
        return math.prod(n // plan.axis_size(tuple(a for a in _entry_axes(e) if a in axes))
                         for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))

    abstract = model.abstract_params(cfg)
    specs = param_specs(plan, abstract)
    act = cfg.activation_dtype.itemsize
    h_loc = cfg.n_heads // n_m if cfg.n_heads % n_m == 0 else cfg.n_heads
    expand = h_loc < cfg.n_heads and cfg.n_kv_heads % n_m != 0
    n_layers = cfg.n_layers
    sharded: dict = {}
    for path, t, spec in zip(tree_util.paths(abstract), tree_util.leaves(abstract),
                             tree_util.leaves(specs)):
        shape = tuple(t.shape)
        axes = tuple(sorted({a for e in spec for a in _entry_axes(e) if plan.axis_size(a) > 1}))
        if axes:
            sharded.setdefault(axes, 0)
            sharded[axes] += 1
        on_data = "data" in axes
        if path[0] == "layers":
            shape, spec = shape[1:], P(*spec[1:])
            if on_data:
                add("data", "all-gather", 4 * local(shape, spec, ("model",)), 2 * n_layers)
                add("data", "reduce-scatter", 4 * local(shape, spec, ("data", "model")),
                    n_layers)
            else:
                add("data", "all-reduce", 4 * local(shape, spec, ("model",)), n_layers)
            if expand and path[-1] in ("wk", "wv"):
                add("model", "all-reduce", 4 * local(shape, spec, ("model",)), n_layers)
        elif path[-1] == "table":
            if on_data:
                add("data", "all-gather", 4 * local(shape, spec, ("model",)))
                add("data", "reduce-scatter", 4 * local(shape, spec, ("data", "model")))
            if "model" in _entry_axes(spec[0]):
                add("model", "all-gather", 4 * math.prod(shape))
        else:
            add("data", "all-reduce", 4 * local(shape, spec, ("model",)))
    if h_loc < cfg.n_heads:
        add("model", "all-reduce", act * (batch // n_d) * seq * cfg.d_model, 5 * n_layers)
    add("data", "all-reduce", 4, 2)
    for axes, n_leaves in sharded.items():
        for a in axes:
            add(a, "all-reduce", 4 * n_leaves)
    return out


def _local_shape(plan, spec, shape, coord) -> tuple:
    return tuple(sl.stop - sl.start for sl in plan.local_slice(spec, shape, coord))


def _inputs(cfg, shape, kind: str, gen: torch.Generator, dev: torch.device,
            plan=None) -> dict:
    """The step's batch, drawn from ``gen`` as ``train_batch_spec`` lays it
    out: tokens and labels in the vocab, a mask of ones, embeddings
    standard normal; a prefill keeps the model inputs. With ``plan``, only
    rank 0's block of the rows, as the plan's ``data_specs`` place them
    (JAX's ``in_shardings``): the whole batch where its rows do not divide."""
    from repro_torch.dist.plan import mesh_coord
    from repro_torch.dist.sharding import data_specs
    from repro_torch.launch.inputs import train_batch_spec

    specs = train_batch_spec(cfg, shape)
    if kind == "prefill":
        specs = {k: v for k, v in specs.items() if k in ("tokens", "vis_embeds", "src_embeds")}
        if cfg.family == "encdec":
            specs.pop("tokens")
    if plan is not None:
        coord = mesh_coord(plan.mesh)
        dspecs = data_specs(plan, specs)
        specs = {k: torch.empty(_local_shape(plan, dspecs[k], v.shape, coord), dtype=v.dtype,
                                device="meta") for k, v in specs.items()}
    out = {}
    for name, spec in specs.items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=dev)
        elif name == "mask":
            out[name] = torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        else:
            out[name] = torch.randn(spec.shape, generator=gen, device=dev).to(spec.dtype)
    return out


def _gates(cfg, sizes: dict, b_loc: int, s: int, log, counter, *, seq_sharded: bool,
           alltoall: bool, flash: bool) -> dict:
    """The three gates on the gates' step's shape log and collectives
    (module docstring); raises ``AssertionError`` where one fails.
    ``b_loc``: the rows of the batch rank 0 holds."""
    from repro_torch.dist.shape_log import full_length_intermediates, no_s2_scores

    gates: dict = {}
    seq_sh = sizes.get("seq", 1)
    if seq_sharded:
        min_bytes = 2 * b_loc * s * cfg.d_model
        offenders = full_length_intermediates(log.entries, s, min_bytes=min_bytes)
        gates.update(seq_sharded_ok=not offenders, full_seq_intermediates=offenders[:10])
        if offenders:
            err = AssertionError(f"{len(offenders)} full-seq intermediates >= {min_bytes}B on a "
                                 f"seq={seq_sh} mesh; top: {offenders[:3]}")
            err.offenders = offenders          # every one, for a caller that compares them
            raise err
    if alltoall:
        n_a2a = sum(1 for r in counter.log if r.kind == "all-to-all")
        gates["alltoall_count"] = n_a2a
        if not n_a2a:
            raise AssertionError("no all-to-all in the step (expected expert-sharded MoE "
                                 f"dispatch on mesh {dict(sizes)})")
    if flash:
        offenders = no_s2_scores(log.entries, s, shards=seq_sh)
        p2p = sum(1 for r in counter.log if r.kind == "send/recv" and r.axis == "seq")
        gates.update(no_s2_scores_ok=not offenders, s2_offenders=offenders[:10], ring_p2p=p2p)
        if offenders:
            raise AssertionError(f"{len(offenders)} O(S^2) score tensors in the flash step "
                                 f"(seq shards={seq_sh}); top: {offenders[:3]}")
        if seq_sh > 1 and not p2p:
            raise AssertionError(f"no seq-axis send/recv in the flash step on a seq={seq_sh} "
                                 "mesh: the ring attention path was not taken")
    return gates


@dataclasses.dataclass
class _Run:
    """One kind of step, built for rank 0: ``step()`` runs it once (under
    ``scope``), ``after()`` gives the record's fields read once the steps
    have run. ``batch_local``: the rows rank 0 holds."""
    cfg: object
    step: Callable[[], None]
    after: Callable[[], dict]
    batch_local: int
    scope: Callable[[], contextlib.AbstractContextManager] = contextlib.nullcontext


def _train_run(cfg, shape, mesh, dev, gen, peaks: _Peaks, causal_skip: bool) -> _Run:
    from repro_torch.dist.parallel import batch_axes
    from repro_torch.dist.placement import init_params_local
    from repro_torch.dist.plan import make_plan
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    plan = make_plan(mesh)
    batch = _inputs(cfg, shape, "train", gen, dev)
    held = {"params": init_params_local(cfg, plan, SEED, device=dev, param_dtype=torch.float32)}
    opt = adamw(3e-4)
    held["state"] = opt.init(held["params"])
    probe: dict = {}
    train_step = make_train_step(cfg, _probed(opt, peaks, probe), mesh=mesh,
                                 causal_skip=causal_skip)

    def step():
        held["params"], held["state"], held["metrics"] = train_step(
            held["params"], held["state"], batch)

    def after():
        sizes = dict(plan.axis_sizes)
        out = dict(param_bytes=_nbytes(held["params"]), grad_bytes=probe["grad_bytes"],
                   opt_bytes=_nbytes(held["state"]),
                   loss_not_held=float(held["metrics"]["loss"]),
                   fwd_bwd_peak_gb=peaks.gb(peaks.fwd_bwd))
        if cfg.family == "dense" and set(sizes) <= {"data", "model"}:
            out["analytic_collectives"] = analytic_collectives(cfg, sizes, shape.global_batch,
                                                               shape.seq_len)
        return out

    rows = shape.global_batch // plan.axis_size(batch_axes(plan, shape.global_batch))
    return _Run(cfg, step, after, rows)


def _prefill_run(cfg, shape, mesh, dev, gen) -> _Run:
    """``decode.prefill`` of rank 0's rows under the serve plan, flash."""
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.placement import init_params_local
    from repro_torch.dist.plan import make_plan
    from repro_torch.models import decode

    cfg = dataclasses.replace(cfg, attn_impl="flash")
    plan = make_plan(mesh, mode="serve")
    batch = _inputs(cfg, shape, "prefill", gen, dev, plan=plan)
    params = init_params_local(cfg, plan, SEED, device=dev)

    def step():
        decode.prefill(cfg, params, batch, shape.seq_len)

    return _Run(cfg, step, lambda: {"param_bytes": _nbytes(params)},
                next(iter(batch.values())).shape[0], lambda: activation_mesh(plan))


def _decode_cache(cfg, shape, plan, rows: int, params, dev) -> dict:
    """Rank 0's block of ``cache_specs_plan(plan, decode_inputs_spec's
    cache)``: zeros, standing for a full context of ``S`` positions
    (``slot_pos`` marks the last ``Lc`` of them; ``pos`` is S - 1). Held
    against ``decode.init_cache``'s shapes for its ``rows`` under the view
    ``parallel.enter`` takes of the placed ``params``."""
    from repro_torch.dist import parallel
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.plan import mesh_coord
    from repro_torch.dist.sharding import cache_specs_plan
    from repro_torch.launch.inputs import decode_inputs_spec
    from repro_torch.models import decode

    s = shape.seq_len
    _tokens, spec = decode_inputs_spec(cfg, shape)
    coord = mesh_coord(plan.mesh)
    specs = cache_specs_plan(plan, spec)
    cache = {name: (torch.zeros(_local_shape(plan, specs[name], t.shape, coord), dtype=t.dtype,
                                device=dev) if torch.is_tensor(t) else s - 1)
             for name, t in spec.items()}
    if "slot_pos" in cache:
        lc = cache["slot_pos"].shape[0]
        kept = torch.arange(s - lc, s, device=dev)
        cache["slot_pos"][kept % lc] = kept.to(torch.int32)
    with activation_mesh(plan):
        view, _, _ = parallel.enter(cfg, params)
        with parallel.holding(view):
            want = decode.init_cache(cfg, rows, s, device="meta")
    for name, t in want.items():
        if torch.is_tensor(t) and tuple(t.shape) != tuple(cache[name].shape):
            raise RuntimeError(f"dryrun: rank 0's cache {name} {tuple(cache[name].shape)} is not "
                               f"init_cache's {tuple(t.shape)} under the rank's view")
    return cache


def _decode_run(cfg, shape, mesh, dev, gen) -> _Run:
    """One ``decode.decode_step`` of rank 0's rows and cache under the
    serve plan, ``pos`` reset to S - 1 before every step (the step writes
    the same slot and reads every cached position each time)."""
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.placement import init_params_local
    from repro_torch.dist.plan import make_plan, mesh_coord
    from repro_torch.dist.sharding import data_specs
    from repro_torch.launch.inputs import decode_inputs_spec
    from repro_torch.models import decode

    plan = make_plan(mesh, mode="serve")
    tokens_spec, _ = decode_inputs_spec(cfg, shape)
    rows = _local_shape(plan, data_specs(plan, tokens_spec), tokens_spec.shape,
                        mesh_coord(mesh))
    tokens = torch.randint(0, cfg.vocab, rows, generator=gen, device=dev)
    params = init_params_local(cfg, plan, SEED, device=dev)
    cache = _decode_cache(cfg, shape, plan, rows[0], params, dev)

    def step():
        cache["pos"] = shape.seq_len - 1
        decode.decode_step(cfg, params, cache, tokens)

    def after():
        tensors = {k: v for k, v in cache.items() if torch.is_tensor(v)}
        return {"param_bytes": _nbytes(params), "cache_bytes": _nbytes(tensors),
                "cache_shapes": {k: list(v.shape) for k, v in tensors.items()}}

    return _Run(cfg, step, after, rows[0], lambda: activation_mesh(plan))


def _fl_inputs(cfg, shape, mesh, dev, gen, downlink: str) -> dict:
    """Rank 0's part of a federated round's inputs on ``mesh`` (clients on
    ``pod``): its block of client 0, fp32 (``init_params_local`` under
    ``fl_plan``) as a DTensor stack with the client dim on ``pod`` (the
    whole (K, ...) stack is never built); the (K, B / K, ...) batch; q_bits
    in 2..8 and weights summing to 1, drawn from seed 0; and the uniforms
    of its block, drawn from ``gen``: client 0's uplink and, with a
    downlink, the broadcast's (the round reads only its own client's, and
    its cut of a whole tensor starts at every dim's origin on rank 0, so
    cutting a block-shaped one leaves it whole)."""
    from repro_torch import tree as tree_util
    from repro_torch.dist.parallel import spec_of
    from repro_torch.dist.placement import _from_local, init_params_local
    from repro_torch.launch.steps import fl_plan

    plan = fl_plan(mesh)
    k = plan.axis_size("pod")
    b = shape.global_batch
    if b % k:
        raise ValueError(f"--fl-round: a global batch of {b} does not divide over {k} clients")
    local = init_params_local(cfg, plan, SEED, device=dev, param_dtype=torch.float32)
    stack = tree_util.map(lambda t: _from_local(plan, t.to_local()[None],
                                                plan.stack(spec_of(t), "clients", k),
                                                (k,) + tuple(t.shape)), local)
    batch = {name: v.reshape((k, b // k) + tuple(v.shape[1:]))
             for name, v in _inputs(cfg, shape, "train", gen, dev).items()}
    draws = torch.Generator().manual_seed(SEED)
    q_bits = torch.randint(2, 9, (k,), generator=draws)
    weights = torch.rand(k, generator=draws)

    def block():
        return [torch.rand(t.to_local().shape, generator=gen, device=dev)
                for t in tree_util.leaves(local)]

    intra = plan.axis_size(tuple(a for a in ("data", "seq") if a in plan.axis_sizes))
    return {"stack": stack, "batch": batch, "q_bits": q_bits, "weights": weights / weights.sum(),
            "uniforms": [block()] + [None] * (k - 1),
            "downlink_uniforms": block() if downlink != "off" else None,
            "clients": k, "rows": b // k // intra}


def _fl_run(cfg, shape, mesh, dev, gen) -> _Run:
    """Rank 0 of ``make_fl_round(cfg, mesh=mesh)`` (fp32 uplink, no
    downlink), the round of JAX's ``lower_fl_round``."""
    from repro_torch.launch.steps import make_fl_round

    fl = _fl_inputs(cfg, shape, mesh, dev, gen, "off")
    fl_round = make_fl_round(cfg, mesh=mesh)
    held = {}

    def step():
        held["out"] = fl_round(fl["stack"], fl["batch"], fl["q_bits"], fl["weights"],
                               uniforms=fl["uniforms"])

    def after():
        return {"param_bytes": _nbytes(fl["stack"]), "n_clients": fl["clients"],
                "q_bits": fl["q_bits"].tolist(), "loss_not_held": float(held["out"][1])}

    return _Run(cfg, step, after, fl["rows"])


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh by default")
    ap.add_argument("--mesh-shape", default=None,
                    help="explicit 2D/3D/4D mesh, e.g. 1x4x2x16 (pod x data x seq x model); "
                         "default 16x16, or 2x16x16 with --multi-pod or --wire-ratio")
    ap.add_argument("--fl-round", action="store_true",
                    help="rank 0 of the federated round (clients = pods)")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--batch", type=int, default=None, help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the shape's sequence length")
    ap.add_argument("--steps", type=int, default=2, help="timed steps after one warm-up")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--require-seq-sharded", action="store_true",
                    help="fail if a big per-rank tensor keeps the full sequence length")
    ap.add_argument("--require-alltoall", action="store_true",
                    help="fail unless the step issues an all-to-all (the expert-sharded MoE "
                         "dispatch)")
    ap.add_argument("--require-flash", action="store_true",
                    help="flash attention; fail if a per-rank tensor holds O(S^2) scores, or "
                         "if a seq axis above 1 ran no ring")
    ap.add_argument("--wire-ratio", action="store_true",
                    help="the round's pod-axis bytes in both wire modes (fp32, packed)")
    ap.add_argument("--downlink", default="off", choices=DOWNLINK_MODES,
                    help="the broadcast mode of both --wire-ratio rounds")
    ap.add_argument("--out", default=None, help="append the record as one JSON line")
    return ap


def _mesh_arg(args) -> str:
    return args.mesh_shape or ("2x16x16" if args.multi_pod or args.wire_ratio else "16x16")


@contextlib.contextmanager
def _fake_world(world: int):
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is initialized already; it makes its own")
    _fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _setup(args, dev):
    """(cfg, shape, mesh shape, axis sizes) of the command line."""
    from repro_torch.configs import get_config, get_reduced, long_context_variant
    from repro_torch.launch.mesh import MESH_AXIS_NAMES, parse_mesh_shape
    from repro_torch.models.config import INPUT_SHAPES

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.shape == "long_500k" and not args.wire_ratio:
        cfg = long_context_variant(cfg)
    if args.require_flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    shape = INPUT_SHAPES[args.shape]
    shape = dataclasses.replace(shape, global_batch=args.batch or shape.global_batch,
                                seq_len=args.seq or shape.seq_len)
    mesh_shape = parse_mesh_shape(_mesh_arg(args))
    sizes = dict(zip(MESH_AXIS_NAMES[len(mesh_shape)], mesh_shape))
    if (args.fl_round or args.wire_ratio) and sizes.get("pod", 1) < 2:
        raise ValueError("--fl-round needs a pod axis >= 2 (clients = pods)")
    return cfg, shape, mesh_shape, sizes


def _mesh(mesh_shape, dev) -> tuple:
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    mesh = make_production_mesh(shape=mesh_shape, device=dev)
    return mesh, time.perf_counter() - t0


def _run_one(args, dev: torch.device) -> dict:
    """A train, prefill, decode or ``--fl-round`` step as rank 0 (module
    docstring)."""
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.shape_log import ShapeLog
    from repro_torch.launch.analytic import analytic_record
    from repro_torch.launch.mesh import mesh_label

    cfg, shape, mesh_shape, sizes = _setup(args, dev)
    kind = "fl_round" if args.fl_round else shape.kind
    world = math.prod(mesh_shape)
    b, s = shape.global_batch, shape.seq_len
    with _fake_world(world):
        mesh, mesh_s = _mesh(mesh_shape, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        peaks = _Peaks(dev)
        if kind == "train":
            run = _train_run(cfg, shape, mesh, dev, gen, peaks, args.causal_skip)
        elif kind == "prefill":
            run = _prefill_run(cfg, shape, mesh, dev, gen)
        elif kind == "decode":
            run = _decode_run(cfg, shape, mesh, dev, gen)
        else:
            run = _fl_run(cfg, shape, mesh, dev, gen)
        cfg = run.cfg
        record = {"arch": args.arch, "shape": args.shape, "kind": kind, "step": kind,
                  "mesh": mesh_label(mesh), "axes": list(mesh.mesh_dim_names),
                  "world": world, "n_chips": world, "rank": 0, "ok": True, "batch": b,
                  "batch_local": run.batch_local, "seq": s, "causal_skip": args.causal_skip,
                  "note": NOT_HELD, "mesh_create_s": mesh_s, "shape_log_step_s": None}
        with run.scope():
            with CollectiveCounter() as warm:
                run.step()                                              # warm-up
            signatures = [warm.signature()]
            if args.require_seq_sharded or args.require_alltoall or args.require_flash:
                # the gates' step: untimed, alone under the shape log
                _sync(dev)
                t0 = time.perf_counter()
                with CollectiveCounter() as logged, ShapeLog() as log:
                    run.step()
                    _sync(dev)
                record["shape_log_step_s"] = time.perf_counter() - t0
                signatures.append(logged.signature())
                b_loc = run.batch_local if kind in ("prefill", "decode") else max(
                    b // (sizes.get("pod", 1) * sizes.get("data", 1)), 1)
                record.update(_gates(cfg, sizes, b_loc, s, log, logged,
                                     seq_sharded=args.require_seq_sharded,
                                     alltoall=args.require_alltoall,
                                     flash=args.require_flash))
            counters, times = [], []
            for _ in range(args.steps):
                _sync(dev)
                peaks.read()
                t0 = time.perf_counter()
                with CollectiveCounter() as c:
                    run.step()
                    _sync(dev)
                times.append(time.perf_counter() - t0)
                counters.append(c)
        record.update(run.after())
        ana = analytic_record(cfg, shape, "train" if kind == "fl_round" else kind, world,
                              causal_skip=args.causal_skip,
                              dp_size=sizes.get("data", 1) * sizes.get("pod", 1))
        peaks.read()
        totals = counters[0].totals()
        by_kind: dict = {}
        for kinds in totals.values():
            for k, v in kinds.items():
                slot = by_kind.setdefault(k, {"count": 0, "bytes": 0})
                slot["count"] += v["count"]
                slot["bytes"] += v["bytes"]
        record.update(
            s_per_step=sum(times) / len(times), step_seconds=times,
            peak_gb=peaks.gb(peaks.all),
            collectives=totals,
            collective_bytes_per_device=sum(v["bytes"] for v in by_kind.values()),
            collective_breakdown={k: v["bytes"] for k, v in by_kind.items()},
            collective_counts={k: v["count"] for k, v in by_kind.items()},
            collectives_same_each_step=all(sig == signatures[0] for sig in
                                           signatures + [c.signature() for c in counters]),
            **ana,
            compute_term_s=ana["analytic_flops_per_device"] / PEAK_FLOPS,
            memory_term_s=ana["analytic_bytes_per_device"] / HBM_BW,
            collective_term_s=wire_bytes(counters[0].log) / NVLINK_BW,
        )
    return record


# the dtypes of the quantized wire (JAX's ``hlo_analysis.WIRE_DTYPES``: u8, s8,
# u16, s16, pred), as the counter names them
WIRE_DTYPES = frozenset({"uint8", "int8", "uint16", "int16", "bool"})


def run_wire_ratio(args, dev: torch.device) -> dict:
    """The round's pod-axis bytes in both wire modes: rank 0 of the round
    (:func:`_fl_inputs`, clients on ``pod``) run once with the fp32 uplink
    and once ``wire_packed``, each with the ``--downlink`` mode, each under
    its own ``CollectiveCounter``; JAX's ``run_wire_ratio`` fields. The
    inter-pod bytes are the counter's ``pod``-axis result bytes (JAX: the
    HLO collectives whose replica groups cross pods): by kind, and split
    into the wire (u8 index planes and packed sign maps) and the dense
    rest (fp32 ranges, payloads, losses, flags) by dtype. The counter
    names each collective's axis, so no byte goes unattributed:
    ``*_unattributed_bytes`` is 0. ``*_wall_s`` is one round's seconds
    (JAX's: its lower and compile). The downlink is one payload for every
    client and moves no pod-axis bytes beyond its range's max (delta); its
    over-the-air bytes are analytic, per client: 4 Z in fp32, Z q / 8 +
    ceil(Z / 8) + 4 quantized at DOWNLINK_Q_BITS."""
    from repro_torch import tree as tree_util
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.launch.mesh import mesh_label
    from repro_torch.launch.steps import DOWNLINK_Q_BITS, make_fl_round
    from repro_torch.models import model

    cfg, shape, mesh_shape, _sizes = _setup(args, dev)
    world = math.prod(mesh_shape)
    with _fake_world(world):
        mesh, mesh_s = _mesh(mesh_shape, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        peaks = _Peaks(dev)
        fl = _fl_inputs(cfg, shape, mesh, dev, gen, args.downlink)
        rec: dict = {"arch": args.arch, "shape": args.shape, "mesh": mesh_label(mesh),
                     "step": "fl_round_wire_ratio", "kind": "fl_round_wire_ratio",
                     "downlink": args.downlink, "ok": True, "world": world, "n_chips": world,
                     "rank": 0, "note": NOT_HELD, "mesh_create_s": mesh_s,
                     "n_clients": fl["clients"], "batch": shape.global_batch,
                     "batch_local": fl["rows"], "seq": shape.seq_len}
        for packed in (False, True):
            fl_round = make_fl_round(cfg, mesh=mesh, wire_packed=packed, downlink=args.downlink)
            _sync(dev)
            t0 = time.perf_counter()
            with CollectiveCounter() as c:
                fl_round(fl["stack"], fl["batch"], fl["q_bits"], fl["weights"],
                         uniforms=fl["uniforms"], downlink_uniforms=fl["downlink_uniforms"])
                _sync(dev)
            wall = time.perf_counter() - t0
            inter = [r for r in c.log if r.axis == "pod"]
            by_kind: dict = {}
            for r in inter:
                by_kind[r.kind] = by_kind.get(r.kind, 0) + r.bytes
            wire = sum(r.bytes for r in inter if r.dtype in WIRE_DTYPES)
            mode = "packed" if packed else "fp32"
            rec[f"{mode}_inter_bytes"] = sum(r.bytes for r in inter)
            rec[f"{mode}_unattributed_bytes"] = 0
            rec[f"{mode}_inter_by_kind"] = by_kind
            rec[f"{mode}_inter_wire_bytes"] = wire
            rec[f"{mode}_inter_dense_bytes"] = rec[f"{mode}_inter_bytes"] - wire
            rec[f"{mode}_wall_s"] = wall
        peaks.read()
        rec["peak_gb"] = peaks.gb(peaks.all)
    # attribution must not silently degrade into the unattributed bucket
    assert rec["fp32_inter_bytes"] > 0 and rec["packed_inter_bytes"] > 0, rec
    assert max(rec["fp32_unattributed_bytes"], rec["packed_unattributed_bytes"]
               ) < 0.1 * rec["fp32_inter_bytes"], rec
    rec["inter_pod_ratio"] = rec["packed_inter_bytes"] / rec["fp32_inter_bytes"]
    z = sum(t.numel() for t in tree_util.leaves(model.abstract_params(cfg)))
    rec["model_dim_z"] = z
    rec["downlink_fp32_bytes"] = 4 * z
    if args.downlink != "off":
        q = DOWNLINK_Q_BITS
        rec["downlink_wire_bytes"] = (z * q) // 8 + (z + 7) // 8 + 4
        rec["downlink_ratio"] = rec["downlink_wire_bytes"] / (4.0 * z)
    return rec


def _emit(rec: dict, out: Optional[str]) -> None:
    """Print the record, append it to ``out`` as one JSON line, and mirror
    it into the obs ledger (``REPRO_LEDGER``) as a ``record`` event."""
    from repro_torch.obs.ledger import default_ledger

    line = json.dumps(rec, default=str)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    default_ledger().record(f"launch.dryrun[{rec['arch']},{rec['shape']}]", rec)


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> dict:
    """Run the command line's dry run and return its record (also printed,
    appended to ``--out`` and mirrored into the ledger). Raises on any
    failure, a gate's included; :func:`cli` turns a failure into a record."""
    args = _parser().parse_args(argv)
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device was found; pass device=\"cpu\"")
    rec = run_wire_ratio(args, dev) if args.wire_ratio else _run_one(args, dev)
    _emit(rec, args.out)
    return rec


def cli(argv: Optional[Sequence[str]] = None,
        device: Optional[Union[str, torch.device]] = None) -> int:
    """``python -m repro_torch.launch.dryrun``: :func:`main`, exit code 0;
    on any exception the JAX dry run's failure record (``ok`` false, the
    error and the traceback's last 4,000 characters), emitted the same
    way, exit code 1."""
    args = _parser().parse_args(argv)
    try:
        main(argv, device)
        return 0
    except Exception as e:  # noqa: BLE001  (a sweep wants the record)
        _emit({"arch": args.arch, "shape": args.shape, "mesh": _mesh_arg(args), "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}, args.out)
        return 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    sys.exit(cli())
