"""One rank of a multi-card step, for real, under torch's fake process
group: the memory and collective half of the JAX package's
``repro.launch.dryrun`` (which lowers a step on 512 fake host devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_4k --mesh-shape 2x2 [--batch 2] [--steps 2] \\
        [--require-seq-sharded] [--require-flash]

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
``--steps`` timed steps of
``launch.steps.make_train_step(..., mesh=)`` with adamw and full remat on
the global batch (``--batch`` cuts the shape's; on a ``seq`` axis above 1
each rank keeps S / n positions), or, for a prefill shape,
``models.decode.prefill`` under the serve plan (``--seq`` cuts the
context; the flash kernels). Weights and inputs are drawn from seed 0:
every family's batch as ``launch.inputs.train_batch_spec`` lays it out
(the encdec family's source frames, the vlm family's patch embeddings).
The record (one JSON line) holds the mesh, the per-rank parameter,
gradient (as the optimizer update receives it) and optimizer bytes, the
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
``{data, model}``. Without
``fake_pg`` it raises: there is no other route.

Two gates, with the JAX dry run's names and meanings, read the shapes one
step materializes on the rank (``dist.shape_log``) and its collectives.
That step runs after the warm-up, untimed and alone under the log (the
log's dispatch slows the step it logs), so no timed step runs
under it:

  * ``--require-seq-sharded``: no per-rank tensor of 2 B_loc S d_model
    bytes or more still carries the full sequence length (records
    ``seq_sharded_ok``, ``full_seq_intermediates``);
  * ``--require-flash``: ``attn_impl="flash"``, and no per-rank tensor of
    1 MiB or more carries O(S²) elements (``no_s2_scores_ok``,
    ``s2_offenders``); on a mesh whose ``seq`` axis is above 1 the ring
    must have run: seq-axis send/recv in the counter (``ring_p2p``, the
    counterpart of JAX's collective-permute count).

A gate that fails raises ``AssertionError``, as the JAX dry run's does
(the seq gate's carries every offender as ``offenders``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
from typing import Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

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
    then an all-gather), a broadcast or send/recv R."""
    factor = {"all-gather": lambda n: (n - 1) / n, "reduce-scatter": lambda n: n - 1,
              "all-reduce": lambda n: 2 * (n - 1) / n}
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


def _inputs(cfg, shape, kind: str, gen: torch.Generator, dev: torch.device) -> dict:
    """The step's batch, drawn from ``gen`` as ``train_batch_spec`` lays it
    out: tokens and labels in the vocab, a mask of ones, embeddings
    standard normal; a prefill keeps the model inputs."""
    from repro_torch.launch.inputs import train_batch_spec

    out = {}
    for name, spec in train_batch_spec(cfg, shape).items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=dev)
        elif name == "mask":
            out[name] = torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        else:
            out[name] = torch.randn(spec.shape, generator=gen, device=dev).to(spec.dtype)
    if kind == "prefill":
        out.pop("labels")
        out.pop("mask")
        if cfg.family == "encdec":
            out.pop("tokens")
    return out


def _gates(cfg, sizes: dict, b: int, s: int, log, counter, *, seq_sharded: bool,
           flash: bool) -> dict:
    """The two gates on the gates' step's shape log and collectives
    (module docstring); raises ``AssertionError`` where one fails."""
    from repro_torch.dist.shape_log import full_length_intermediates, no_s2_scores

    gates: dict = {}
    seq_sh = sizes.get("seq", 1)
    if seq_sharded:
        b_loc = max(b // (sizes.get("pod", 1) * sizes.get("data", 1)), 1)
        min_bytes = 2 * b_loc * s * cfg.d_model
        offenders = full_length_intermediates(log.entries, s, min_bytes=min_bytes)
        gates.update(seq_sharded_ok=not offenders, full_seq_intermediates=offenders[:10])
        if offenders:
            err = AssertionError(f"{len(offenders)} full-seq intermediates >= {min_bytes}B on a "
                                 f"seq={seq_sh} mesh; top: {offenders[:3]}")
            err.offenders = offenders          # every one, for a caller that compares them
            raise err
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


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh-shape", default="2x2")
    ap.add_argument("--batch", type=int, default=None, help="cut the shape's global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the shape's sequence length")
    ap.add_argument("--steps", type=int, default=2, help="timed steps after one warm-up")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--require-seq-sharded", action="store_true",
                    help="fail if a big per-rank tensor keeps the full sequence length")
    ap.add_argument("--require-flash", action="store_true",
                    help="flash attention; fail if a per-rank tensor holds O(S^2) scores, or "
                         "if a seq axis above 1 ran no ring")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.dist.activations import activation_mesh
    from repro_torch.dist.collectives import CollectiveCounter
    from repro_torch.dist.placement import init_params_local
    from repro_torch.dist.plan import make_plan
    from repro_torch.dist.shape_log import ShapeLog
    from repro_torch.launch.analytic import analytic_record
    from repro_torch.launch.mesh import make_production_mesh, mesh_label, parse_mesh_shape
    from repro_torch.models.config import INPUT_SHAPES

    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device was found; pass device=\"cpu\"")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.require_flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    shape = INPUT_SHAPES[args.shape]
    shape = dataclasses.replace(shape, global_batch=args.batch or shape.global_batch,
                                seq_len=args.seq or shape.seq_len)
    kind = shape.kind
    if kind not in ("train", "prefill"):
        raise ValueError(f"dryrun: a {kind} shape is not ported; train or prefill")
    mesh_shape = parse_mesh_shape(args.mesh_shape)
    world = math.prod(mesh_shape)
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is initialized already; it makes its own")
    _fake_group(world)
    try:
        mesh = make_production_mesh(shape=mesh_shape, device=dev)
        sizes = dict(zip(mesh.mesh_dim_names, mesh_shape))
        b, s = shape.global_batch, shape.seq_len
        gen = torch.Generator(device=dev).manual_seed(SEED)
        batch = _inputs(cfg, shape, kind, gen, dev)
        logging = args.require_seq_sharded or args.require_flash
        peaks = _Peaks(dev)
        record = {"arch": args.arch, "shape": args.shape, "kind": kind,
                  "mesh": mesh_label(mesh), "axes": list(mesh.mesh_dim_names),
                  "world": world, "rank": 0, "batch": b, "seq": s, "note": NOT_HELD,
                  "shape_log_step_s": None}
        if kind == "train":
            from repro_torch.launch.steps import make_train_step
            from repro_torch.optim import adamw

            plan = make_plan(mesh)
            held = {"params": init_params_local(cfg, plan, SEED, device=dev,
                                                param_dtype=torch.float32)}
            opt = adamw(3e-4)
            held["state"] = opt.init(held["params"])
            probe: dict = {}
            train_step = make_train_step(cfg, _probed(opt, peaks, probe), mesh=mesh)

            def step():
                held["params"], held["state"], held["metrics"] = train_step(
                    held["params"], held["state"], batch)
            scope = contextlib.nullcontext()
        else:
            from repro_torch.models import decode

            cfg = dataclasses.replace(cfg, attn_impl="flash")
            plan = make_plan(mesh, mode="serve")
            held = {"params": init_params_local(cfg, plan, SEED, device=dev)}

            def step():
                decode.prefill(cfg, held["params"], batch, s)
            scope = activation_mesh(plan)
        with scope:
            with CollectiveCounter() as warm:
                step()                                                  # warm-up
            signatures = [warm.signature()]
            if logging:       # the gates' step: untimed, alone under the shape log
                _sync(dev)
                t0 = time.perf_counter()
                with CollectiveCounter() as logged, ShapeLog() as log:
                    step()
                    _sync(dev)
                record["shape_log_step_s"] = time.perf_counter() - t0
                signatures.append(logged.signature())
                record.update(_gates(cfg, sizes, b, s, log, logged,
                                     seq_sharded=args.require_seq_sharded,
                                     flash=args.require_flash))
            counters, times = [], []
            for _ in range(args.steps):
                _sync(dev)
                peaks.read()
                t0 = time.perf_counter()
                with CollectiveCounter() as c:
                    step()
                    _sync(dev)
                times.append(time.perf_counter() - t0)
                counters.append(c)
        record.update(param_bytes=_nbytes(held["params"]))
        if kind == "train":
            record.update(grad_bytes=probe["grad_bytes"], opt_bytes=_nbytes(held["state"]),
                          loss_not_held=float(held["metrics"]["loss"]),
                          fwd_bwd_peak_gb=peaks.gb(peaks.fwd_bwd))
            if cfg.family == "dense" and set(sizes) <= {"data", "model"}:
                record["analytic_collectives"] = analytic_collectives(cfg, sizes, b, s)
        ana = analytic_record(cfg, shape, kind, world,
                              dp_size=sizes.get("data", 1) * sizes.get("pod", 1))
        peaks.read()
        record.update(
            s_per_step=sum(times) / len(times), step_seconds=times,
            peak_gb=peaks.gb(peaks.all),
            collectives=counters[0].totals(),
            collectives_same_each_step=all(sig == signatures[0] for sig in
                                           signatures + [c.signature() for c in counters]),
            compute_term_s=ana["analytic_flops_per_device"] / PEAK_FLOPS,
            memory_term_s=ana["analytic_bytes_per_device"] / HBM_BW,
            collective_term_s=wire_bytes(counters[0].log) / NVLINK_BW,
        )
    finally:
        dist.destroy_process_group()
    print(json.dumps(record), flush=True)
    return record


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
