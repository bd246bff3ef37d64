"""Training launcher on one device (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --reduced \\
        --steps 100 --batch 8 --seq 128 [--ckpt-dir DIR] [--fl-interval 10] \\
        [--mesh-shape 2x2]

The JAX launcher's flags and printed lines. ``--reduced`` (the default)
trains the arch's reduced variant, ``--full`` its published config, on
``cuda``. ``--mesh-shape`` (``launch.mesh.parse_mesh_shape``; the caller
initializes the process group, ``nccl`` on the card, ``gloo`` with
``device="cpu"``) places the parameters and the adamw state as DTensors
through the mesh's train plan (``dist.placement.init_params_local``: each
rank draws and keeps its shards, the draws of the unsharded run) and
trains with ``make_train_step(..., mesh=)``: the JAX launcher's
``plan.named(param_specs)`` path. Every rank draws the same global batch.
Without the flag the run is on one device. Parameters are fp32 masters from
``--seed``; the optimizer is ``adamw(--lr)`` with the step's global-norm
clip at 1.0; batches come from ``np.random.default_rng(--seed)``, draw for
draw as the JAX launcher makes them. ``--ckpt-dir``/``--ckpt-every`` save
the parameters (``repro_torch.ckpt``: the JAX package's layout, so either
package resumes from the other's files; on a mesh the whole tree, written
by global rank 0); ``--resume`` restores the latest complete one (on a
mesh: re-placed), re-initializes the optimizer and fast-forwards the data
stream and the FL uniforms over the trained steps. ``--fl-interval N``
inserts the paper's quantized aggregation every N steps: two virtual
clients quantize the parameters (on a mesh the whole tree, then
re-placed; the clients are not ranks) with
``core.quantization.quantize_pytree`` at ``--fl-q`` bits, on uniforms from
a torch generator seeded with ``--seed`` (one tensor per leaf, client 1
then client 2), and average them.
``--ledger`` writes the run's header and timings, ``--xprof`` a profile of
the steps after the first.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import resolve_device


class TrainRun(NamedTuple):
    params: dict            # the final parameters (on a mesh: the whole tree, every rank)
    losses: list            # [float] each trained step's loss (the cross-entropy)
    grad_norms: list        # [float] each trained step's pre-clip gradient norm
    start_step: int         # 0, or the resumed checkpoint's step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch(cfg, rng: np.random.Generator, b: int, s: int, dev: torch.device) -> dict:
    """One step's batch, drawn as the JAX launcher draws it: tokens (also
    the labels), then the encdec family's source frames or the vlm
    family's patch embeddings."""
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)), device=dev)
    batch = {"tokens": toks, "labels": toks,
             "mask": torch.ones((b, s), dtype=torch.float32, device=dev)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.as_tensor(rng.normal(size=(b, s, cfg.d_model)),
                                              dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        batch["vis_embeds"] = torch.as_tensor(
            rng.normal(size=(b, cfg.n_vis_tokens, cfg.d_model)), dtype=torch.float32, device=dev)
    return batch


def _skip_batch(cfg, rng: np.random.Generator, b: int, s: int) -> None:
    """The draws of one step's batch, discarded (a resume's fast-forward)."""
    rng.integers(0, cfg.vocab, (b, s))
    if cfg.family == "encdec":
        rng.normal(size=(b, s, cfg.d_model))
    if cfg.family == "vlm":
        rng.normal(size=(b, cfg.n_vis_tokens, cfg.d_model))


def _fl_uniforms(params: dict, gen: torch.Generator) -> list:
    """Two virtual clients' quantizer uniforms, one fp32 tensor per leaf."""
    return [[torch.rand(leaf.shape, generator=gen, device=leaf.device, dtype=torch.float32)
             for leaf in tree_util.leaves(params)] for _ in range(2)]


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest COMPLETE checkpoint in --ckpt-dir (params "
                         "restored, optimizer state re-initialized, data stream and FL "
                         "uniforms fast-forwarded); starts fresh if the directory has none")
    ap.add_argument("--fl-interval", type=int, default=0)
    ap.add_argument("--fl-q", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="JSONL run-ledger path (default: $REPRO_LEDGER)")
    ap.add_argument("--xprof", default=None, metavar="DIR",
                    help="profiler capture of the steps after the first")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2x2: train on a DeviceMesh of the initialized process group")
    args = ap.parse_args(argv)

    from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.quantization import quantize_pytree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params, params_from_numpy
    from repro_torch.obs import Ledger, default_ledger, maybe_trace
    from repro_torch.optim import adamw

    dev = resolve_device(device)
    plan = None
    if args.mesh_shape:
        from repro_torch.dist.plan import make_plan
        from repro_torch.launch.mesh import make_production_mesh, parse_mesh_shape

        plan = make_plan(make_production_mesh(shape=parse_mesh_shape(args.mesh_shape),
                                              device=dev))
    lead = plan is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    ledger = default_ledger(args.ledger) if lead else Ledger(None)
    ledger.run_header(
        name=f"train[{args.arch}]", entry="launch.train", arch=args.arch,
        reduced=bool(args.reduced), steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, fl_interval=args.fl_interval,
        fl_q=args.fl_q, seed=args.seed,
    )
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt = adamw(args.lr)
    if plan is None:
        params = init_params(cfg, args.seed, device=dev, param_dtype=torch.float32)
    else:
        from repro_torch.dist.placement import full_tree, init_params_local, place_tree

        params = init_params_local(cfg, plan, args.seed, device=dev, param_dtype=torch.float32)
    start_step = 0
    if args.resume:
        if not args.ckpt_dir:
            ap.error("--resume requires --ckpt-dir")
        last = latest_step(args.ckpt_dir)
        if last is None:
            say(f"--resume: no complete checkpoint in {args.ckpt_dir}; starting fresh",
                flush=True)
        else:
            # load_checkpoint validates the sidecar (keys/shapes/dtypes)
            tree, meta = load_checkpoint(args.ckpt_dir, last)
            params = params_from_numpy(tree, dev)
            if plan is not None:
                params = place_tree(plan, params)
            start_step = int(meta["step"])
            ledger.write("resume", step=start_step, action="load", dir=str(args.ckpt_dir))
            say(f"resumed from step {start_step} ({args.ckpt_dir})", flush=True)
    opt_state = opt.init(params)     # on a mesh: DTensor moments, the params' placements
    step = make_train_step(cfg, opt, mesh=None if plan is None else plan.mesh)

    rng = np.random.default_rng(args.seed)
    fl_gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, s = args.batch, args.seq
    prof = contextlib.ExitStack()
    # fast-forward the data stream and the FL uniforms over the trained
    # steps, so a resumed run sees what a fresh run would at each step
    for i in range(start_step):
        _skip_batch(cfg, rng, b, s)
        if args.fl_interval and (i + 1) % args.fl_interval == 0:
            _fl_uniforms(params, fl_gen)
    metrics = None
    losses, gnorms = [], []
    t0 = time.time()
    for i in range(start_step, args.steps):
        params, opt_state, metrics = step(params, opt_state, _batch(cfg, rng, b, s, dev))
        losses.append(metrics["loss"])
        gnorms.append(metrics["grad_norm"])
        if i == start_step:
            _sync(dev)
            ledger.timing("first_step", time.time() - t0, entry="launch.train",
                          note="includes the allocator's and libraries' warm-up")
            if args.xprof:  # steady state only
                prof.enter_context(maybe_trace(args.xprof))
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i-start_step+1):.2f}s/step)", flush=True)
        if args.fl_interval and (i + 1) % args.fl_interval == 0:
            # paper eq. 2 on 2 virtual clients: quantize + weighted-average
            whole = params if plan is None else full_tree(params)
            u1, u2 = _fl_uniforms(whole, fl_gen)
            q1, t1 = quantize_pytree(u1, whole, args.fl_q)
            q2, _ = quantize_pytree(u2, whole, args.fl_q)
            params = tree_util.map(
                lambda a, c: (0.5 * a.to(torch.float32) + 0.5 * c.to(torch.float32)).to(a.dtype),
                q1, q2)
            if plan is not None:
                params = place_tree(plan, params)
            say(f"  fl sync @ step {i+1}: q={args.fl_q} theta_max={float(t1):.3f}", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            whole = params if plan is None else full_tree(params)
            if lead:
                path = save_checkpoint(args.ckpt_dir, i + 1, whole,
                                       extra={"loss": float(metrics["loss"])})
                print(f"  saved {path}", flush=True)
            del whole
    prof.close()
    if plan is not None:
        params = full_tree(params)
    run = TrainRun(params, [float(x) for x in losses], [float(x) for x in gnorms], start_step)
    if metrics is None:
        say(f"nothing to do: resumed step {start_step} >= --steps {args.steps}", flush=True)
        return run
    ledger.timing("train_loop", time.time() - t0, entry="launch.train", steps=args.steps,
                  final_loss=float(metrics["loss"]))
    return run


if __name__ == "__main__":
    main()
