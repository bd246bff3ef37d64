"""Serving launcher: batched greedy decode with the ring-buffer cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_7b \\
        --batch 4 --context 96 --new-tokens 32 [--ckpt-dir DIR] [--mesh-shape 1x2]

The port of ``repro.launch.serve``, with its flags, for every family:
:func:`generate` runs the prefill, then greedy argmax decode,
one ``decode_step`` per token; it takes the vlm family's patch embeddings
(``vis_embeds``) and the encdec family's source frames (``src_embeds``).
``main`` serves the reduced (smoke) variant of ``--arch`` on ``cuda``,
with random weights from ``--seed`` or the latest checkpoint in
``--ckpt-dir`` (the JAX package's or this package's ``save_checkpoint``
of a parameter tree; loaded as fp32 copies). For encdec it follows the
JAX launcher: ``encode`` of ``--context`` normal frames, then greedy
decode from BOS = 0. It refuses the vlm family: the launcher draws no
patch embeddings (the JAX launcher fails there with a ``KeyError``).
``--mesh-shape`` serves tensor-parallel on a mesh of the initialized
process group (``make_plan(mesh, mode="serve")``: the parameters placed as
DTensors, each rank its heads, SwiGLU columns or experts; the dense and
moe families), every rank with the same tokens; without it, one device.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import Cache, decode_step, encode, init_cache, prefill
from repro_torch.models.model import Params


class Generation(NamedTuple):
    tokens: torch.Tensor     # (B, new_tokens + 1) int64: prefill's argmax (main's encdec
                             # branch: BOS), then one per step
    logits: Optional[torch.Tensor]   # (B, V) fp32 logits of the last step (None if none ran)
    prefill_seconds: float   # host clock, prefill (or encode) and its argmax, ended by a sync
    decode_seconds: float    # host clock, every decode step, ended by a device sync


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _embeds(x, name: str, cfg: ModelConfig, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if t.ndim != 3 or t.shape[2] != cfg.d_model:
        raise ValueError(f"generate: {name} must be (B, n, {cfg.d_model}), got {tuple(t.shape)}")
    return t


def _prefill_batch(cfg: ModelConfig, ctx_tokens, vis_embeds, src_embeds, new_tokens: int,
                   dev: torch.device) -> tuple[dict, int]:
    """The prefill's batch and the cache's length: every position the
    prefill and the ``new_tokens`` decode steps write."""
    takes = {"vlm": "vis_embeds", "encdec": "src_embeds"}.get(cfg.family)
    for name, x in (("vis_embeds", vis_embeds), ("src_embeds", src_embeds)):
        if (x is not None) != (name == takes):
            raise ValueError(f"generate: the {cfg.family} family "
                             f"{'takes' if name == takes else 'does not take'} {name}")
    if cfg.family == "encdec":
        if ctx_tokens is not None:
            raise ValueError("generate: the encdec family decodes from BOS; pass "
                             "ctx_tokens=None and the source frames as src_embeds")
        return {"src_embeds": _embeds(src_embeds, "src_embeds", cfg, dev)}, 1 + new_tokens
    batch = {"tokens": torch.as_tensor(ctx_tokens, dtype=torch.int64, device=dev)}
    n_vis = 0
    if cfg.family == "vlm":
        batch["vis_embeds"] = _embeds(vis_embeds, "vis_embeds", cfg, dev)
        n_vis = batch["vis_embeds"].shape[1]
    return batch, n_vis + batch["tokens"].shape[1] + new_tokens


def _greedy(cfg: ModelConfig, params: Params, cache: Cache, first: torch.Tensor,
            logits: Optional[torch.Tensor], new_tokens: int, t0: float) -> Generation:
    """``new_tokens`` greedy decode steps after ``first`` (B,); the
    prefill's seconds are counted from ``t0``."""
    dev = first.device
    out = torch.empty((first.shape[0], new_tokens + 1), dtype=torch.int64, device=dev)
    out[:, 0] = first
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(new_tokens):
        logits, cache = decode_step(cfg, params, cache, out[:, i])
        out[:, i + 1] = torch.argmax(logits, dim=-1)
    _sync(dev)
    return Generation(out, logits, t1 - t0, time.perf_counter() - t1)


def generate(cfg: ModelConfig, params: Params, ctx_tokens, new_tokens: int, *,
             vis_embeds=None, src_embeds=None,
             device: Optional[Union[str, torch.device]] = None) -> Generation:
    """Prefill, then ``new_tokens`` greedy decode steps, with a cache of
    every position they write. ``ctx_tokens`` (B, context) is the context;
    the vlm family also takes ``vis_embeds`` (B, n_vis, D), its patch
    embeddings, placed before the context; the encdec family takes
    ``src_embeds`` (B, S_src, D) and no context (``ctx_tokens=None``): its
    prefill encodes the source and decodes BOS = 0. The first maximal logit
    wins a tie. Runs on ``device`` (``cuda`` unless asked otherwise), where
    ``params`` must already live."""
    dev = resolve_device(device)
    batch, seq_len = _prefill_batch(cfg, ctx_tokens, vis_embeds, src_embeds, new_tokens, dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, seq_len)
    return _greedy(cfg, params, cache, torch.argmax(logits, dim=-1), logits, new_tokens, t0)


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 1x2: tensor-parallel serving on the initialized process group")
    args = ap.parse_args(argv)

    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params, params_from_numpy

    cfg = get_reduced(args.arch)
    if cfg.family == "vlm":
        raise ValueError(
            f"--arch {args.arch}: the vlm family's prefill takes patch embeddings and this "
            "launcher draws none (the JAX launcher fails here with KeyError 'vis_embeds'); "
            "serve the family with generate(cfg, params, ctx, n, vis_embeds=...)")
    dev = resolve_device(device)
    if args.ckpt_dir:
        tree, meta = load_checkpoint(args.ckpt_dir)
        params = params_from_numpy(tree, dev)
        print(f"restored step {meta['step']}")
    else:
        params = init_params(cfg, args.seed, device=dev)
    scope = contextlib.nullcontext()
    if args.mesh_shape:
        from repro_torch.dist.activations import activation_mesh
        from repro_torch.dist.placement import place_tree
        from repro_torch.dist.plan import make_plan
        from repro_torch.launch.mesh import make_production_mesh, parse_mesh_shape

        plan = make_plan(make_production_mesh(shape=parse_mesh_shape(args.mesh_shape),
                                              device=dev), mode="serve")
        params = place_tree(plan, params)
        scope = activation_mesh(plan)
    rng = np.random.default_rng(args.seed)
    b = args.batch
    ctx = rng.integers(0, cfg.vocab, (b, args.context))
    with scope:
        gen = _serve(cfg, params, args, rng, ctx, b, dev)
    if args.mesh_shape and torch.distributed.get_rank() != 0:
        return gen
    dt = gen.decode_seconds
    print(f"{args.new_tokens} tokens x {b} requests in {dt:.2f}s "
          f"({args.new_tokens * b / dt:.1f} tok/s)")
    tokens = gen.tokens.cpu().numpy()
    for r in range(b):
        print(f"req{r}: {list(tokens[r][:16])}")
    return gen


def _serve(cfg, params, args, rng, ctx, b, dev) -> Generation:
    if cfg.family == "encdec":
        # the JAX launcher's branch: its cache, frames drawn after the context
        src = torch.as_tensor(rng.normal(size=(b, args.context, cfg.d_model)),
                              dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        cache = encode(cfg, params, init_cache(cfg, b, args.context + args.new_tokens,
                                               device=dev), src)
        bos = torch.zeros((b,), dtype=torch.int64, device=dev)
        gen = _greedy(cfg, params, cache, bos, None, args.new_tokens, t0)
        print(f"encode of {b} x {args.context} source frames in {gen.prefill_seconds:.2f}s")
    else:
        gen = generate(cfg, params, ctx, args.new_tokens, device=dev)
        print(f"prefill of {b} x {args.context} tokens in {gen.prefill_seconds:.2f}s")
    return gen


if __name__ == "__main__":
    main()
