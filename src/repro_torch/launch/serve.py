"""Serving launcher: batched greedy decode with the ring-buffer cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_7b \\
        --batch 4 --context 96 --new-tokens 32 [--ckpt-dir DIR]

The port of ``repro.launch.serve``, with its flags, for the dense family:
:func:`generate` runs the prefill, then greedy argmax decode, one
``decode_step`` per token. ``main`` serves the reduced (smoke) variant of
``--arch`` on ``cuda``, with random weights from ``--seed`` or the latest
checkpoint in ``--ckpt-dir`` (the JAX package's or this package's
``save_checkpoint`` of a parameter tree; loaded as fp32 copies).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import decode_step, prefill
from repro_torch.models.model import Params, require_dense


class Generation(NamedTuple):
    tokens: torch.Tensor     # (B, new_tokens + 1) int64: prefill's argmax, then one per step
    logits: torch.Tensor     # (B, V) fp32 logits of the last step
    prefill_seconds: float   # host clock, prefill and its argmax, ended by a device sync
    decode_seconds: float    # host clock, every decode step, ended by a device sync


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ModelConfig, params: Params, ctx_tokens, new_tokens: int, *,
             device: Optional[Union[str, torch.device]] = None) -> Generation:
    """Prefill ``ctx_tokens`` (B, context), then ``new_tokens`` greedy decode
    steps, with a cache of ``context + new_tokens`` positions. The first
    maximal logit wins a tie. Runs on ``device`` (``cuda`` unless asked
    otherwise), where ``params`` must already live."""
    require_dense(cfg, "generate")
    dev = resolve_device(device)
    ctx = torch.as_tensor(ctx_tokens, dtype=torch.int64, device=dev)
    b, context = ctx.shape
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, {"tokens": ctx}, context + new_tokens)
    out = torch.empty((b, new_tokens + 1), dtype=torch.int64, device=dev)
    out[:, 0] = torch.argmax(logits, dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(new_tokens):
        logits, cache = decode_step(cfg, params, cache, out[:, i])
        out[:, i + 1] = torch.argmax(logits, dim=-1)
    _sync(dev)
    return Generation(out, logits, t1 - t0, time.perf_counter() - t1)


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.ckpt import load_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params, params_from_numpy

    cfg = get_reduced(args.arch)
    dev = resolve_device(device)
    if args.ckpt_dir:
        tree, meta = load_checkpoint(args.ckpt_dir)
        params = params_from_numpy(tree, dev)
        print(f"restored step {meta['step']}")
    else:
        params = init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    ctx = rng.integers(0, cfg.vocab, (args.batch, args.context))
    gen = generate(cfg, params, ctx, args.new_tokens, device=dev)
    dt = gen.decode_seconds
    print(f"prefill of {args.batch} x {args.context} tokens in {gen.prefill_seconds:.2f}s")
    print(f"{args.new_tokens} tokens x {args.batch} requests in {dt:.2f}s "
          f"({args.new_tokens * args.batch / dt:.1f} tok/s)")
    tokens = gen.tokens.cpu().numpy()
    for r in range(args.batch):
        print(f"req{r}: {list(tokens[r][:16])}")
    return gen


if __name__ == "__main__":
    main()
