"""Profiler hooks: the port's counterpart of ``repro.obs.profile``.

``scope(name)`` is ``torch.profiler.record_function``: a named range in
a ``torch.profiler`` trace (and an NVTX range on the card when NVTX
emission is on), under the same names as the JAX package's
``jax.named_scope`` regions — ``kkt_solve``, ``fleet_local_sgd`` — with
the Pallas kernel scopes renamed for their CUDA ports
(``pallas_aggregate`` -> ``cuda_aggregate``, and so on). Outside a
profiler capture it costs one context-manager entry.

``maybe_trace(dir)`` captures a ``torch.profiler`` trace of its block
(host and, on the card, CUDA activity) and writes it into ``dir`` as a
Chrome trace; ``None`` is a no-op context, so a CLI can expose
``--trace DIR`` without branching. A profiler that cannot start or stop
only prints a warning: capturing a profile never takes a run down with it.
Capture the steady-state region only (after the first call has built the
kernels), so the trace shows rounds, not set-up.

``ranged(name, fn, x)`` is ``scope`` around ``fn(x)`` whose backward, as
autograd runs it, opens a range of the same name too.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def scope(name: str):
    """Named region for profiles: ``with scope("kkt_solve"): ...``"""
    return torch.profiler.record_function(name)


class _BackwardRange:
    """A profiler range that a region's backward opens and closes: opened
    by :class:`_RangeOpen`'s backward (the gradient reaches the region's
    output), closed by :class:`_RangeClose`'s (the gradient leaves through
    its input)."""

    def __init__(self, name: str):
        self.name, self.rf = name, None


class _RangeOpen(torch.autograd.Function):
    """Saves its input so that its backward unpacks a saved tensor before
    it opens the range: under non-reentrant ``torch.utils.checkpoint``
    the first unpack in a checkpointed region recomputes the region, and
    that recompute (its own forward ranges) then falls before this range,
    not inside it."""

    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        ctx.rng.rf = torch.profiler.record_function(ctx.rng.name)
        ctx.rng.rf.__enter__()
        return g, None


class _RangeClose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rng):
        ctx.rng = rng
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.rng.rf is not None:
            ctx.rng.rf.__exit__(None, None, None)
            ctx.rng.rf = None
        return g, None


def ranged(name: str, fn, x: torch.Tensor):
    """``fn(x)`` inside the profiler range ``name``, and its backward inside
    a range of the same name, where autograd records it (x requires grad).
    Returns fn's result; a tuple's first element is the region's output
    whose gradient opens the backward's range. Where autograd records
    nothing (no grad, or x needs none) only the forward's range opens.
    Between the two markers the backward runs on one thread (autograd's),
    and the range brackets it as the forward's brackets the forward."""
    marked = torch.is_grad_enabled() and x.requires_grad
    if marked:
        rng = _BackwardRange(name)
        x = _RangeClose.apply(x, rng)
    with scope(name):
        out = fn(x)
    if not marked:
        return out
    if not isinstance(out, tuple):
        return _RangeOpen.apply(out, rng)
    first = _RangeOpen.apply(out[0], rng)
    if hasattr(out, "_fields"):                 # a NamedTuple
        return out._replace(**{out._fields[0]: first})
    return (first,) + out[1:]


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` capture of the block written to ``trace_dir``
    (``trace_<time>_<pid>.json``, Chrome trace format) when a directory is
    given, else a no-op."""
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001
        print(f"# trace capture unavailable ({type(e).__name__}: {e})", flush=True)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(trace_dir, f"trace_{int(time.time() * 1e3):x}_{os.getpid()}.json")
                prof.export_chrome_trace(path)
                print(f"# trace written to {path}", flush=True)
            except Exception as e:  # noqa: BLE001
                print(f"# trace stop failed ({type(e).__name__}: {e})", flush=True)
