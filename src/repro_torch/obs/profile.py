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
