"""Profiler scopes: the port's counterpart of ``repro.obs.profile.scope``.

``scope(name)`` is ``torch.profiler.record_function``: a named range in
a ``torch.profiler`` trace (and an NVTX range on the card when NVTX
emission is on), under the same names as the JAX package's
``jax.named_scope`` regions — ``kkt_solve``, ``fleet_local_sgd`` — with
the Pallas kernel scopes renamed for their CUDA ports
(``pallas_aggregate`` -> ``cuda_aggregate``, and so on). Outside a
profiler capture it costs one context-manager entry.
"""
from __future__ import annotations

import torch


def scope(name: str):
    """Named region for profiles: ``with scope("kkt_solve"): ...``"""
    return torch.profiler.record_function(name)
