"""The shapes a rank's step materializes, and the dry run's two gates on
them: the port's counterpart of ``repro.dist.hlo_analysis``'s
``full_length_intermediates`` and ``no_s2_scores``, which read the
per-device result shapes of a compiled SPMD program.

The port has no compiled program to read. :class:`ShapeLog` is a
``TorchDispatchMode``: while it is open, every aten op the rank runs
records the shape, dtype and bytes of each tensor it returns (a DTensor
by its local tensor: the rank's part), so the log holds the per-rank
result shapes the HLO would. The two functions apply the JAX package's
rules to that log, unchanged.

The hand-written kernels are called through ctypes and are not aten ops:
what they compute is not seen, but their outputs are allocated by
``torch.empty`` on the host side of the wrapper, which is logged (a flash
kernel's output is (B, S, H, hd), never a score matrix). Ops that
autograd runs in backward are logged too: the mode is part of the
thread-local state autograd carries to its engine's threads.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclasses.dataclass(frozen=True)
class Entry:
    """One tensor an op returned: the op's name, the shape, dtype and bytes."""
    op: str
    shape: tuple
    dtype: str
    bytes: int

    def label(self) -> str:
        return f"{self.dtype}[{','.join(str(n) for n in self.shape)}]"


def _local(t: torch.Tensor) -> torch.Tensor:
    inner = getattr(t, "_local_tensor", None)       # a DTensor's part on this rank
    return t if inner is None else inner


class ShapeLog(TorchDispatchMode):
    """``with ShapeLog() as log:`` records every aten op's result tensors
    in ``log.entries``, in issue order."""

    def __init__(self):
        super().__init__()
        self.entries: list[Entry] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket.__name__) if hasattr(func, "overloadpacket") else str(func)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t = _local(t)
                self.entries.append(Entry(name, tuple(t.shape),
                                          str(t.dtype).removeprefix("torch."),
                                          math.prod(t.shape) * t.element_size()))
        return out


def _offender(e: Entry) -> dict:
    return {"op": e.op, "shape": e.label(), "bytes": e.bytes}


def full_length_intermediates(entries, length: int, *, min_bytes: int = 0, max_rank: int = 4,
                              ignore_last_dim: bool = True) -> list[dict]:
    """Per-rank tensors that still carry a full-``length`` dim (the
    sequence dim was not sharded), ``min_bytes`` and above, of rank
    ``max_rank`` or less (the stacked caches are rank 5), sorted by bytes,
    descending; empty means the sequence sharding held. With
    ``ignore_last_dim`` a tensor whose only full-length dim is its last is
    skipped (a feature dim that equals the length). The JAX package's rule
    and caveats (``hlo_analysis.full_length_intermediates``)."""
    out = []
    for e in entries:
        dims = list(e.shape)
        if len(dims) > max_rank or length not in dims:
            continue
        if ignore_last_dim and length not in dims[:-1]:
            continue
        if e.bytes < min_bytes:
            continue
        out.append(_offender(e))
    out.sort(key=lambda o: -o["bytes"])
    return out


def no_s2_scores(entries, length: int, *, shards: int = 1,
                 min_bytes: int = 1 << 20) -> list[dict]:
    """Per-rank tensors of ``min_bytes`` and above that carry O(length²)
    elements: two or more dims that are positive multiples of the
    per-rank length ``length // shards``, or one dim that is a multiple of
    its square (a flattened score matrix); sorted by bytes, descending.
    The JAX package's rule (``hlo_analysis.no_s2_scores``)."""
    unit = max(1, length // max(1, shards))
    out = []
    for e in entries:
        carrying = sum(1 for d in e.shape if d >= unit and d % unit == 0)
        flattened = any(d >= unit * unit and d % (unit * unit) == 0 for d in e.shape)
        if carrying < 2 and not flattened:
            continue
        if e.bytes < min_bytes:
            continue
        out.append(_offender(e))
    out.sort(key=lambda o: -o["bytes"])
    return out
