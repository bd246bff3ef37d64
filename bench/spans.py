"""What the readers of the program's layer ranges share: the ranges'
names, their host records, the device operations inside their spans on
the device's timeline, and the device's idle time under a host range.

The fleet round runs each layer inside one ``obs.profile.scope`` range
(``repro_torch.sim.engine``'s docstring), siblings under the call: a
trace read here gives every launch and every idle stretch of the device a
layer. Everything works on a ``bench.trace.TraceView``, in the profiler's
microseconds, and returns None where the trace holds nothing to read (a
program without the range, a run on the CPU for the device's numbers).
"""
from __future__ import annotations

import bisect

from bench.trace import _union

# the layer ranges directly under a call, in a round's order
LAYERS = ("draw_inputs", "round_state", "greedy_assign", "decision_terms", "kkt_solve",
          "gather_active", "fleet_local_sgd", "quantize_wire", "wire_aggregate",
          "eval_model", "results_to_host")
DECISION = ("greedy_assign", "decision_terms", "kkt_solve")
WIRE = ("quantize_wire", "wire_aggregate")
OUTSIDE = "outside every layer"
# ranges inside a layer's range: the profiler lays an operation on the
# device's timeline under the innermost range only
INNER = {"wire_aggregate": ("cuda_aggregate",)}


def host_records(view, names) -> list[tuple[float, float]]:
    """The host records of the ranges ``names``, in time order. A record
    that is a range's copy on the device's timeline (the same name, start
    and end as one of ``view.annotations``) is not the host's."""
    names = set(names)
    on_device = set(view.annotations)
    return sorted((a, b) for n, a, b in view.host
                  if n in names and (n, a, b) not in on_device)


def host_ms_per_round(view, names) -> float | None:
    """Host milliseconds a round inside the ranges ``names``, overlapping
    records merged."""
    spans = _union(host_records(view, names))
    return sum(b - a for a, b in spans) / 1e3 / view.rounds if spans else None


def device_spans(view, names) -> list[tuple[float, float]]:
    """The ranges' spans on the device's timeline, with those of the ranges
    inside them (``INNER``), merged: each from the first to the last
    operation a record launched."""
    names = set(names).union(*(INNER.get(n, ()) for n in names))
    return _union((a, b) for n, a, b in view.annotations if n in names)


def ops_inside(view, spans) -> int:
    """How many device operations of the call start inside ``spans``
    (sorted, disjoint)."""
    starts = [a for _, a, _ in view.device]
    return sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
               for a, b in spans)


def launches_per_round(view, names) -> float | None:
    """Device operations (kernels, copies, sets) inside the spans of the
    ranges ``names`` on the device's timeline, a round."""
    spans = device_spans(view, names)
    if not view.device or not spans:
        return None
    return ops_inside(view, spans) / view.rounds


def overlap_us(xs, ys) -> float:
    """Time two sorted, disjoint interval lists share."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(view) -> list[tuple[float, float]]:
    """The stretches of the traced window in which no operation ran on
    the device."""
    edges = [view.lo] + [x for ab in view.busy_intervals() for x in ab] + [view.hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def device_busy_ms_per_round(view, names) -> float | None:
    """Device busy milliseconds a round inside the ranges' spans on the
    device's timeline."""
    spans = device_spans(view, names)
    if not view.device or not spans:
        return None
    return overlap_us(spans, view.busy_intervals()) / 1e3 / view.rounds


def idle_ms_under_host(view, names) -> float | None:
    """Device-idle milliseconds a round while the host is inside the
    ranges ``names``."""
    host = _union(host_records(view, names))
    if not view.device or not host:
        return None
    return overlap_us(idle_intervals(view), host) / 1e3 / view.rounds


def launch_split(view) -> dict[str, float]:
    """Device operations a round inside each layer's spans on the device's
    timeline, counted for each layer on its own, and those inside no
    layer's span under ``OUTSIDE``. The parts sum to the call's operations
    a round when no operation lies inside two layers' spans."""
    spans = {name: device_spans(view, (name,)) for name in LAYERS}
    split = {name: ops_inside(view, spans[name]) for name in LAYERS}
    every = _union(ab for name in LAYERS for ab in spans[name])
    split[OUTSIDE] = len(view.device) - ops_inside(view, every)
    return {k: v / view.rounds for k, v in split.items()}
