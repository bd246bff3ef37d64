"""The traced window: one call of the timed entry under ``torch.profiler``
(host and device activity), reduced to what the per-layer readers use.

A capture whose trace holds no device operation is taken once more; a
second empty one fails the run (a profiler that came back without the
device's activity would read as an idle device).
"""
from __future__ import annotations

import bisect
import sys

WINDOW = "bench_window"


class EmptyTrace(RuntimeError):
    """The profiler gave back no device activity."""


def _is_device(e) -> bool:
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False))


def _union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same time as ``intervals``."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class TraceView:
    """Intervals of one traced call, in the profiler's microseconds."""

    def __init__(self, events, rounds: int) -> None:
        self.rounds = rounds
        cpu = [e for e in events if not _is_device(e) and not getattr(e, "is_async", False)]
        window = [e for e in cpu if e.name == WINDOW]
        if not window:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        w = window[0]
        self.lo, self.hi = w.time_range.start, w.time_range.end
        self.thread = w.thread

        def inside(e):
            return e.time_range.start >= self.lo and e.time_range.end <= self.hi

        self.device = sorted(((e.name, e.time_range.start, e.time_range.end)
                              for e in events if _is_device(e) and inside(e)),
                             key=lambda t: t[1])
        # the program's ranges as the profiler lays them on the device's
        # timeline: from the first to the last operation a range launched
        self.annotations = [(e.name, e.time_range.start, e.time_range.end) for e in events
                            if str(getattr(e, "device_type", "")).endswith("CUDA")
                            and getattr(e, "is_user_annotation", False)]
        self.host = sorted(((e.name, e.time_range.start, e.time_range.end)
                            for e in cpu if e.thread == self.thread and inside(e)
                            and e is not w), key=lambda t: (t[1], -t[2]))

    # ---------------------------------------------------------------- device

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        return _union((a, b) for _, a, b in self.device)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, part: str) -> list[float]:
        """Durations (us) of the device operations whose name holds ``part``."""
        return [b - a for name, a, b in self.device if part in name]

    def top_device_ops(self, n: int) -> list[list]:
        total: dict[str, float] = {}
        for name, a, b in self.device:
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    # ------------------------------------------------------------------ host

    def ranges(self, name: str) -> list[tuple[float, float]]:
        """The host ranges named ``name``, overlapping records merged."""
        return _union((a, b) for n, a, b in self.host if n == name)

    def device_us_inside(self, name: str) -> float | None:
        """Device busy time inside the ``name`` range's spans on the device's
        timeline (None when the trace lays no such span there)."""
        spans = _union((a, b) for n, a, b in self.annotations if n == name)
        if not spans:
            return None
        return sum(max(0.0, min(b, hi) - max(a, lo))
                   for lo, hi in spans for a, b in self.busy_intervals())

    def top_level(self) -> list[tuple[str, float, float]]:
        """The host operations directly under the window, in time order."""
        out: list[tuple[str, float, float]] = []
        for n, a, b in self.host:
            if not out or a >= out[-1][2]:
                out.append((n, a, b))
        return out

    def idle_gaps(self, n: int) -> list[list]:
        """Idle device time in the window, summed by the top-level host
        operation under each gap's middle, the largest ``n``."""
        tops = self.top_level()
        starts = [a for _, a, _ in tops]
        edges = [self.lo] + [x for ab in self.busy_intervals() for x in ab] + [self.hi]
        total: dict[str, float] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            label = tops[i][0] if i >= 0 and mid < tops[i][2] else "host, between operations"
            total[label] = total.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def capture(fn, rounds: int, on_card: bool, attempts: int = 2):
    """(TraceView, fn's result) of one traced call of ``fn``; ``on_card``
    when ``fn`` runs on the card (a run on the CPU has no device trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    for attempt in range(attempts):
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                out = fn()
        view = TraceView(prof.events(), rounds)
        if view.device or not on_card:
            return view, out
        print(f"bench: traced call {attempt + 1} holds no device operation",
              file=sys.stderr, flush=True)
    raise EmptyTrace(f"{attempts} traced calls hold no device operation")


def kernel_names(fn, on_card: bool) -> tuple[list[str], object]:
    """(names of the device operations, fn's result) of one call of ``fn``
    under the profiler, device activity only; none for a run on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not on_card:
        return [], fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if _is_device(e)], out


def below_precision(names, markers) -> int:
    """How many of ``names`` carry a marker of math below the stated
    precision (case aside), as NVIDIA's libraries name such kernels."""
    marks = [m.lower() for m in markers]
    return sum(any(m in n.lower() for m in marks) for n in names)
