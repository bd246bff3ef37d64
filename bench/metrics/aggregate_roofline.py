"""The ``aggregate_kernel`` launch's share of its roofline: the least time
of the bytes it needs (``bench.counts.wire_bytes``) at the card's HBM
bandwidth, over its mean time in the trace, in %."""
from bench.counts import peaks
from bench.counts.wire_bytes import aggregate_bytes


def read(ctx):
    times = ctx["view"].kernels("aggregate_kernel")
    peak = peaks.of(ctx["device_kind"])
    if not times or peak is None:
        return None
    least_us = aggregate_bytes(ctx["config"], ctx["traffic"]) / peak["hbm_bytes_per_s"] * 1e6
    return 100.0 * least_us / (sum(times) / len(times))
