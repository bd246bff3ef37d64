"""Device operations (kernels, copies, sets) a round launched from the
MoE's ranges (``moe_route``, ``moe_experts``, ``shared_expert``), forward,
recompute and backward: those inside the ranges' spans on the device's
timeline."""
from bench import spans
from bench.metrics.moe_device_ms import MOE


def read(ctx):
    return spans.launches_per_round(ctx["view"], MOE)
