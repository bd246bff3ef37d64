"""Device busy milliseconds a round inside the MoE's ranges on the device's
timeline: ``moe_route`` (the router, its top-k and the sort of the held
experts' slots), ``moe_experts`` (the grouped expert products and the
combine) and ``shared_expert``, each in its forward, its recompute and its
backward (``repro_torch.models.moe.dropless_apply``, ``models.model``)."""
from bench import spans

MOE = ("moe_route", "moe_experts", "shared_expert")


def read(ctx):
    return spans.device_busy_ms_per_round(ctx["view"], MOE)
