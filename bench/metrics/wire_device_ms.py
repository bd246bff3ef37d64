"""Device busy milliseconds a round inside the wire's ranges on the
device's timeline: ``quantize_wire`` (``repro_torch.sim.engine``'s eq.-4
rounding to wire planes) and ``wire_aggregate`` (the coefficients and the
``aggregate`` kernel's launch)."""
from bench import spans


def read(ctx):
    return spans.device_busy_ms_per_round(ctx["view"], spans.WIRE)
