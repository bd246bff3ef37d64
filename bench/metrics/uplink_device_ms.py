"""Device busy milliseconds a round inside the round's uplink ranges on
the device's timeline (``repro_torch.launch.steps.make_fl_round``:
``fl_uplink``, each client's wire uniforms, its range and its eq.-4 index
and sign planes, and ``fl_aggregate``, the eq.-2 dequantize and sum)."""
from bench import spans


def read(ctx):
    return spans.device_busy_ms_per_round(ctx["view"], ("fl_uplink", "fl_aggregate"))
