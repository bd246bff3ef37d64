"""Host milliseconds a call spends in the program's ``results_to_host``
range (``repro_torch.sim.engine``: the call's one copy of its results to
the host, which waits for the device), a round."""
from bench import spans


def read(ctx):
    return spans.host_ms_per_round(ctx["view"], ("results_to_host",))
