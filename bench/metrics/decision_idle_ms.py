"""Device-idle milliseconds a round while the host is inside the
decision's ranges (``greedy_assign``, ``decision_terms``, ``kkt_solve`` of
``repro_torch.sim.policy``): the idle stretches of the traced window cut
by those host ranges."""
from bench import spans


def read(ctx):
    return spans.idle_ms_under_host(ctx["view"], spans.DECISION)
