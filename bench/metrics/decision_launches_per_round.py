"""Device operations (kernels, copies, sets) a round launched from the
decision's ranges (``greedy_assign``, ``decision_terms``, ``kkt_solve``):
those inside the ranges' spans on the device's timeline."""
from bench import spans


def read(ctx):
    return spans.launches_per_round(ctx["view"], spans.DECISION)
