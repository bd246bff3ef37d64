"""Device operations (kernels, copies, sets) a round launched from the
program's ``fleet_local_sgd`` range (``repro_torch.sim.fleet``: the vmapped
tau-step SGD of the scheduled clients): those inside the range's spans on
the device's timeline."""
from bench import spans


def read(ctx):
    return spans.launches_per_round(ctx["view"], ("fleet_local_sgd",))
