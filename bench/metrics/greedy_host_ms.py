"""Host milliseconds a round inside the program's ``greedy_assign`` ranges
(``repro_torch.sim.policy.greedy_assign``: the C argmax steps of the
channel assignment), host records only."""
from bench import spans


def read(ctx):
    return spans.host_ms_per_round(ctx["view"], ("greedy_assign",))
