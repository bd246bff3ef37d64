"""Host milliseconds a round inside the program's ``kkt_solve`` ranges
(``repro_torch.sim.policy.finish_decision``)."""


def read(ctx):
    view = ctx["view"]
    spans = view.ranges("kkt_solve")
    return sum(b - a for a, b in spans) / 1e3 / view.rounds if spans else None
