"""Device milliseconds a round in the program's ``fleet_local_sgd`` range
(``repro_torch.sim.fleet.fleet_local_sgd``: the vmapped tau-step SGD of
the scheduled clients), read from the range's span on the device's
timeline."""


def read(ctx):
    view = ctx["view"]
    us = view.device_us_inside("fleet_local_sgd")
    return None if not us else us / 1e3 / view.rounds
