"""The share of the traced call in which no operation ran on the device, %."""


def read(ctx):
    view = ctx["view"]
    if not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s())
